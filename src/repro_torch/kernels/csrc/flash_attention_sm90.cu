// Hand-written Hopper (sm_90a) flash-attention forward for bf16 inputs, on
// the tensor cores: wgmma for both products, TMA for every load.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:77
// (flash_attention_single, body _flash_kernel :22, GQA wrapper
// flash_attention :93) for bf16 inputs; f32 inputs keep the CUDA-core
// kernel of csrc/flash_attention.cu.  Per (n, head h, 128-row query tile)
// it computes, over 128-key blocks (the plain version's FLASH_BLOCK: P's
// rounding depends on the running max at each block, so both partition the
// keys alike):
//
//   l = (q k^T) * scale               f32 accumulation of bf16 operands,
//                                     scaled after the product (1/sqrt(Dh))
//   l = softcap * tanh(l / softcap)   (when softcap > 0)
//   l = -1e30 where k_pos > q_pos (causal), k_pos <= q_pos - window (a
//       sliding window) or k_pos >= S (the ragged block)
//   m' = max(m, rowmax l),  p = exp(l - m'),  alpha = exp(m - m')
//   l_sum = l_sum * alpha + sum(p)    over the f32 p
//   acc = acc * alpha + bf16(p) v     P rounded to nearest even, f32 sums
//   out = bf16(acc / max(l_sum, 1e-30))
//
// kernels/ref.py:flash_attention_ref has the same rounding points for bf16
// inputs; the two are held to each other by a norm-relative bound
// (kernels/flash_attention.py: FLASH_BF16_RTOL, FLASH_BF16_ULP_SHARE): the
// tensor cores sum the logits in another order than the plain version, and
// one ulp of a logit can flip the rounding of a p.
//
// What bounds it on this card: a causal 32768-token prefill layer of
// qwen3-1.7b is 4 * 128 * 16 * 32768 * 32769 / 2 = 4.4e12 flops on 0.5 GB
// of inputs and output: 4.447 ms at the 989 TFLOP/s of the bf16 tensor
// cores, 0.15 ms at the 3.35 TB/s of HBM.  It is bound by operations, so
// the design keeps the tensor cores fed and everything else off their path:
//
//   * both products run on wgmma (m64n128k16 for Q K^T with both operands
//     in shared memory; m64nDhk16 for P V with P from registers): the
//     f32 accumulator fragment of Q K^T becomes the bf16 A fragment of
//     P V in place, thread by thread, so P never touches shared memory;
//   * one CTA per (128-row query tile, n * H + h) of 384 threads: two
//     consumer warpgroups of 64 query rows each and one producer
//     warpgroup, of which one thread issues the loads.  While one consumer
//     warpgroup runs its softmax, the other's wgmma can run;
//   * the producer issues TMA loads (128-byte swizzle, the layout the
//     wgmma descriptors read) into a ring of 3 K/V stages guarded by
//     mbarriers; Q is loaded once.  At Dh = 128: 32 KB of Q and
//     3 x 64 KB of K/V, 225 KB of shared memory with the alignment slack
//     (three stages ran faster than two on an H100);
//   * the tensor maps are 4-D, (Dh, heads, S, N), so a ragged last tile
//     reads zeros and never the next sequence's rows; GQA reads KV head
//     h / (H / KV) in place;
//   * causal grids start with the heaviest tiles, and only the diagonal
//     and the ragged block are masked;
//   * setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240), room for the Q K^T accumulator, the running
//     output, the block's P V and P itself without spilling (at the 168
//     that ptxas gives every thread of a 384-thread CTA, it spilled).
//
// A sliding window (a template instance of its own, so a call without one
// runs the code it ran before) keeps a key iff k_pos > q_pos - window,
// the JAX _chunked_attention(local=True) mask.  A query tile starts at the
// first key block that reaches its first row's window: the blocks before
// it lie wholly before every row's window, as the blocks after the
// diagonal lie after every row of a causal tile.  Its later rows may still
// meet a block wholly before their own window; it is masked, and that is
// the same bit for bit as skipping it (kernels/ref.py: a row's first kept
// key makes alpha exactly 0).  A gemma2-9b local layer (window 4096, S
// 32768, causal) then reads 33 of a causal tile's up to 256 blocks.
//
// At Dh = 256 (gemma-7b, gemma2-9b) neither budget above carries over: a
// 128-row Q tile is 64 KB and one K or V block 64 KB, so not even two K/V
// stages fit beside Q in 227 KB, and the output (128 registers a thread)
// beside the block's P V (128 more), the logits (64) and P (32) would
// exceed the consumers' 240.  So at Dh = 256:
//
//   * shared memory holds Q, one K slot and one V slot (192 KB), K and V
//     each with its own full and empty barriers: the producer loads K(j+1)
//     as soon as both consumers' Q K^T(j) is done, while they still run
//     the softmax and P V(j), and V(j+1) while they run Q K^T(j+1);
//   * the output is rescaled by alpha before P V(j) accumulates into it on
//     the tensor cores (two m64n128k16 per 16 keys, its two column
//     halves), so there is no separate P V: f32 roundings apart, the plain
//     version's acc * alpha + P V;
//   * four 64-column, 128-byte-swizzled TMA boxes cover a 256-wide row.
//
// At Dh = 80 (hubert-xlarge) a row is one 64-column box and a quarter of
// another, and the swizzled layouts the wgmma descriptors read come in
// whole 64-column boxes.  So a tile takes the Dh = 128 layout: two boxes a
// row, 32 KB of Q and 3 x 64 KB of K/V, 225 KB of shared memory.  The
// tensor maps' inner extent is Dh = 80, so TMA writes zeros into columns
// 80..127 of the second box (an out-of-bounds fill, CU_TENSOR_MAP_FLOAT_
// OOB_FILL_NONE, which is zero, never NaN) and still counts the whole box
// against the barrier.  Q K^T runs Dh / 16 = 5 k-steps (the fifth reads
// columns 64..79, the second box's first 16), so the padding costs it
// nothing; P V runs at n128 on V's two boxes (the MN-major layout has no
// n80 in whole swizzle atoms) and drops the output columns 80..127, which
// only the zero columns feed: 208 of every 160 needed products, so at most
// 77% of the operations bound.  A consumer thread holds the logits (64
// registers), P (32), the block's P V (64) and the output's 80 columns
// (40), against 128 + 64 at Dh 128; the store writes 80 columns.
//
// At Dh = 32 (the qwen3-moe, llama4 and yi-9b smoke models) a row is half
// a 64-column box, so a tile takes the Dh = 64 layout: one box a row, 16 KB
// of Q and 3 x 32 KB of K/V.  TMA fills columns 32..63 with zeros (the
// maps' inner extent is 32) and counts the whole box against the barrier.
// Q K^T runs 2 k-steps over the 32 real columns; P V runs at n64 on V's one
// box and drops the output columns 32..63, which only the zero columns
// feed, so P V does twice the products it needs: at most 67% of the
// operations bound.  A consumer thread holds the logits (64 registers), P
// (32), the block's P V (32) and the output's 32 columns (16); the store
// writes 32 columns.
//
// C interface for ctypes: the entry launches on the caller's stream and
// returns a cudaError_t (0 on success).  Nothing synchronises and nothing
// allocates; the Python wrapper allocates the output.  The tensor maps are
// encoded through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;                 // query rows per tile, keys per block
constexpr int kStages = 3;                  // K/V ring depth
constexpr int kConsumers = 2;               // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
// setmaxnreg: ptxas gives each of the 384 threads 168 registers; the
// producer warpgroup hands 144 of its own to the consumers (24 + 2 x 240
// = 3 x 168)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBoxCols = 64;                // bf16 columns of one 128-byte swizzled row
constexpr uint32_t kBoxBytes = kBlock * kBoxCols * 2;   // 16 KB: 128 rows of 128 B
constexpr float kNegInf = -1e30f;           // the Pallas kernel's NEG_INF

template <int Dh>
struct Layout {
  static constexpr uint32_t kTile = kBlock * Dh * 2;   // one 128 x Dh bf16 tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTile;                // K of stage s at kK + s * kTile
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBar = kV + kStages * kTile;
  // q_full, full[kStages], empty[kStages]; 1 KB of slack to align the base
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};
static_assert(Layout<128>::kBytes <= 232448, "a CTA has 227 KB of shared memory");

// Dh = 256: Q, one K slot and one V slot of 128 x 256 bf16 each
struct WideLayout {
  static constexpr uint32_t kTile = kBlock * 256 * 2;  // 64 KB
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTile;
  static constexpr uint32_t kV = 2 * kTile;
  static constexpr uint32_t kBar = 3 * kTile;
  // q_full, k_full, k_empty, v_full, v_empty; 1 KB of slack to align the base
  static constexpr uint32_t kBytes = kBar + 8 * 5 + 1024;
};
static_assert(WideLayout::kBytes <= 232448, "a CTA has 227 KB of shared memory");

// The columns of a staged tile's rows in shared memory: Dh rounded up to
// whole 64-column boxes (Dh 80 takes the Dh 128 layout, Dh 32 the Dh 64 one)
__host__ __device__ constexpr int padded_cols(int dh) {
  return (dh + kBoxCols - 1) / kBoxCols * kBoxCols;
}

template <int Dh>
constexpr uint32_t smem_bytes() {
  if constexpr (Dh == 256) return WideLayout::kBytes;
  else return Layout<padded_cols(Dh)>::kBytes;
}

// ---- shared memory, mbarriers and TMA ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_LOOP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_LOOP;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of the 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at dst; completion counts bytes on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand whose
// 1 KB swizzle atoms (8 rows of 128 B) start 1 KB aligned.  lbo and sbo in
// bytes.  K-major (Q, K): sbo steps 8 rows, lbo is unused (1).  MN-major
// (V): sbo steps 8 keys, lbo the next 64 columns of Dh.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// The registers a wgmma writes are written when its group completes, not
// at the instruction: this tells the compiler they change here, so no read
// moves above the wait and no write below the launch.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC8(i)                                                               \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),     \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define REGS32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define REGS64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) B (16 x 128, smem,
// K-major): the logits of 64 query rows against 128 keys, 16 of Dh.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16 registers) B (16 x 128, smem,
// MN-major): 16 keys of P V at Dh = 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// The same at Dh = 64 (m64n64k16).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

#undef ACC8
#undef ACC32
#undef ACC64
#undef REGS32
#undef REGS64

// Two f32 rounded to nearest even into one bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(x) as ex2.approx(x log2(e)): one multiply and one MUFU.EX2 where
// expf takes about eight instructions.  The softmax's instructions, not
// the tensor cores, set the pace of this kernel: chip_smoke.py timed the
// prefill layer at 10.580 ms with expf and a branch per element, and at
// 8.165 ms with this and the branches hoisted out of the loops (H100 80GB
// HBM3, 700 W).  Its relative error, about 2^-22, moves few roundings of P
// to bf16 (contract (a)'s share of elements more than one ulp off, 1.94e-3
// with expf, 1.97e-3 with this, at the prefill layer).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the kernel -------------------------------------------------------------
//
// Accumulator fragments (wgmma m64nN, f32): thread t of a warpgroup, warp
// w = t / 32, lane l, holds d[i] at row 16 w + l / 4 + 8 ((i >> 1) & 1) and
// column 8 (i >> 2) + 2 (l % 4) + (i & 1).  So a thread owns two rows, and
// each row is spread over the quad of lanes that share l / 4.  The A
// fragment of a 16-column slice j of P (m64k16, bf16) is, per thread,
// {d[8j], d[8j+1]}, {d[8j+2], d[8j+3]}, {d[8j+4], d[8j+5]},
// {d[8j+6], d[8j+7]} of the logits' fragment: the same rows and columns.

// The first key block of a query tile whose first row is q0, under a
// window: every block before it lies wholly before that row's window
// (its last key <= q0 - window), so wholly before every row's of the tile.
__device__ __forceinline__ int first_block(int q0, int window) {
  return q0 - window + 1 > 0 ? (q0 - window + 1) / kBlock : 0;
}

// One key block's softmax on a consumer thread's logits fragment s (rows
// row0 and row0 + 8, columns k0 + col0 + ...): scale after the product,
// softcap, the masks by index where `masked`, the running max m; returns
// each row's alpha, writes the bf16 P fragment into p and updates l_sum.
// Each step is a loop of its own, so none branches per element.
template <bool kWindow>
__device__ __forceinline__ void softmax_block(float (&s)[64], uint32_t (&p)[32],
                                              float (&m)[2], float (&l_sum)[2],
                                              float (&alpha)[2], bool masked,
                                              int k0, int row0, int col0, int S,
                                              int causal, int window,
                                              float softcap, float scale) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = __fmul_rn(s[i], scale);
  if (softcap > 0.0f) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      s[i] = __fmul_rn(softcap, tanhf(__fdiv_rn(s[i], softcap)));
  }
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
      const int qpos = row0 + 8 * ((i >> 1) & 1);
      if (kpos >= S || (causal && kpos > qpos) ||
          (kWindow && kpos <= qpos - window))
        s[i] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }

  // p = exp(l - m') in f32 for the row sums; bf16 P for the product
  float psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = (i >> 1) & 1;
    const float e0 = exp_approx(s[i] - m[r]);
    const float e1 = exp_approx(s[i + 1] - m[r]);
    psum[r] += e0;
    psum[r] += e1;
    p[i / 2] = pack_bf16(e0, e1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l_sum[r] = __fadd_rn(__fmul_rn(l_sum[r], alpha[r]), psum[r]);
}

// The Dh = 256 tile: Q, one K slot and one V slot, the output rescaled
// before P V accumulates into it (the note at the top).
template <bool kWindow>
__device__ __forceinline__ void wide_tile(const CUtensorMap& tq,
                                          const CUtensorMap& tk,
                                          const CUtensorMap& tv,
                                          __nv_bfloat16* __restrict__ out, int S,
                                          int H, int KV, int causal, int window,
                                          float softcap, float scale) {
  using L = WideLayout;
  constexpr int kHalves = 256 / kBoxCols;   // 64-column boxes per tile row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8, k_empty = q_full + 16;
  const uint32_t v_full = q_full + 24, v_empty = q_full + 32;

  const int n_tiles = (S + kBlock - 1) / kBlock;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int n = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = tile * kBlock;
  const int n_k = causal ? tile + 1 : n_tiles;
  const int kb_lo = kWindow ? first_block(q0, window) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, 128 * kConsumers);
    mbar_init(v_empty, 128 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread loads K(j + 1) once both consumers have read
    // K(j), and V(j + 1) once they have read V(j)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < kHalves; ++c)
        tma_load_4d(sq + c * kBoxBytes, &tq, q_full, c * kBoxCols, h, q0, n);
      for (int j = 0; kb_lo + j < n_k; ++j) {
        const int k0 = (kb_lo + j) * kBlock;
        const uint32_t parity = (j & 1) ^ 1;
        mbar_wait(k_empty, parity);
        mbar_expect_tx(k_full, L::kTile);
        for (int c = 0; c < kHalves; ++c)
          tma_load_4d(sk + c * kBoxBytes, &tk, k_full, c * kBoxCols, g, k0, n);
        mbar_wait(v_empty, parity);
        mbar_expect_tx(v_full, L::kTile);
        for (int c = 0; c < kHalves; ++c)
          tma_load_4d(sv + c * kBoxBytes, &tv, v_full, c * kBoxCols, g, k0, n);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. q0 + 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_rows = sq + 64 * wg * 128;    // 64 rows of 128 B per box

  // the output's columns 0..127 and 128..255, as two m64n128 fragments
  float o_lo[64], o_hi[64], s_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o_lo[i] = o_hi[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l_sum[2] = {0.0f, 0.0f};     // this thread's share of each row's sum

  mbar_wait(q_full, 0);
  for (int j = 0; kb_lo + j < n_k; ++j) {
    const int kb = kb_lo + j;
    const uint32_t parity = j & 1;
    mbar_wait(k_full, parity);

    // logits: 16 k-steps; step kk reads 32 B at column 16 (kk % 4) of box kk / 4
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n128(s_acc, sw128_desc(q_rows + off, 16, 1024),
                    sw128_desc(sk + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);
    mbar_arrive(k_empty);

    const int k0 = kb * kBlock;
    const bool masked = k0 + kBlock > S || (causal && kb == n_k - 1) ||
                        (kWindow && k0 < q0 + kBlock - window);
    uint32_t p[32];
    float alpha[2];
    softmax_block<kWindow>(s_acc, p, m, l_sum, alpha, masked, k0, row0, col0,
                           S, causal, window, softcap, scale);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      o_lo[i] = __fmul_rn(o_lo[i], alpha[(i >> 1) & 1]);
      o_hi[i] = __fmul_rn(o_hi[i], alpha[(i >> 1) & 1]);
    }

    // P V onto the rescaled output: 8 k-steps of 16 keys, each two
    // m64n128k16 (V's columns 0..127 in boxes 0-1, 128..255 in boxes 2-3)
    mbar_wait(v_full, parity);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < kBlock / 16; ++jj) {
      wgmma_rs(o_lo, p[4 * jj], p[4 * jj + 1], p[4 * jj + 2], p[4 * jj + 3],
               sw128_desc(sv + jj * 16 * 128, kBoxBytes, 1024), 1);
      wgmma_rs(o_hi, p[4 * jj], p[4 * jj + 1], p[4 * jj + 2], p[4 * jj + 3],
               sw128_desc(sv + 2 * kBoxBytes + jj * 16 * 128, kBoxBytes, 1024),
               1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_lo);
    fence_regs(o_hi);
    mbar_arrive(v_empty);
  }

  const int64_t row_pitch = static_cast<int64_t>(H) * 256;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l_sum[r]), 1e-30f);
    const int qpos = row0 + 8 * r;
    if (qpos < S) {
      __nv_bfloat16* dst = out + (static_cast<int64_t>(n) * S + qpos) * row_pitch +
                           static_cast<int64_t>(h) * 256 + col0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(__fdiv_rn(o_lo[4 * j + 2 * r], denom),
                      __fdiv_rn(o_lo[4 * j + 2 * r + 1], denom));
        *reinterpret_cast<uint32_t*>(dst + 128 + 8 * j) =
            pack_bf16(__fdiv_rn(o_hi[4 * j + 2 * r], denom),
                      __fdiv_rn(o_hi[4 * j + 2 * r + 1], denom));
      }
    }
  }
}

// The Dh = 32, 64, 80 and 128 tile: Q and a ring of kStages K/V stages, each
// block's P V summed on its own and added to the rescaled output.  Its
// rows are kCols wide in shared memory, Dh rounded up to whole boxes; TMA
// fills the columns past Dh with zeros.
template <int Dh, bool kWindow>
__device__ __forceinline__ void staged_tile(const CUtensorMap& tq,
                                            const CUtensorMap& tk,
                                            const CUtensorMap& tv,
                                            __nv_bfloat16* __restrict__ out,
                                            int S, int H, int KV, int causal,
                                            int window, float softcap,
                                            float scale) {
  constexpr int kCols = padded_cols(Dh);
  using L = Layout<kCols>;
  constexpr int kHalves = kCols / kBoxCols;   // 64-column boxes per tile row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto sk = [&](int s) { return base + L::kK + s * L::kTile; };
  auto sv = [&](int s) { return base + L::kV + s * L::kTile; };

  const int n_tiles = (S + kBlock - 1) / kBlock;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int n = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = tile * kBlock;
  const int n_k = causal ? tile + 1 : n_tiles;
  const int kb_lo = kWindow ? first_block(q0, window) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < kHalves; ++c)
        tma_load_4d(sq + c * kBoxBytes, &tq, q_full, c * kBoxCols, h, q0, n);
      for (int it = 0; kb_lo + it < n_k; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTile);
        for (int c = 0; c < kHalves; ++c) {
          tma_load_4d(sk(s) + c * kBoxBytes, &tk, full(s), c * kBoxCols, g,
                      (kb_lo + it) * kBlock, n);
          tma_load_4d(sv(s) + c * kBoxBytes, &tv, full(s), c * kBoxCols, g,
                      (kb_lo + it) * kBlock, n);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. q0 + 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_rows = sq + 64 * wg * 128;    // 64 rows of 128 B per box

  // the output's Dh columns; the block's P V over all kCols (n = kCols)
  float o[Dh / 2], pv[kCols / 2], s_acc[64];
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l_sum[2] = {0.0f, 0.0f};     // this thread's share of each row's sum

  mbar_wait(q_full, 0);
  for (int it = 0; kb_lo + it < n_k; ++it) {
    const int kb = kb_lo + it;
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);

    // logits: Dh / 16 k-steps; step kk reads 32 B at column 16 (kk % 4) of box kk / 4
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n128(s_acc, sw128_desc(q_rows + off, 16, 1024),
                    sw128_desc(sk(s) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);

    const int k0 = kb * kBlock;
    const bool masked = k0 + kBlock > S || (causal && kb == n_k - 1) ||
                        (kWindow && k0 < q0 + kBlock - window);
    uint32_t p[32];
    float alpha[2];
    softmax_block<kWindow>(s_acc, p, m, l_sum, alpha, masked, k0, row0, col0,
                           S, causal, window, softcap, scale);

    // this block's P V on its own: 8 k-steps of 16 keys, 2 KB of V each
    // (at Dh 80 its columns 80..127, at Dh 32 its columns 32..63, read V's
    // zero fill and are dropped)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlock / 16; ++j)
      wgmma_rs(pv, p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3],
               sw128_desc(sv(s) + j * 16 * 128, kBoxBytes, 1024), j > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    mbar_arrive(empty(s));

    // acc * alpha + P V, rounding each step: the plain version's association
#pragma unroll
    for (int i = 0; i < Dh / 2; ++i)
      o[i] = __fadd_rn(__fmul_rn(o[i], alpha[(i >> 1) & 1]), pv[i]);
  }

  const int64_t row_pitch = static_cast<int64_t>(H) * Dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l_sum[r]), 1e-30f);
    const int qpos = row0 + 8 * r;
    if (qpos < S) {
      __nv_bfloat16* dst = out + (static_cast<int64_t>(n) * S + qpos) * row_pitch +
                           static_cast<int64_t>(h) * Dh + col0;
#pragma unroll
      for (int j = 0; j < Dh / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(__fdiv_rn(o[4 * j + 2 * r], denom),
                      __fdiv_rn(o[4 * j + 2 * r + 1], denom));
    }
  }
}

template <int Dh, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int S, int H, int KV,
                int causal, int window, float softcap, float scale) {
  static_assert(Dh == 32 || Dh == 64 || Dh == 80 || Dh == 128 || Dh == 256,
                "head dim");
  if constexpr (Dh == 256)
    wide_tile<kWindow>(tq, tk, tv, out, S, H, KV, causal, window, softcap,
                       scale);
  else
    staged_tile<Dh, kWindow>(tq, tk, tv, out, S, H, KV, causal, window,
                             softcap, scale);
}

// ---- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (Dh, heads, S, N) map of a contiguous (N, S, heads, Dh) bf16 tensor,
// read in boxes of 64 columns x 1 head x 128 rows, 128-byte swizzled;
// rows past S, and columns past Dh (Dh 32 and 80), read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int64_t n, int64_t s,
              int64_t heads, int64_t dh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(dh * 2),
                                 static_cast<cuuint64_t>(heads * dh * 2),
                                 static_cast<cuuint64_t>(s * heads * dh * 2)};
  const cuuint32_t box[4] = {kBoxCols, 1, kBlock, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Dh, bool kWindow>
int launch(const void* q, const void* k, const void* v, void* out, int64_t n,
           int64_t s, int64_t h, int64_t kv, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, n, s, h, Dh) || !make_map(&tk, k, n, s, kv, Dh) ||
      !make_map(&tv, v, n, s, kv, Dh))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_tc_kernel<Dh, kWindow>;
  constexpr uint32_t bytes = smem_bytes<Dh>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s + kBlock - 1) / kBlock),
                  static_cast<unsigned>(n * h));
  kernel<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<int>(s),
      static_cast<int>(h), static_cast<int>(kv), causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int Dh>
int launch_dh(const void* q, const void* k, const void* v, void* out, int64_t n,
              int64_t s, int64_t h, int64_t kv, int causal, int window,
              float softcap, float scale, cudaStream_t stream) {
  if (window > 0)
    return launch<Dh, true>(q, k, v, out, n, s, h, kv, causal, window, softcap,
                            scale, stream);
  return launch<Dh, false>(q, k, v, out, n, s, h, kv, causal, 0, softcap, scale,
                           stream);
}

}  // namespace

extern "C" {

int flash_attention_bf16_tc(const void* q, const void* k, const void* v,
                            void* out, int64_t n, int64_t s, int64_t h,
                            int64_t kv, int64_t dh, int causal, int window,
                            float softcap, float scale, cudaStream_t stream) {
  if (n < 1 || s < 1 || kv < 1 || h % kv != 0 || n * h > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 32)
    return launch_dh<32>(q, k, v, out, n, s, h, kv, causal, window, softcap,
                         scale, stream);
  if (dh == 64)
    return launch_dh<64>(q, k, v, out, n, s, h, kv, causal, window, softcap,
                         scale, stream);
  if (dh == 80)
    return launch_dh<80>(q, k, v, out, n, s, h, kv, causal, window, softcap,
                         scale, stream);
  if (dh == 128)
    return launch_dh<128>(q, k, v, out, n, s, h, kv, causal, window, softcap,
                          scale, stream);
  if (dh == 256)
    return launch_dh<256>(q, k, v, out, n, s, h, kv, causal, window, softcap,
                          scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
