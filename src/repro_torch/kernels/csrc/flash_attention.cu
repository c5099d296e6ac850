// Hand-written Hopper (sm_90a) flash-attention forward for f32 inputs, on
// the tensor cores in 3xTF32: wgmma for both products.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:77
// (flash_attention_single, body _flash_kernel :22, GQA wrapper
// flash_attention :93) for f32 inputs; bf16 inputs take
// csrc/flash_attention_sm90.cu.  Per (n, head h, 64-row query tile) it
// computes, over 64-key blocks, in f32 as the Pallas kernel does:
//
//   q' = q * scale (scale = 1/sqrt(Dh)),  l = q' k^T,
//   l = softcap * tanh(l / softcap)          (when softcap > 0)
//   l = -1e30 where k_pos > q_pos (causal), k_pos <= q_pos - window (a
//       sliding window) or k_pos >= S (the ragged block)
//   m' = max(m, rowmax l),  p = exp(l - m'),  alpha = exp(m - m')
//   l_sum = l_sum * alpha + sum(p),  acc = acc * alpha + p v
//   out = acc / max(l_sum, 1e-30)
//
// Layout: q and out are (N, S, H, Dh), k and v (N, S, KV, Dh), contiguous,
// read in place: head h reads KV head h / (H / KV).  Any S; Dh 32, 64, 80,
// 128 or 256 (Dh 256 has a plan of its own: 32-key blocks, two consumer
// warpgroups, "Dh = 256" below).
// A sliding window is a template instance of its own (a call without one
// runs the code it ran before): a query tile starts at the first key block
// that reaches its first row's window, as a causal tile stops at its
// diagonal, and masks the blocks that reach into some of its rows' windows
// only (masking a block wholly before a row's window equals skipping it, bit
// for bit: kernels/ref.py).
//
// 3xTF32.  The tensor cores take f32 operands only as TF32 (10 mantissa
// bits).  Each operand a is split as a = big + small, big = tf32(a) and
// small = tf32(a - big) (cvt.rna), and each product is
// big.big + big.small + small.big in f32 accumulators; the dropped
// small.small term is below 2^-22 of the product.  A CPU emulation
// (tests/test_torch_flash_tf32.py) puts it within 1e-5 of max|out| of the
// f32 plain version, where 1xTF32 and 2xTF32 are not.
//
// What bounds it on this card: a causal 32768-token prefill layer of
// qwen3-1.7b does 4 * 128 * 16 * 32768 * 32769 / 2 = 4.4e12 flops on 0.5 GB
// of inputs and output; at three TF32 products each, 26.66 ms at the 495
// TFLOP/s of the TF32 tensor cores, against 0.15 ms at the 3.35 TB/s of
// HBM (H100 SXM data-sheet rates, at its 700 W limit; chip_smoke.py timed
// this kernel at 64.8 ms there on an NVIDIA H100 80GB HBM3, 700.00 W).  It is bound by operations, so the design keeps the tensor cores
// fed:
//
//   * both products run on wgmma m64nNk8 .tf32: Q K^T with Q's and K's
//     big and small parts all in shared memory; P V with P's big and
//     small parts from registers (the Q K^T accumulator, in place) against
//     V^T's big and small parts in shared memory;
//   * the tensor cores round each step's sum toward zero, so the rounding
//     error grows with the length of an accumulation chain at the
//     accumulator's magnitude: tests/test_torch_flash_tf32.py emulates one
//     rounding per k8 step, and at S 1000 non-causal, Dh 128, one chain
//     per product reads 1.4e-5 of max|out|, over the contract.  Two
//     choices keep it to 2.1e-6 there: each
//     product adds its two correction terms first (a chain at 2^-11 of the
//     product's magnitude) and its big.big term last (Dh / 8 or 8 steps);
//     and each key block's P V is summed on its own, from zero, and then
//     added to the rescaled output with round-to-nearest,
//     acc * alpha + P V, the Pallas kernel's association, so no chain runs
//     across key blocks;
//   * for 32-bit types wgmma reads shared-memory operands K-major only
//     (the PTX ISA allows the transposed layouts for 16-bit types), so V
//     (keys x Dh, Dh contiguous) is transposed into shared memory as V^T,
//     fused with its split.  P comes from the Q K^T accumulator in place:
//     a thread holds keys 2c and 2c + 1 of each 8-key step where the TF32
//     A fragment wants keys c and c + 4 (c = lane % 4), so V^T's keys are
//     stored permuted within each group of 8 (position 4 (k & 1) + k / 2
//     holds key k), which makes the two agree with no data movement;
//   * one CTA of 256 threads per (64-row query tile, n * H + h): one
//     consumer warpgroup (the products and the softmax) and one producer
//     warpgroup, which loads K and V blocks from device memory (16-byte
//     loads, the next block in flight while the current one is stored),
//     splits them and writes them 128-byte swizzled, as the wgmma
//     descriptors read them, into a ring of slots guarded by mbarriers.  A
//     slot holds one K block or one V^T block, big and small parts, and the
//     blocks alternate K, V, K, ...  TMA is not used: the split and the
//     transpose need the data in registers anyway;
//   * shared memory at Dh = 128: Q's big and small parts 64 KB and 2 slots
//     of 64 KB (64 keys x 128 x 4 B, twice), 193 KB with the alignment
//     slack and the barriers, of the 227 KB a CTA may have; at Dh = 64,
//     32 KB and 6 slots of 32 KB.  Registers per consumer thread at
//     Dh = 128: the output 64, the block's P V 64, the logits (then P's big
//     part in place) 32, P's small part 32, within the 255 that 256
//     threads leave a thread (Q's big part as register A fragments, 64
//     more, did not fit beside the block's P V);
//   * the softmax runs in f32 on the CUDA cores: exp as ex2.approx
//     (relative error about 2^-22), tanh as tanhf (tanh.approx's 2^-11
//     would break the contract in the softcap cases);
//   * causal grids start with the heaviest tiles, the K loop of a causal
//     tile stops at the diagonal block, and only the diagonal and the
//     ragged block are masked.
//
// At Dh = 80 (hubert-xlarge) a row of Q or K is two and a half 32-column
// swizzled boxes: their parts take three boxes (64 rows x 96 columns, 24 KB
// a part), and the k-steps read columns 0..79 only, so the third box's
// unwritten tail (columns 80..95) is never read and needs no fill.  V^T
// has 80 rows of 64 keys, two whole boxes, and P V runs m64n80k8.  The
// producer's V units (4 keys x 4 columns) number 40 groups of 8 threads, 2.5
// a thread's round of 16: three rounds, the last one's second half idle.
// Shared memory: Q's parts 48 KB, 3 slots of 48 KB, 193 KB with the slack
// and the barriers; a consumer thread holds the output 40, the block's P V
// 40, the logits 32 and P's small part 32 registers.
//
// At Dh = 32 (the qwen3-moe, llama4 and yi-9b smoke models) a row of Q or K
// is one 32-column box, V^T 32 rows of 64 keys (two boxes), and P V runs
// m64n32k8: no column is padded.  The producer's V units number 16 groups,
// one round.  Q's parts take 16 KB and a slot 16 KB, so 13 slots fit, 6.5
// key blocks in flight, 225 KB with the slack and the barriers; a consumer
// thread holds the output 16, the block's P V 16, the logits 32 and P's
// small part 32 registers (ptxas: 122-128 registers a thread, no spill).
//
// mma.sync is not used: wgmma holds every operand layout this needs.
//
// C interface for ctypes: the entry launches on the caller's stream and
// returns a cudaError_t (0 on success).  Nothing synchronises and nothing
// allocates; the Python wrapper allocates the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                   // query rows per CTA (one warpgroup)
constexpr int kKeys = 64;                   // keys per block
constexpr int kThreads = 256;               // consumer + producer warpgroup
constexpr uint32_t kRowBytes = 128;         // one swizzled row: 32 f32
constexpr float kNegInf = -1e30f;           // the Pallas kernel's NEG_INF
constexpr uint32_t kSmemMax = 232448;       // 227 KB, a CTA's most

template <int Dh>
struct Layout {
  // a row of Q or K in whole 32-column boxes (96 at Dh 80); V^T's Dh rows
  // of 64 keys fit in a part of that size
  static constexpr int kCols = (Dh + 31) / 32 * 32;
  static constexpr uint32_t kPart = kKeys * kCols * 4;  // one big or small part
  static constexpr uint32_t kSlot = 2 * kPart;          // big, then small
  static constexpr uint32_t kQ = 0;                     // Q's big, then small part
  static constexpr uint32_t kQPart = kRows * kCols * 4;
  static constexpr uint32_t kSlot0 = 2 * kQPart;
  static constexpr int kSlots = (kSmemMax - 1024 - 256 - kSlot0) / kSlot;
  static constexpr uint32_t kBar = kSlot0 + kSlots * kSlot;
  // full[kSlots], empty[kSlots]; 1 KB of slack to align the base
  static constexpr uint32_t kBytes = kBar + 16 * kSlots + 1024;
};
static_assert(Layout<128>::kSlots == 2 && Layout<80>::kSlots == 3 &&
                  Layout<64>::kSlots == 6 && Layout<32>::kSlots == 13,
              "slots");
static_assert(Layout<128>::kBytes <= kSmemMax && Layout<80>::kBytes <= kSmemMax &&
                  Layout<64>::kBytes <= kSmemMax && Layout<32>::kBytes <= kSmemMax,
              "a CTA has 227 KB of shared memory");

// ---- shared memory and mbarriers ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
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

// Shared-memory writes of this thread become visible to the async proxy
// (the wgmma operand reads) once a barrier orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(a) : "memory");
}

// Byte address of 32-bit element (row, col) of a K-major operand stored
// as boxes of 32 columns, `rows` rows of 128 B each, 128-byte swizzled
// (16-byte chunk j of row r at chunk j ^ (r % 8)): the layout the wgmma
// descriptors below read.
__device__ __forceinline__ uint32_t swizzled(uint32_t base, int rows, int row,
                                             int col) {
  const int chunk = (col & 31) >> 2;
  return base + static_cast<uint32_t>(col >> 5) * rows * kRowBytes +
         row * kRowBytes + ((chunk ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// ---- TF32 split -------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = tf32(x);
  return {big, tf32(x - __uint_as_float(big))};   // x - big is exact
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled K-major operand
// whose 1 KB swizzle atoms (8 rows of 128 B) start 1 KB aligned: sbo
// steps 8 rows, lbo is unused.  The descriptor of base + off is
// desc(base) + off / 16, as long as the address stays below 256 KB.  The
// base's descriptor passes through an opaque move once per key block, so
// the compiler keeps one register pair per operand, not one per k-step.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
               static_cast<uint64_t>(1) << 16 |
               static_cast<uint64_t>(1024 >> 4) << 32 |
               static_cast<uint64_t>(1) << 62;
  asm volatile("mov.b64 %0, %0;" : "+l"(d));
  return d;
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
#define ACC16 ACC8(0), ACC8(8)
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC40 ACC32, ACC8(32)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define REGS16                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REGS32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define REGS40                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
#define REGS64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64, f32) += A (64 x 8, smem) B (8 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : ACC32
      : "l"(a), "l"(b));
}

// d (64 x 32, f32) += A (64 x 8, TF32 registers) B (8 x 32, smem, K-major):
// P V at Dh = 32.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The same at N = 64 (P V at Dh = 64).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The same at N = 80 (P V at Dh = 80).
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 " REGS40
      ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : ACC40
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The same at N = 128 (P V at Dh = 128).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 16, f32) += A (64 x 8, smem) B (8 x 16, smem), both K-major:
// one consumer warpgroup's half of a 32-key block's Q K^T at Dh = 256.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : ACC8(0)
      : "l"(a), "l"(b));
}

// d (64 x 128, f32) += A (64 x 8, smem) B (8 x 128, smem), both K-major:
// one consumer warpgroup's 128 output columns of P V at Dh = 256.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " REGS64
      ", %64, %65, p, 1, 1;\n}\n"
      : ACC64
      : "l"(a), "l"(b));
}

#undef ACC8
#undef ACC16
#undef ACC32
#undef ACC40
#undef ACC64
#undef REGS16
#undef REGS32
#undef REGS40
#undef REGS64

// exp(x) as ex2.approx(x log2(e)): one multiply and one MUFU.EX2.
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

// The first key block of a query tile whose first row is q0, under a
// window: every block before it lies wholly before that row's window
// (its last key <= q0 - window), so wholly before every row's of the tile.
__device__ __forceinline__ int first_block(int q0, int window, int keys = kKeys) {
  return q0 - window + 1 > 0 ? (q0 - window + 1) / keys : 0;
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ---- the producer -------------------------------------------------------------
//
// K block kb: 64 keys x Dh, stored as the B operand of Q K^T (rows = keys,
// K-major along Dh).  Thread t loads float4 u of the block's 64 x Dh / 4,
// key u / (Dh / 4), columns 4 (u % (Dh / 4)) .. + 3.
//
// V block kb: stored as V^T, the B operand of P V (rows = Dh, K-major along
// the keys, keys permuted within each group of 8).  Thread t loads 4 x 4
// blocks: keys 8 g + p + {0, 2, 4, 6} x columns 4 cq .. + 3, which are
// positions 8 g + 4 p + {0..3} of V^T rows 4 cq .. + 3, one 16-byte store
// each.  (g, p, cq) come from t so that the 8 threads of a store phase
// write 8 distinct 16-byte bank groups.  The block's 4 (Dh / 8) groups of
// 8 such units take kVRounds rounds of the warpgroup's 16 groups; at
// Dh 80 the third round's groups 40..47 have no unit.

template <int Dh, int Keys = kKeys, uint32_t Part = Layout<Dh>::kPart>
struct Producer {
  static constexpr int kLoads = Keys * Dh / 4 / 128;    // K float4 per thread
  static constexpr int kVGroups = (Keys / 16) * (Dh / 8);  // V: groups of 8 units
  static constexpr int kVRounds = (kVGroups + 15) / 16;
  const float* k;
  const float* v;
  int64_t kv_base, kv_row;
  int S, t;

  __device__ __forceinline__ float4 load(const float* src, int key, int col) const {
    if (key >= S) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return __ldg(reinterpret_cast<const float4*>(src + kv_base + key * kv_row + col));
  }

  // this thread's unit of round blk; false where the round has none
  __device__ __forceinline__ bool v_unit(int blk, int& g, int& p, int& cq) const {
    const int w = (t >> 3) + 16 * blk;
    p = (t >> 1) & 1;
    cq = 2 * (w % (Dh / 8)) + (t & 1);
    g = ((t >> 2) & 1) + 2 * (w / (Dh / 8));
    return w < kVGroups;
  }

  __device__ __forceinline__ void load_k(int k0, float4 (&r)[kLoads]) const {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = t + 128 * u;
      r[u] = load(k, k0 + i / (Dh / 4), 4 * (i % (Dh / 4)));
    }
  }

  __device__ __forceinline__ void store_k(uint32_t slot, const float4 (&r)[kLoads]) const {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = t + 128 * u;
      const uint32_t at = swizzled(slot, Keys, i / (Dh / 4), 4 * (i % (Dh / 4)));
      const Split a = split(r[u].x), b = split(r[u].y), c = split(r[u].z),
                  d = split(r[u].w);
      st_shared_v4(at, a.big, b.big, c.big, d.big);
      st_shared_v4(at + Part, a.small, b.small, c.small, d.small);
    }
  }

  __device__ __forceinline__ void load_v(int k0, float4 (&r)[4 * kVRounds]) const {
#pragma unroll
    for (int blk = 0; blk < kVRounds; ++blk) {
      int g, p, cq;
      if (!v_unit(blk, g, p, cq)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[4 * blk + i] = load(v, k0 + 8 * g + p + 2 * i, 4 * cq);
    }
  }

  __device__ __forceinline__ void store_v(uint32_t slot,
                                         const float4 (&r)[4 * kVRounds]) const {
#pragma unroll
    for (int blk = 0; blk < kVRounds; ++blk) {
      int g, p, cq;
      if (!v_unit(blk, g, p, cq)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t at = swizzled(slot, Dh, 4 * cq + j, 8 * g + 4 * p);
        const Split a = split(lane_of(r[4 * blk], j)),
                    b = split(lane_of(r[4 * blk + 1], j)),
                    c = split(lane_of(r[4 * blk + 2], j)),
                    d = split(lane_of(r[4 * blk + 3], j));
        st_shared_v4(at, a.big, b.big, c.big, d.big);
        st_shared_v4(at + Part, a.small, b.small, c.small, d.small);
      }
    }
  }
};

// ---- the kernel -------------------------------------------------------------
//
// Accumulator fragments (wgmma m64nN, f32): thread t of the warpgroup,
// warp w = t / 32, lane l, holds d[i] at row 16 w + l / 4 + 8 ((i >> 1) & 1)
// and column 8 (i >> 2) + 2 (l % 4) + (i & 1).  The TF32 A fragment of an
// 8-column step j (m64k8) holds, per thread, (row, c), (row + 8, c),
// (row, c + 4), (row + 8, c + 4) of the step, c = l % 4: Q's is loaded
// so; P's is {d[4j], d[4j + 2], d[4j + 1], d[4j + 3]}, columns 2c and
// 2c + 1 standing at c and c + 4, as V^T's permuted keys expect.

template <int Dh, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int S,
                       int H, int KV, int causal, int window, float softcap,
                       float scale) {
  static_assert(Dh == 32 || Dh == 64 || Dh == 80 || Dh == 128, "head dim");
  using L = Layout<Dh>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qbig = base + L::kQ, qsmall = qbig + L::kQPart;
  auto slot = [&](int item) { return base + L::kSlot0 + (item % L::kSlots) * L::kSlot; };
  auto full = [&](int item) { return base + L::kBar + 8u * (item % L::kSlots); };
  auto empty = [&](int item) {
    return base + L::kBar + 8u * (L::kSlots + item % L::kSlots);
  };
  auto phase = [&](int item) { return static_cast<uint32_t>(item / L::kSlots) & 1u; };

  const int n_tiles = (S + kRows - 1) / kRows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int n = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = tile * kRows;
  const int n_k = causal ? (q0 + kRows - 1) / kKeys + 1 : (S + kKeys - 1) / kKeys;
  const int kb_lo = kWindow ? first_block(q0, window) : 0;
  const int64_t q_row = static_cast<int64_t>(H) * Dh;
  const int64_t kv_row = static_cast<int64_t>(KV) * Dh;
  const int64_t q_base = static_cast<int64_t>(n) * S * q_row + static_cast<int64_t>(h) * Dh;
  const int64_t kv_base = static_cast<int64_t>(n) * S * kv_row + static_cast<int64_t>(g) * Dh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kSlots; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: K(kb_lo + it) is item 2 it, V(kb_lo + it) item 2 it + 1;
    // the next block's loads are in flight while this one is split and
    // stored
    const Producer<Dh> pr{k, v, kv_base, kv_row, S, static_cast<int>(threadIdx.x) - 128};
    float4 kr[Producer<Dh>::kLoads], vr[4 * Producer<Dh>::kVRounds];
    pr.load_k(kb_lo * kKeys, kr);
    for (int it = 0; kb_lo + it < n_k; ++it) {
      const int kb = kb_lo + it;
      pr.load_v(kb * kKeys, vr);
      mbar_wait(empty(2 * it), phase(2 * it) ^ 1u);
      pr.store_k(slot(2 * it), kr);
      fence_proxy_async();
      mbar_arrive(full(2 * it));
      if (kb + 1 < n_k) pr.load_k((kb + 1) * kKeys, kr);
      mbar_wait(empty(2 * it + 1), phase(2 * it + 1) ^ 1u);
      pr.store_v(slot(2 * it + 1), vr);
      fence_proxy_async();
      mbar_arrive(full(2 * it + 1));
    }
    return;
  }

  // consumer: the 64 query rows q0 .. q0 + 63
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;          // and r0 + 8
  const int c = lane % 4;

  // Q scaled and split into shared memory, the A operand of Q K^T
  for (int i = t; i < kRows * Dh; i += 128) {
    const int row = i / Dh, col = i % Dh;
    const float x = q0 + row < S
                        ? __fmul_rn(q[q_base + (q0 + row) * q_row + col], scale)
                        : 0.0f;
    const Split sp = split(x);
    st_shared(swizzled(qbig, kRows, row, col), sp.big);
    st_shared(swizzled(qsmall, kRows, row, col), sp.small);
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, 128;" ::: "memory");

  // the products add their two correction terms first and the big.big
  // term last: each wgmma step rounds its sum toward zero, so the long
  // chains run at the corrections' magnitude and only the last Dh / 8 (or
  // 8) steps at the product's
  float o[Dh / 2], pv[Dh / 2], s[32];
  uint32_t ps[32];
#pragma unroll
  for (int i = 0; i < Dh / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l_sum[2] = {0.0f, 0.0f};     // this thread's share of each row's sum

  for (int it = 0; kb_lo + it < n_k; ++it) {
    const int kb = kb_lo + it;
    // logits: Dh / 8 k-steps; step kk reads 32 B at column 8 (kk % 4) of box kk / 4
    const uint32_t kslot = slot(2 * it);
    const uint64_t dqb = desc(qbig), dqs = desc(qsmall);
    const uint64_t dkb = desc(kslot), dks = desc(kslot + L::kPart);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    mbar_wait(full(2 * it), phase(2 * it));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dh / 8; ++kk) {
      const uint32_t qo = ((kk / 4) * kRows * kRowBytes + (kk % 4) * 32) >> 4;
      const uint32_t ko = ((kk / 4) * kKeys * kRowBytes + (kk % 4) * 32) >> 4;
      wgmma_ss(s, dqb + qo, dks + ko);          // big . small
      wgmma_ss(s, dqs + qo, dkb + ko);          // small . big
    }
#pragma unroll
    for (int kk = 0; kk < Dh / 8; ++kk) {
      const uint32_t qo = ((kk / 4) * kRows * kRowBytes + (kk % 4) * 32) >> 4;
      const uint32_t ko = ((kk / 4) * kKeys * kRowBytes + (kk % 4) * 32) >> 4;
      wgmma_ss(s, dqb + qo, dkb + ko);          // big . big
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(empty(2 * it));

    // softcap, masks by index, running max; each a loop of its own, so
    // none branches per element
    const int k0 = kb * kKeys;
    if (softcap > 0.0f) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = __fmul_rn(softcap, tanhf(__fdiv_rn(s[i], softcap)));
    }
    if (k0 + kKeys > S || (causal && kb == n_k - 1) ||
        (kWindow && k0 < q0 + kRows - window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1);
        if (kpos >= S || (causal && kpos > qpos) ||
            (kWindow && kpos <= qpos - window))
          s[i] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }

    // p = exp(l - m') in f32 for the row sums, split for the product: the
    // big part in place of the logits, the small part in ps
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = exp_approx(s[i] - m[(i >> 1) & 1]);
      psum[(i >> 1) & 1] += e;
      const Split sp = split(e);
      s[i] = __uint_as_float(sp.big);
      ps[i] = sp.small;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_sum[r] = __fadd_rn(__fmul_rn(l_sum[r], alpha[r]), psum[r]);

    // this block's P V on its own: 8 k-steps of 8 keys; step j reads 32 B
    // at key column 8 (j % 4) of box j / 4
    const uint32_t vslot = slot(2 * it + 1);
    const uint64_t dvb = desc(vslot), dvs = desc(vslot + L::kPart);
#pragma unroll
    for (int i = 0; i < Dh / 2; ++i) pv[i] = 0.0f;
    mbar_wait(full(2 * it + 1), phase(2 * it + 1));
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const uint32_t vo = ((j / 4) * Dh * kRowBytes + (j % 4) * 32) >> 4;
      const uint32_t pb[4] = {__float_as_uint(s[4 * j]), __float_as_uint(s[4 * j + 2]),
                              __float_as_uint(s[4 * j + 1]),
                              __float_as_uint(s[4 * j + 3])};
      const uint32_t pl[4] = {ps[4 * j], ps[4 * j + 2], ps[4 * j + 1], ps[4 * j + 3]};
      wgmma_rs(pv, pb, dvs + vo);               // big . small
      wgmma_rs(pv, pl, dvb + vo);               // small . big
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const uint32_t vo = ((j / 4) * Dh * kRowBytes + (j % 4) * 32) >> 4;
      const uint32_t pb[4] = {__float_as_uint(s[4 * j]), __float_as_uint(s[4 * j + 2]),
                              __float_as_uint(s[4 * j + 1]),
                              __float_as_uint(s[4 * j + 3])};
      wgmma_rs(pv, pb, dvb + vo);               // big . big
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    mbar_arrive(empty(2 * it + 1));

    // acc * alpha + P V, rounding each step: the Pallas kernel's association
#pragma unroll
    for (int i = 0; i < Dh / 2; ++i)
      o[i] = __fadd_rn(__fmul_rn(o[i], alpha[(i >> 1) & 1]), pv[i]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l_sum[r]), 1e-30f);
    const int qpos = q0 + r0 + 8 * r;
    if (qpos < S) {
      float* dst = out + q_base + qpos * q_row + 2 * c;
#pragma unroll
      for (int j = 0; j < Dh / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(__fdiv_rn(o[4 * j + 2 * r], denom),
                        __fdiv_rn(o[4 * j + 2 * r + 1], denom));
    }
  }
}

// ---- Dh = 256 ----------------------------------------------------------------
//
// At Dh = 256 the plan above does not fit: Q's parts take 128 KB and one
// 64-key slot another 128 KB, and a consumer thread would hold the output
// and the block's P V at 128 registers each.  So this instance takes
// 32-key blocks and two consumer warpgroups over the same 64 query rows
// (384 threads with the producer, at most 168 registers a thread):
//
//   * Q K^T is split by keys: warpgroup w computes the logits of keys
//     16 w .. 16 w + 15 of the block (m64n16k8, Q's and K's parts in shared
//     memory, the same three terms in the same order as above, Dh / 8 = 32
//     k-steps a term);
//   * the row max is the larger of the two halves', exchanged through
//     shared memory (a named barrier over the 256 consumer threads), so both
//     warpgroups hold the same m and alpha; each keeps its own share of the
//     row sums, added once at the end;
//   * each writes its half of P, split into TF32 big and small parts, into
//     shared memory (64 rows x 32 keys, 128-byte swizzled, keys permuted as
//     V^T's are), and after a second named barrier warpgroup w computes P V
//     for output columns 128 w .. 128 w + 127 over all 32 keys (m64n128k8,
//     A = P from shared memory, B = V^T rows 128 w .. from the slot), summed
//     from zero and added as acc * alpha + P V, as above;
//   * shared memory: Q's parts 128 KB, one slot of 64 KB that holds K, then
//     V^T, of one block at a time (the producer loads the next block into
//     registers while the slot is read), P's parts 16 KB, the row maxima and
//     sums 1 KB: 210 KB with the slack and the barriers;
//   * registers: a consumer thread holds the output 64, the block's P V 64
//     and its logits 8; the producer 16 float4 of K and 16 of V.
namespace wide {
constexpr int kDh = 256;
constexpr int kKeys = 32;                       // keys per block
constexpr int kThreads = 384;                   // 2 consumer + producer warpgroup
constexpr uint32_t kQPart = kRows * kDh * 4;    // 64 KB: Q's big or small part
constexpr uint32_t kPart = kKeys * kDh * 4;     // 32 KB: K's (or V^T's) part
constexpr uint32_t kSlot = 0 + 2 * kQPart;      // K or V^T, big then small
constexpr uint32_t kP = kSlot + 2 * kPart;      // P's big, then small part
constexpr uint32_t kPPart = kRows * kKeys * 4;  // 8 KB
constexpr uint32_t kRed = kP + 2 * kPPart;      // row max [2][64], row sum [2][64]
constexpr uint32_t kBar = kRed + 4 * kRows * 4;
constexpr uint32_t kBytes = kBar + 16 + 1024;   // full, empty; the alignment slack
static_assert(kBytes <= kSmemMax, "a CTA has 227 KB of shared memory");
}  // namespace wide

template <bool kWindow>
__global__ void __launch_bounds__(wide::kThreads, 1)
flash_attention_kernel_dh256(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out,
                             int S, int H, int KV, int causal, int window,
                             float softcap, float scale) {
  // this instance's plan (the names shadow the 64-key plan's)
  constexpr int kDh = wide::kDh, kKeys = wide::kKeys;
  constexpr uint32_t kQPart = wide::kQPart, kPart = wide::kPart;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qbig = base, qsmall = qbig + kQPart;
  const uint32_t slot = base + wide::kSlot;
  const uint32_t pbig = base + wide::kP, psmall = pbig + wide::kPPart;
  float* red_max = reinterpret_cast<float*>(smem_raw + (base - raw) + wide::kRed);
  float* red_sum = red_max + 2 * kRows;
  const uint32_t full = base + wide::kBar, empty = full + 8;
  // K(it) is item 2 it and V(it) item 2 it + 1, both in the one slot
  auto phase = [](int item) { return static_cast<uint32_t>(item) & 1u; };

  const int n_tiles = (S + kRows - 1) / kRows;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int n = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = tile * kRows;
  const int n_k = causal ? (q0 + kRows - 1) / kKeys + 1 : (S + kKeys - 1) / kKeys;
  const int kb_lo = kWindow ? first_block(q0, window, kKeys) : 0;
  const int64_t q_row = static_cast<int64_t>(H) * kDh;
  const int64_t kv_row = static_cast<int64_t>(KV) * kDh;
  const int64_t q_base = static_cast<int64_t>(n) * S * q_row + static_cast<int64_t>(h) * kDh;
  const int64_t kv_base = static_cast<int64_t>(n) * S * kv_row + static_cast<int64_t>(g) * kDh;

  if (threadIdx.x == 0) {
    mbar_init(full, 128);
    mbar_init(empty, 256);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: the next block's K is in flight while V is read
    using Pr = Producer<kDh, kKeys, kPart>;
    const Pr pr{k, v, kv_base, kv_row, S, static_cast<int>(threadIdx.x) - 256};
    float4 kr[Pr::kLoads], vr[4 * Pr::kVRounds];
    pr.load_k(kb_lo * kKeys, kr);
    for (int it = 0; kb_lo + it < n_k; ++it) {
      const int kb = kb_lo + it;
      pr.load_v(kb * kKeys, vr);
      mbar_wait(empty, phase(2 * it) ^ 1u);
      pr.store_k(slot, kr);
      fence_proxy_async();
      mbar_arrive(full);
      if (kb + 1 < n_k) pr.load_k((kb + 1) * kKeys, kr);
      mbar_wait(empty, phase(2 * it + 1) ^ 1u);
      pr.store_v(slot, vr);
      fence_proxy_async();
      mbar_arrive(full);
    }
    return;
  }

  // consumers: warpgroup w, the 64 query rows q0 .. q0 + 63
  const int t = threadIdx.x;
  const int w = t >> 7;
  const int lane = t % 32;
  const int r0 = 16 * ((t & 127) / 32) + lane / 4;   // and r0 + 8
  const int c = lane % 4;

  for (int i = t; i < kRows * kDh; i += 256) {
    const int row = i / kDh, col = i % kDh;
    const float x = q0 + row < S
                        ? __fmul_rn(q[q_base + (q0 + row) * q_row + col], scale)
                        : 0.0f;
    const Split sp = split(x);
    st_shared(swizzled(qbig, kRows, row, col), sp.big);
    st_shared(swizzled(qsmall, kRows, row, col), sp.small);
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, 256;" ::: "memory");

  float o[64], pv[64], s[8];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l_sum[2] = {0.0f, 0.0f};     // this thread's share of its half's row sums

  for (int it = 0; kb_lo + it < n_k; ++it) {
    const int kb = kb_lo + it;
    const int k0 = kb * kKeys;
    // logits of keys 16 w .. 16 w + 15: 32 k-steps a term; step kk reads
    // 32 B at column 8 (kk % 4) of box kk / 4, rows 16 w on of K's
    const uint64_t dqb = desc(qbig), dqs = desc(qsmall);
    const uint64_t dkb = desc(slot + w * 16 * kRowBytes),
                   dks = desc(slot + kPart + w * 16 * kRowBytes);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.0f;
    mbar_wait(full, phase(2 * it));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 8; ++kk) {
      const uint32_t qo = ((kk / 4) * kRows * kRowBytes + (kk % 4) * 32) >> 4;
      const uint32_t ko = ((kk / 4) * kKeys * kRowBytes + (kk % 4) * 32) >> 4;
      wgmma_ss(s, dqb + qo, dks + ko);          // big . small
      wgmma_ss(s, dqs + qo, dkb + ko);          // small . big
    }
#pragma unroll
    for (int kk = 0; kk < kDh / 8; ++kk) {
      const uint32_t qo = ((kk / 4) * kRows * kRowBytes + (kk % 4) * 32) >> 4;
      const uint32_t ko = ((kk / 4) * kKeys * kRowBytes + (kk % 4) * 32) >> 4;
      wgmma_ss(s, dqb + qo, dkb + ko);          // big . big
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(empty);

    const int kw = k0 + 16 * w;                 // this half's first key
    if (softcap > 0.0f) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s[i] = __fmul_rn(softcap, tanhf(__fdiv_rn(s[i], softcap)));
    }
    if (k0 + kKeys > S || (causal && k0 + kKeys - 1 > q0) ||
        (kWindow && k0 < q0 + kRows - window)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kpos = kw + 8 * (i >> 2) + 2 * c + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1);
        if (kpos >= S || (causal && kpos > qpos) ||
            (kWindow && kpos <= qpos - window))
          s[i] = kNegInf;
      }
    }
    // the block's row max over both halves
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      if (c == 0) red_max[w * kRows + r0 + 8 * r] = mx[r];
    }
    asm volatile("bar.sync 2, 256;" ::: "memory");
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], fmaxf(mx[r], red_max[(1 - w) * kRows + r0 + 8 * r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }

    // p = exp(l - m') in f32 for the row sums, split into P's parts in
    // shared memory, key k of the block at its permuted position
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = exp_approx(s[i] - m[(i >> 1) & 1]);
      psum[(i >> 1) & 1] += e;
      const Split sp = split(e);
      const int key = 16 * w + 8 * (i >> 2) + 2 * c + (i & 1);
      const int pos = 8 * (key >> 3) + 4 * (key & 1) + ((key & 7) >> 1);
      const int row = r0 + 8 * ((i >> 1) & 1);
      st_shared(swizzled(pbig, kRows, row, pos), sp.big);
      st_shared(swizzled(psmall, kRows, row, pos), sp.small);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_sum[r] = __fadd_rn(__fmul_rn(l_sum[r], alpha[r]), psum[r]);
    fence_proxy_async();
    asm volatile("bar.sync 3, 256;" ::: "memory");

    // this block's P V for columns 128 w ..: 4 k-steps of 8 keys; step j
    // reads 32 B at key column 8 j of P's and V^T's rows
    const uint64_t dpb = desc(pbig), dps = desc(psmall);
    const uint64_t dvb = desc(slot + w * 128 * kRowBytes),
                   dvs = desc(slot + kPart + w * 128 * kRowBytes);
#pragma unroll
    for (int i = 0; i < 64; ++i) pv[i] = 0.0f;
    mbar_wait(full, phase(2 * it + 1));
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      wgmma_ss(pv, dpb + 2 * j, dvs + 2 * j);   // big . small
      wgmma_ss(pv, dps + 2 * j, dvb + 2 * j);   // small . big
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) wgmma_ss(pv, dpb + 2 * j, dvb + 2 * j);  // big . big
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    mbar_arrive(empty);

#pragma unroll
    for (int i = 0; i < 64; ++i)
      o[i] = __fadd_rn(__fmul_rn(o[i], alpha[(i >> 1) & 1]), pv[i]);
  }

  // the row sums: this warpgroup's share, then both halves'
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float part = quad_sum(l_sum[r]);
    if (c == 0) red_sum[w * kRows + r0 + 8 * r] = part;
  }
  asm volatile("bar.sync 2, 256;" ::: "memory");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float denom = fmaxf(__fadd_rn(red_sum[row], red_sum[kRows + row]), 1e-30f);
    const int qpos = q0 + row;
    if (qpos < S) {
      float* dst = out + q_base + qpos * q_row + 128 * w + 2 * c;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(__fdiv_rn(o[4 * j + 2 * r], denom),
                        __fdiv_rn(o[4 * j + 2 * r + 1], denom));
    }
  }
}

template <bool kWindow>
int launch_dh256(const void* q, const void* k, const void* v, void* out, int64_t n,
                 int64_t s, int64_t h, int64_t kv, int causal, int window,
                 float softcap, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel_dh256<kWindow>;
  constexpr uint32_t bytes = wide::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s + kRows - 1) / kRows),
                  static_cast<unsigned>(n * h));
  kernel<<<grid, wide::kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<int>(s),
      static_cast<int>(h), static_cast<int>(kv), causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int Dh, bool kWindow>
int launch(const void* q, const void* k, const void* v, void* out, int64_t n,
           int64_t s, int64_t h, int64_t kv, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<Dh, kWindow>;
  constexpr uint32_t bytes = Layout<Dh>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s + kRows - 1) / kRows),
                  static_cast<unsigned>(n * h));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<int>(s),
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

int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int64_t n, int64_t s, int64_t h, int64_t kv, int64_t dh,
                        int causal, int window, float softcap, float scale,
                        cudaStream_t stream) {
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
    return window > 0 ? launch_dh256<true>(q, k, v, out, n, s, h, kv, causal,
                                           window, softcap, scale, stream)
                      : launch_dh256<false>(q, k, v, out, n, s, h, kv, causal, 0,
                                            softcap, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
