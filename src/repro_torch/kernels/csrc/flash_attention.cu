// Hand-written Hopper (sm_90a) flash-attention forward kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_single (_flash_kernel) and its GQA wrapper
// flash_attention.  Per (batch, head) it computes online-softmax attention
// over 128 x 128 tiles, in f32 whatever the input type:
//
//   q' = q * scale (scale = 1/sqrt(Dh)),  l = q' k^T,
//   l = softcap * tanh(l / softcap)          (when softcap > 0)
//   l = -1e30 where k_pos > q_pos            (when causal)
//   running max m, denominator l_sum, accumulator acc per query row,
//   out = acc / max(l_sum, 1e-30), stored in the input type.
//
// The K loop of a causal query tile stops at the diagonal tile, as the
// Pallas kernel's does.  Unlike the Pallas kernel, any sequence length is
// taken: the last tile is ragged, missing query rows are not stored and
// missing key columns are masked.
//
// Layout: q and out are (N, S, H, Dh), k and v (N, S, KV, Dh), contiguous,
// read in place: head h reads KV head h / (H / KV), so GQA needs no
// repeated copy and nothing is transposed in device memory.
//
// What bounds it on this card: a causal 32768-token prefill layer of
// qwen3-1.7b does 2 * 16 * 32768^2 * 128 = 4.4e12 flops on 0.5 GB of
// inputs and output, so it is bound by operations, not bytes.  This
// kernel computes in f32 on the CUDA cores (67 TFLOP/s), not on the tensor
// cores; wgmma and TMA are later work.  The design keeps the CUDA cores
// fed from shared memory:
//
//   * one CTA of 256 threads per (n * H + h, 128-row query tile); causal
//     grids start with the heaviest tiles;
//   * the query tile lives in shared memory, transposed and pre-scaled;
//     K and V tiles stream through one shared buffer (K transposed, then
//     V row-major), and the probabilities P go through shared memory
//     transposed, so every inner-loop read is a broadcast float4 or a
//     conflict-free float;
//   * each thread owns an 8 x 8 block of the 128 x 128 logits (rows
//     8*ty..8*ty+7, columns tx + 16*j) and an 8 x Dh/16 block of the
//     output: 64 FMAs per 10 shared loads.  Row max and sum reduce over
//     the 16 lanes of a half-warp with shuffles.
//   * each key block's P V is summed on its own and then added to the
//     rescaled accumulator, acc * alpha + P V, as the Pallas kernel and the
//     plain version associate it (rounding each step, no FMA across it).
//
// Shared memory per CTA: 198 KB at Dh = 128 (one CTA per SM).
//
// C interface for ctypes: each entry launches on the caller's stream and
// returns cudaGetLastError() (0 on success).  Nothing synchronises and
// nothing allocates; the Python wrapper allocates the output.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;             // query rows and key columns per tile
constexpr int kThreads = 256;
constexpr int kRows = 8;                // query rows per thread
constexpr int kCols = 8;                // key columns per thread
constexpr int kPitch = kBlock + 4;      // row pitch of transposed tiles
constexpr float kNegInf = -1e30f;       // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int Dh>
constexpr size_t smem_bytes() {
  // Q^T (Dh x kPitch) + K^T / V (Dh x kPitch) + P^T (kBlock x kPitch)
  return sizeof(float) * (2 * Dh * kPitch + kBlock * kPitch);
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KV, int causal, float softcap, float scale) {
  static_assert(Dh % 16 == 0 && Dh <= 128, "head dim");
  constexpr int kOut = Dh / 16;         // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // qt[d * kPitch + r]
  float* kv = qt + Dh * kPitch;                  // kt[d * kPitch + c] / v[c * Dh + d]
  float* pt = kv + Dh * kPitch;                  // pt[c * kPitch + r]

  const int n_tiles = (S + kBlock - 1) / kBlock;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int n = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int64_t q_row = static_cast<int64_t>(H) * Dh;
  const int64_t kv_row = static_cast<int64_t>(KV) * Dh;
  const int64_t q_base = static_cast<int64_t>(n) * S * q_row + static_cast<int64_t>(h) * Dh;
  const int64_t kv_base = static_cast<int64_t>(n) * S * kv_row + static_cast<int64_t>(g) * Dh;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = tile * kBlock;

  // Q tile, scaled and transposed; rows past S are zero and never stored.
  for (int i = tid; i < kBlock * Dh; i += kThreads) {
    const int r = i / Dh, d = i % Dh;
    const int pos = q0 + r;
    qt[d * kPitch + r] =
        pos < S ? to_f32(q[q_base + pos * q_row + d]) * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.0f;
  }

  const int n_k = causal ? tile + 1 : n_tiles;
  for (int kj = 0; kj < n_k; ++kj) {
    const int k0 = kj * kBlock;
    __syncthreads();   // the last tile's reads of kv and pt are done
    for (int i = tid; i < kBlock * Dh; i += kThreads) {
      const int c = i / Dh, d = i % Dh;
      const int pos = k0 + c;
      kv[d * kPitch + c] = pos < S ? to_f32(k[kv_base + pos * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols], scale_acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qt[d * kPitch + ty * kRows]);
      const float4 qb = *reinterpret_cast<const float4*>(&qt[d * kPitch + ty * kRows + 4]);
      const float qr[kRows] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float kc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kc[j] = kv[d * kPitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos < S && (!causal || kpos <= qpos);
        s[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + psum;       // this lane's share; summed at the end
      scale_acc[i] = alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float* dst = &pt[(tx + 16 * j) * kPitch + ty * kRows];
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();   // P is written and every read of K^T is done

    for (int i = tid; i < kBlock * Dh; i += kThreads) {
      const int c = i / Dh, d = i % Dh;
      const int pos = k0 + c;
      kv[c * Dh + d] = pos < S ? to_f32(v[kv_base + pos * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    // P V for this key block on its own, then acc * alpha + P V: the
    // Pallas kernel's association, so the running sum rounds once per block
    float pv[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kOut; ++j) pv[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&pt[c * kPitch + ty * kRows]);
      const float4 pb = *reinterpret_cast<const float4*>(&pt[c * kPitch + ty * kRows + 4]);
      const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[kOut];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = kv[c * Dh + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) pv[i][j] = fmaf(p[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], scale_acc[i]), pv[i][j]);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float denom = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int qpos = q0 + ty * kRows + i;
    if (qpos < S) {
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        out[q_base + qpos * q_row + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int Dh>
int launch(const void* q, const void* k, const void* v, void* out, int64_t n,
           int64_t s, int64_t h, int64_t kv, int causal, float softcap,
           float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, Dh>;
  constexpr size_t bytes = smem_bytes<Dh>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s + kBlock - 1) / kBlock),
                  static_cast<unsigned>(n * h));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<int>(s),
      static_cast<int>(h), static_cast<int>(kv), causal, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* out,
                int64_t n, int64_t s, int64_t h, int64_t kv, int64_t dh,
                int causal, float softcap, float scale, cudaStream_t stream) {
  if (n < 1 || s < 1 || kv < 1 || h % kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64)
    return launch<T, 64>(q, k, v, out, n, s, h, kv, causal, softcap, scale, stream);
  if (dh == 128)
    return launch<T, 128>(q, k, v, out, n, s, h, kv, causal, softcap, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int64_t n, int64_t s, int64_t h, int64_t kv, int64_t dh,
                        int causal, float softcap, float scale,
                        cudaStream_t stream) {
  return dispatch_dh<float>(q, k, v, out, n, s, h, kv, dh, causal, softcap,
                            scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                         int64_t n, int64_t s, int64_t h, int64_t kv, int64_t dh,
                         int causal, float softcap, float scale,
                         cudaStream_t stream) {
  return dispatch_dh<__nv_bfloat16>(q, k, v, out, n, s, h, kv, dh, causal,
                                    softcap, scale, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
