// Hand-written Hopper (sm_90a) kernels for the packed CHOCO gossip path.
//
// Four kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   qsgd_codes_*   <- src/repro/kernels/qsgd.py:qsgd_quantize_codes (_quant_kernel)
//   sign_codes     <- src/repro/kernels/qsgd.py:signnorm_codes      (_sign_kernel)
//   dequantize_*   <- src/repro/kernels/qsgd.py:qsgd_dequantize     (_dequant_kernel)
//   ef_update      <- src/repro/kernels/ef_update.py:ef_gossip_update (_ef_kernel)
//
// and a fifth with no Pallas counterpart:
//
//   ef_update_bf16 <- the leaf update the JAX package's packed engine runs
//                     as fused jnp on bf16 EF state
//                     (src/repro/comm/gossip.py:_choco_leaf_updates)
//
// What bounds them: all five are elementwise, a handful of flops per
// element against 5-36 bytes moved, so device-memory bandwidth bounds every
// one of them by two orders of magnitude over the f32 rate.  The design
// answers that by reading each input once and writing each output once, in
// one pass: neighbouring threads touch neighbouring addresses (coalesced),
// a grid-stride loop keeps enough loads in flight to cover the whole card
// whatever the bucket length, and offsets are 64-bit because the
// node-stacked embedding bucket holds 4 x 311,164,928 elements.
//
// Buffers are node-stacked: row r of an (n, len) buffer is gossip node r's
// bucket.  Per-node scalars (QSGD's 1/||x||, the dequantize scale, the EF
// update's self and neighbour weights) are read once per block from an (n,)
// array: the grid's y dimension is the node, so no element pays for a
// division by the row length to find its node.
//
// Every arithmetic step uses an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn), so nothing contracts into an FMA and the results
// are bit-equal to the plain PyTorch versions in kernels/ref.py, which run
// one operation per step.  The ef_update keeps the contract's association
// s' = s + (w_self q_self + w_nbr q_nbr), and updates x, x_hat and s in
// place (x holds x_half on entry): each element is read, then written, by
// the one thread that owns it.
//
// ef_update_bf16 takes x in f32 and x_hat, s, q_self, q_nbr in bf16 (20
// bytes per element against the f32 kernel's 32).  It reproduces the
// rounding of the JAX engine's leaf update on bf16 leaves as XLA compiles
// it (kernels/ref.py:ef_update_bf16_ref): x_hat + q_self, s + the weighted
// sum and the weighted sum round to bf16 (nearest even), and so does each
// of its two products when the weights are uniform (Python floats, which
// JAX multiplies in bf16: mix_in_bf16); per-node self weights are f32 in
// JAX and the sum is then taken in f32.  x' is one FMA,
// fma(gamma, s'' - x_hat', x), over an unrounded difference; s'' is s',
// except that with per-node weights it is recomputed from
// fma(w_self, q_self, w_nbr q_nbr), as XLA's fusion for x recomputes it.
// These FMAs are explicit (__fmaf_rn); nothing else contracts.  Where the
// row length is a multiple of 4 (every compressed bucket: they are
// multiples of 128), each thread moves 4 elements per load: x as one
// 16-byte word, each bf16 buffer as one 8-byte word.
//
// C interface for ctypes: each entry launches on the caller's stream and
// returns cudaGetLastError() (0 on success).  Nothing synchronises and
// nothing allocates; the Python wrappers allocate the outputs.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

template <typename T>
__global__ void qsgd_codes_kernel(const float* __restrict__ x,
                                  const float* __restrict__ xi,
                                  const float* __restrict__ inv_norm, float s,
                                  T* __restrict__ out, int64_t len) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * len;
  const float inv = inv_norm[blockIdx.y];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    const float v = x[base + i];
    const float level =
        floorf(__fadd_rn(__fmul_rn(__fmul_rn(fabsf(v), inv), s), xi[base + i]));
    out[base + i] = static_cast<T>(static_cast<int>(__fmul_rn(sign_of(v), level)));
  }
}

__global__ void sign_codes_kernel(const float* __restrict__ x,
                                  int8_t* __restrict__ out, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    out[i] = static_cast<int8_t>(static_cast<int>(sign_of(x[i])));
  }
}

template <typename T>
__global__ void dequantize_kernel(const T* __restrict__ codes,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, int64_t len) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * len;
  const float sc = scale[blockIdx.y];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    out[base + i] = __fmul_rn(static_cast<float>(codes[base + i]), sc);
  }
}

__global__ void ef_update_kernel(float* __restrict__ x,
                                 float* __restrict__ x_hat,
                                 float* __restrict__ s,
                                 const float* __restrict__ q_self,
                                 const float* __restrict__ q_nbr,
                                 const float* __restrict__ w_self,
                                 const float* __restrict__ w_nbr, float gamma,
                                 int64_t len) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * len;
  const float ws = w_self[blockIdx.y];
  const float wn = w_nbr[blockIdx.y];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = base + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < base + len; i += stride) {
    const float qs = q_self[i];
    const float xhat_n = __fadd_rn(x_hat[i], qs);
    const float mix = __fadd_rn(__fmul_rn(ws, qs), __fmul_rn(wn, q_nbr[i]));
    const float s_n = __fadd_rn(s[i], mix);
    x[i] = __fadd_rn(x[i], __fmul_rn(gamma, __fsub_rn(s_n, xhat_n)));
    x_hat[i] = xhat_n;
    s[i] = s_n;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One element of the bf16-state EF update; x, x_hat and s are updated in
// place through the references.
__device__ __forceinline__ void ef_bf16_one(float& x, __nv_bfloat16& x_hat,
                                            __nv_bfloat16& s,
                                            __nv_bfloat16 q_self,
                                            __nv_bfloat16 q_nbr, float ws,
                                            float wn, float gamma,
                                            bool mix_in_bf16) {
  const float qs = __bfloat162float(q_self);
  const float xhat_n = round_bf16(__fadd_rn(__bfloat162float(x_hat), qs));
  const float s_old = __bfloat162float(s);
  const float nbr = __fmul_rn(wn, __bfloat162float(q_nbr));
  float s_n, s_x;
  if (mix_in_bf16) {
    const float mix = round_bf16(
        __fadd_rn(round_bf16(__fmul_rn(ws, qs)), round_bf16(nbr)));
    s_n = s_x = round_bf16(__fadd_rn(s_old, mix));
  } else {
    const float mix = round_bf16(__fadd_rn(__fmul_rn(ws, qs), nbr));
    s_n = round_bf16(__fadd_rn(s_old, mix));
    s_x = round_bf16(__fadd_rn(s_old, round_bf16(__fmaf_rn(ws, qs, nbr))));
  }
  x = __fmaf_rn(gamma, __fsub_rn(s_x, xhat_n), x);
  x_hat = __float2bfloat16_rn(xhat_n);
  s = __float2bfloat16_rn(s_n);
}

// VEC consecutive elements per thread and iteration: 4 when the row length
// is a multiple of 4 and the buffers are aligned for it (x read as float4,
// the bf16 buffers as 8-byte words), else 1.
template <int VEC>
__global__ void ef_update_bf16_kernel(float* __restrict__ x,
                                      __nv_bfloat16* __restrict__ x_hat,
                                      __nv_bfloat16* __restrict__ s,
                                      const __nv_bfloat16* __restrict__ q_self,
                                      const __nv_bfloat16* __restrict__ q_nbr,
                                      const float* __restrict__ w_self,
                                      const float* __restrict__ w_nbr,
                                      float gamma, int mix_in_bf16,
                                      int64_t len) {
  struct alignas(2 * VEC) Bf { __nv_bfloat16 v[VEC]; };
  struct alignas(4 * VEC) Fl { float v[VEC]; };
  const int64_t base = static_cast<int64_t>(blockIdx.y) * (len / VEC);
  const float ws = w_self[blockIdx.y];
  const float wn = w_nbr[blockIdx.y];
  const bool in_bf16 = mix_in_bf16 != 0;
  Fl* xv = reinterpret_cast<Fl*>(x);
  Bf* hv = reinterpret_cast<Bf*>(x_hat);
  Bf* sv = reinterpret_cast<Bf*>(s);
  const Bf* qv = reinterpret_cast<const Bf*>(q_self);
  const Bf* nv = reinterpret_cast<const Bf*>(q_nbr);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = base + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < base + len / VEC; i += stride) {
    Fl xs = xv[i];
    Bf hs = hv[i], ss = sv[i];
    const Bf qs = qv[i], ns = nv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      ef_bf16_one(xs.v[j], hs.v[j], ss.v[j], qs.v[j], ns.v[j], ws, wn, gamma,
                  in_bf16);
    }
    xv[i] = xs;
    hv[i] = hs;
    sv[i] = ss;
  }
}

unsigned int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned int>(b < 1 ? 1 : b);
}

template <typename T>
int launch_qsgd(const float* x, const float* xi, const float* inv_norm, float s,
                T* out, int64_t n, int64_t len, cudaStream_t stream) {
  const dim3 grid(blocks_for(len), static_cast<unsigned int>(n));
  qsgd_codes_kernel<T><<<grid, kThreads, 0, stream>>>(x, xi, inv_norm, s, out, len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequantize(const T* codes, const float* scale, float* out, int64_t n,
                      int64_t len, cudaStream_t stream) {
  const dim3 grid(blocks_for(len), static_cast<unsigned int>(n));
  dequantize_kernel<T><<<grid, kThreads, 0, stream>>>(codes, scale, out, len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int qsgd_codes_i8(const float* x, const float* xi, const float* inv_norm,
                  float s, int8_t* out, int64_t n, int64_t len,
                  cudaStream_t stream) {
  return launch_qsgd<int8_t>(x, xi, inv_norm, s, out, n, len, stream);
}

int qsgd_codes_i16(const float* x, const float* xi, const float* inv_norm,
                   float s, int16_t* out, int64_t n, int64_t len,
                   cudaStream_t stream) {
  return launch_qsgd<int16_t>(x, xi, inv_norm, s, out, n, len, stream);
}

int sign_codes(const float* x, int8_t* out, int64_t total, cudaStream_t stream) {
  sign_codes_kernel<<<blocks_for(total), kThreads, 0, stream>>>(x, out, total);
  return static_cast<int>(cudaGetLastError());
}

int dequantize_i8(const int8_t* codes, const float* scale, float* out, int64_t n,
                  int64_t len, cudaStream_t stream) {
  return launch_dequantize<int8_t>(codes, scale, out, n, len, stream);
}

int dequantize_i16(const int16_t* codes, const float* scale, float* out,
                   int64_t n, int64_t len, cudaStream_t stream) {
  return launch_dequantize<int16_t>(codes, scale, out, n, len, stream);
}

int ef_update(float* x, float* x_hat, float* s, const float* q_self,
              const float* q_nbr, const float* w_self, const float* w_nbr,
              float gamma, int64_t n, int64_t len, cudaStream_t stream) {
  const dim3 grid(blocks_for(len), static_cast<unsigned int>(n));
  ef_update_kernel<<<grid, kThreads, 0, stream>>>(
      x, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma, len);
  return static_cast<int>(cudaGetLastError());
}

int ef_update_bf16(float* x, __nv_bfloat16* x_hat, __nv_bfloat16* s,
                   const __nv_bfloat16* q_self, const __nv_bfloat16* q_nbr,
                   const float* w_self, const float* w_nbr, float gamma,
                   int mix_in_bf16, int64_t n, int64_t len,
                   cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  if (len % 4 == 0 && aligned(x, 16) && aligned(x_hat, 8) && aligned(s, 8) &&
      aligned(q_self, 8) && aligned(q_nbr, 8)) {
    const dim3 grid(blocks_for(len / 4), static_cast<unsigned int>(n));
    ef_update_bf16_kernel<4><<<grid, kThreads, 0, stream>>>(
        x, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma, mix_in_bf16, len);
  } else {
    const dim3 grid(blocks_for(len), static_cast<unsigned int>(n));
    ef_update_bf16_kernel<1><<<grid, kThreads, 0, stream>>>(
        x, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma, mix_in_bf16, len);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
