// Hand-written Hopper (sm_90a) kernels for the packed CHOCO gossip path.
//
// Four kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   qsgd_codes_*   <- src/repro/kernels/qsgd.py:qsgd_quantize_codes (_quant_kernel)
//   sign_codes     <- src/repro/kernels/qsgd.py:signnorm_codes      (_sign_kernel)
//   dequantize_*   <- src/repro/kernels/qsgd.py:qsgd_dequantize     (_dequant_kernel)
//   ef_update      <- src/repro/kernels/ef_update.py:ef_gossip_update (_ef_kernel)
//
// What bounds them: all four are elementwise, a handful of flops per
// element against 5-36 bytes moved, so device-memory bandwidth bounds every
// one of them by two orders of magnitude over the f32 rate.  The design
// answers that by reading each input once and writing each output once, in
// one pass: neighbouring threads touch neighbouring addresses (coalesced),
// a grid-stride loop keeps enough loads in flight to cover the whole card
// whatever the bucket length, and offsets are 64-bit because the
// node-stacked embedding bucket holds 4 x 311,164,928 elements.
//
// Buffers are node-stacked: row r of an (n, len) buffer is gossip node r's
// bucket.  Per-node scalars (QSGD's 1/||x||, the dequantize scale) are read
// once per block from an (n,) array: the grid's y dimension is the node.
//
// Every arithmetic step uses an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn), so nothing contracts into an FMA and the results
// are bit-equal to the plain PyTorch versions in kernels/ref.py, which run
// one operation per step.  The ef_update keeps the contract's association
// s' = s + (w_self q_self + w_nbr q_nbr).
//
// C interface for ctypes: each entry launches on the caller's stream and
// returns cudaGetLastError() (0 on success).  Nothing synchronises and
// nothing allocates; the Python wrappers allocate the outputs.

#include <cstdint>
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

__global__ void ef_update_kernel(const float* __restrict__ x_half,
                                 const float* __restrict__ x_hat,
                                 const float* __restrict__ s,
                                 const float* __restrict__ q_self,
                                 const float* __restrict__ q_nbr, float w_self,
                                 float w_nbr, float gamma,
                                 float* __restrict__ x_out,
                                 float* __restrict__ x_hat_out,
                                 float* __restrict__ s_out, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float qs = q_self[i];
    const float xhat_n = __fadd_rn(x_hat[i], qs);
    const float mix = __fadd_rn(__fmul_rn(w_self, qs), __fmul_rn(w_nbr, q_nbr[i]));
    const float s_n = __fadd_rn(s[i], mix);
    x_out[i] = __fadd_rn(x_half[i], __fmul_rn(gamma, __fsub_rn(s_n, xhat_n)));
    x_hat_out[i] = xhat_n;
    s_out[i] = s_n;
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

int ef_update(const float* x_half, const float* x_hat, const float* s,
              const float* q_self, const float* q_nbr, float w_self,
              float w_nbr, float gamma, float* x_out, float* x_hat_out,
              float* s_out, int64_t total, cudaStream_t stream) {
  ef_update_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
      x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma, x_out, x_hat_out,
      s_out, total);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
