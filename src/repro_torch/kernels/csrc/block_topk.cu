// Hand-written Hopper (sm_90a) kernel: the per-row top-k selection mask.
//
// Replaces src/repro/kernels/topk.py:block_topk_mask (_block_topk_kernel).
// For x of shape (R, C) f32, C a multiple of 128 (at most 1024), and k,
// each row bisects a magnitude threshold:
//
//   lo = 0, hi = max|x| + 1e-12
//   24 times:  mid = 0.5 (lo + hi);  count(|x| >= mid) >= k ? lo = mid : hi = mid
//   mask = (|x| >= lo) as f32,  thresh = lo
//
// so a row keeps between k and k + ties elements.
//
// What bounds it: each element is read once and its mask written once (8
// bytes), against 24 compares per element, so device-memory bandwidth
// bounds it: 2.5 GB for one node's embedding bucket, 0.75 ms at 3.35 TB/s.
// The design keeps the row in registers for all 24 rounds, so the bytes
// moved are the bound's: one warp per row; lane l holds C/32 values, read
// as float4 loads at (j * 32 + l) * 4, so a warp reads 512 contiguous
// bytes per load and the mask goes out the same way.  The max and each
// round's count are warp reductions (__shfl_xor_sync, __reduce_add_sync);
// every lane applies the same lo/hi update, so no shared memory and no
// block barrier are needed.  The TPU kernel's (8, C) VMEM block becomes
// eight warps of one 256-thread block.
//
// The mask and thresholds are bit-equal to the plain version
// (kernels/ref.py:block_topk_mask_ref): max and compares are exact, and
// the two roundings, max + 1e-12f and 0.5f * (lo + hi), use __fadd_rn /
// __fmul_rn, so nothing contracts.  Row offsets are 64-bit: one node's
// embedding bucket is 2,430,976 rows of 128.
//
// C interface for ctypes: block_topk_mask launches on the caller's
// stream and returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kIterations = 24;
constexpr unsigned kFull = 0xffffffffu;

// VPL: values per lane, C / 32 (a multiple of 4, so whole float4 loads)
template <int VPL>
__global__ void block_topk_mask_kernel(const float* __restrict__ x, int k,
                                       float* __restrict__ mask,
                                       float* __restrict__ thresh,
                                       int64_t rows) {
  constexpr int C = VPL * 32;
  constexpr int kVec = VPL / 4;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together

  const float4* src = reinterpret_cast<const float4*>(x + row * C);
  float mag[VPL];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float4 v = src[j * 32 + lane];
    mag[4 * j + 0] = fabsf(v.x);
    mag[4 * j + 1] = fabsf(v.y);
    mag[4 * j + 2] = fabsf(v.z);
    mag[4 * j + 3] = fabsf(v.w);
  }
  float top = mag[0];
#pragma unroll
  for (int i = 1; i < VPL; ++i) top = fmaxf(top, mag[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = fmaxf(top, __shfl_xor_sync(kFull, top, off));

  float lo = 0.0f;
  float hi = __fadd_rn(top, 1e-12f);
  for (int it = 0; it < kIterations; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned count = 0;
#pragma unroll
    for (int i = 0; i < VPL; ++i) count += mag[i] >= mid ? 1u : 0u;
    const int total = static_cast<int>(__reduce_add_sync(kFull, count));
    if (total >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  float4* dst = reinterpret_cast<float4*>(mask + row * C);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    dst[j * 32 + lane] = make_float4(
        mag[4 * j + 0] >= lo ? 1.0f : 0.0f, mag[4 * j + 1] >= lo ? 1.0f : 0.0f,
        mag[4 * j + 2] >= lo ? 1.0f : 0.0f, mag[4 * j + 3] >= lo ? 1.0f : 0.0f);
  }
  if (lane == 0) thresh[row] = lo;
}

template <int VPL>
int launch(const float* x, int k, float* mask, float* thresh, int64_t rows,
           cudaStream_t stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  block_topk_mask_kernel<VPL><<<static_cast<unsigned int>(blocks), kThreads, 0,
                                stream>>>(x, k, mask, thresh, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, mask: (rows, cols) f32, 16-byte aligned; thresh: (rows,) f32.
// cols is a multiple of 128 up to 1024 (the wrapper checks).
int block_topk_mask(const float* x, int k, float* mask, float* thresh,
                    int64_t rows, int64_t cols, cudaStream_t stream) {
  switch (cols) {
    case 128: return launch<4>(x, k, mask, thresh, rows, stream);
    case 256: return launch<8>(x, k, mask, thresh, rows, stream);
    case 384: return launch<12>(x, k, mask, thresh, rows, stream);
    case 512: return launch<16>(x, k, mask, thresh, rows, stream);
    case 640: return launch<20>(x, k, mask, thresh, rows, stream);
    case 768: return launch<24>(x, k, mask, thresh, rows, stream);
    case 896: return launch<28>(x, k, mask, thresh, rows, stream);
    case 1024: return launch<32>(x, k, mask, thresh, rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
