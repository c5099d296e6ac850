// Hand-written Hopper (sm_90a) kernel of the collective-layer probe.
//
// Replaces the Pallas kernel of the JAX package's toolchain probe,
// src/repro/kernels/dispatch.py:_probe_shard_map_check_rep (its body
// `kern`, pallas_call at :133): o = x * 2.0 on an (8, 128) f32 block.  The
// JAX probe traces it under a 1-device shard_map to learn whether the
// collective wrapper accepts a kernel's output; the port launches it on
// the rank's device and sends its output one hop around the ring through
// the per-rank engine's transport (kernels/dispatch.py:probe_collectives).
//
// What bounds it: 4 KiB in and 4 KiB out at the probe's shape, so the
// launch latency, far above both the bytes bound and the one multiply per
// element.  The design is the simplest that is right: a grid-stride loop,
// one element per thread per step, the multiply rounded explicitly
// (__fmul_rn), so the output is bit-equal to the plain version in
// kernels/ref.py (a product by 2 is exact anyway).
//
// C interface for ctypes: the entry launches on the caller's stream and
// returns cudaGetLastError() (0 on success).  Nothing synchronises and
// nothing allocates; the Python wrapper allocates the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1024;

__global__ void probe_scale_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    out[i] = __fmul_rn(x[i], 2.0f);
  }
}

}  // namespace

extern "C" {

int probe_scale(const float* x, float* out, int64_t total, cudaStream_t stream) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  probe_scale_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      x, out, total);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
