// Hand-written Hopper (sm_90a) kernel of RWKV-6's WKV recurrence.
//
// It replaces no Pallas kernel: the JAX package runs the recurrence as a
// jnp lax.scan over the tokens (src/repro/models/rwkv6.py:_wkv_scan, :72),
// which XLA compiles into one loop on the TPU.  Eager PyTorch would run that
// scan as a Python loop of about five launches a token, 5M launches a
// 32768-token prefill of rwkv6-3b's 32 layers, so the recurrence gets a
// kernel of its own.  It computes what the scan computes, per (batch, head),
// with k, v in R^64 and the f32 state S in R^{64 x 64}:
//
//   out_t[q]   = sum_p r_t[p] (S[p, q] + u[p] (k_t[p] v_t[q]))   p in order
//   S[p, q]   <- w_t[p] S[p, q] + k_t[p] v_t[q]
//
// What bounds it: the recurrence is serial in t.  The bytes bound (r, k, v
// at 2 bytes in bf16, w and out at 4 bytes, a channel a token; 1.17 GB at
// rwkv6-3b's (1, 32768, 40, 64), 0.35 ms at 3.35 TB/s) is far below what
// one step's dependent chain costs: 64 multiply-adds into out_t[q], in
// order, and a barrier, 32768 times.  The design is the simple one:
//
//   * one block per (batch, head), 64 threads; thread q holds column q of
//     the state, S[:, q], in 64 registers for the whole sequence;
//   * per token, r_t, k_t and w_t are staged through shared memory (each
//     thread writes its own channel; every thread then reads all 64 as
//     broadcasts, four at a time); v_t[q] stays in the thread's register;
//     the staging buffers alternate between two slots, so one barrier a
//     token suffices;
//   * token t + 1's loads are issued before token t's arithmetic, so the
//     device-memory latency hides behind it.
//
// Numbers: r, k, v in the compute dtype (f32 or bf16, upcast on load), w,
// u and the state in f32, the output in f32, as the JAX scan takes and
// gives them.  FMA contraction stays on (the library is held to its plain
// version, kernels/ref.py:wkv6_ref, within 1e-5 of max|out|, not bit for
// bit): each step is k[p] v[q] rounded, then fma(u[p], kv, S[p, q]),
// fma(r[p], ., acc), fma(w[p], S[p, q], kv).
//
// C interface for ctypes: each entry launches on the caller's stream and
// returns cudaGetLastError() (0 on success).  Nothing synchronises and
// nothing allocates; the Python wrapper (kernels/wkv6.py) allocates out and
// the final state.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kP = 64;          // head size (rwkv6-3b and its smoke model)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// r, k, v: (B, S, H, 64) in T; w: (B, S, H, 64) f32; u: (B, H, 64) f32;
// state_in: (B, H, 64, 64) f32 or null (zeros); out: (B, S, H, 64) f32;
// state_out: (B, H, 64, 64) f32.  Grid: B * H blocks of 64 threads.
template <typename T>
__global__ void __launch_bounds__(kP)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ state_in,
            float* __restrict__ out, float* __restrict__ state_out,
            int64_t S, int H) {
  __shared__ __align__(16) float sh_r[2][kP];
  __shared__ __align__(16) float sh_k[2][kP];
  __shared__ __align__(16) float sh_w[2][kP];
  __shared__ __align__(16) float sh_u[kP];

  const int64_t bh = blockIdx.x;                 // b * H + h
  const int64_t b = bh / H, h = bh % H;
  const int q = threadIdx.x;
  const int64_t step = static_cast<int64_t>(H) * kP;
  const int64_t base = b * S * step + h * kP + q;

  float st[kP];
  const float* s_in = state_in == nullptr ? nullptr : state_in + bh * kP * kP;
#pragma unroll
  for (int p = 0; p < kP; ++p) st[p] = s_in == nullptr ? 0.f : s_in[p * kP + q];
  sh_u[q] = u[bh * kP + q];

  float r_n = to_f32(r[base]), k_n = to_f32(k[base]), v_n = to_f32(v[base]);
  float w_n = w[base];
  for (int64_t t = 0; t < S; ++t) {
    const int slot = static_cast<int>(t & 1);
    sh_r[slot][q] = r_n;
    sh_k[slot][q] = k_n;
    sh_w[slot][q] = w_n;
    const float vq = v_n;
    __syncthreads();
    if (t + 1 < S) {
      const int64_t nxt = base + (t + 1) * step;
      r_n = to_f32(r[nxt]);
      k_n = to_f32(k[nxt]);
      v_n = to_f32(v[nxt]);
      w_n = w[nxt];
    }
    const float4* r4 = reinterpret_cast<const float4*>(sh_r[slot]);
    const float4* k4 = reinterpret_cast<const float4*>(sh_k[slot]);
    const float4* w4 = reinterpret_cast<const float4*>(sh_w[slot]);
    const float4* u4 = reinterpret_cast<const float4*>(sh_u);
    float acc = 0.f;
#pragma unroll
    for (int p4 = 0; p4 < kP / 4; ++p4) {
      const float4 rr = r4[p4], kk = k4[p4], ww = w4[p4], uu = u4[p4];
      const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
      const float kv4[4] = {kk.x, kk.y, kk.z, kk.w};
      const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
      const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * p4 + j;
        const float kv = __fmul_rn(kv4[j], vq);
        acc = fmaf(rv[j], fmaf(uv[j], kv, st[p]), acc);
        st[p] = fmaf(wv[j], st[p], kv);
      }
    }
    out[base + t * step] = acc;
  }
  float* s_out = state_out + bh * kP * kP;
#pragma unroll
  for (int p = 0; p < kP; ++p) s_out[p * kP + q] = st[p];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* state_in, float* out,
           float* state_out, int64_t B, int64_t S, int H,
           cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  wkv6_kernel<T><<<static_cast<unsigned int>(B * H), kP, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, state_in, out, state_out, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v: (B, S, H, 64) f32 or bf16; w: (B, S, H, 64) f32; u: (B, H, 64)
// f32; state_in: (B, H, 64, 64) f32 or null; out: (B, S, H, 64) f32;
// state_out: (B, H, 64, 64) f32; all contiguous.
int wkv6_f32(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* state_in, float* out,
             float* state_out, int64_t B, int64_t S, int H,
             cudaStream_t stream) {
  return launch<float>(r, k, v, w, u, state_in, out, state_out, B, S, H,
                       stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* state_in, float* out,
              float* state_out, int64_t B, int64_t S, int H,
              cudaStream_t stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, state_in, out, state_out, B,
                               S, H, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
