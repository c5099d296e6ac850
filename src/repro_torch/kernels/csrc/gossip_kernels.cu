// Hand-written Hopper (sm_90a) kernels for the packed CHOCO gossip path.
//
// Four kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   qsgd_codes_*   <- src/repro/kernels/qsgd.py:qsgd_quantize_codes (_quant_kernel)
//   sign_codes     <- src/repro/kernels/qsgd.py:signnorm_codes      (_sign_kernel)
//   dequantize_*   <- src/repro/kernels/qsgd.py:qsgd_dequantize     (_dequant_kernel)
//   ef_update      <- src/repro/kernels/ef_update.py:ef_gossip_update (_ef_kernel)
//
// and kernels with no Pallas counterpart, for what the JAX package runs
// as fused jnp:
//
//   ef_update_bf16  <- the leaf update on bf16 EF state
//                      (src/repro/comm/gossip.py:_choco_leaf_updates)
//   qsgd_leaf_codes <- the per-leaf engine's QSGD.compress
//                      (src/repro/core/compression.py:336), f32 or bf16 input
//   the EF updates in pipelined order <- _pipelined_leaf_updates
//                      (src/repro/comm/pipelined.py:71)
//   replica_update  <- the topology-process engine's replica update
//                      (src/repro/comm/gossip.py:make_process_choco_fn,
//                      :721-810), the matching form, and the ring form of
//                      link failures (tau 0) and of the bounded-staleness
//                      engine (src/repro/comm/async_gossip.py:
//                      make_async_choco_fn, :376-404)
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
// The two EF updates take row strides: ld_x for x, x_hat and s (a leaf of
// the per-leaf engine is a slot of its bucket, buf[:, off:off + len], so its
// rows lie a bucket apart) and ld_q for q_self and q_nbr, so a leaf is
// updated in place without a copy in or out.  The packed engine passes
// ld_x = ld_q = len.  A template flag selects the pipelined order, in which
// x reads the pre-round (s, x_hat):  x' = x + gamma (s - x_hat), then
// x_hat' and s' as above (f32: no FMA; bf16 state: fma(gamma, s - x_hat, x)
// over the unrounded difference, as XLA compiles _pipelined_leaf_updates).
// ef_update_bf16 also takes f32 payloads (q_f32): the per-leaf engine's
// QSGD and sign payloads decode to f32, which JAX sums in f32 and adds to
// x_hat rounded to bf16: x_hat' = bf16(x_hat + bf16(q_self)), the weighted
// sum in f32, rounded once.
//
// qsgd_leaf_codes computes the per-leaf QSGD level
// floor(s |x| / norm + xi), a true division by the row's norm (0 replaced
// by 1), where the packed kernel multiplies by 1/norm: the two differ where
// a value lands on a level boundary.  On bf16 input (bf16 EF state) it
// rounds s |x| to bf16 and divides in f32, without rounding the quotient,
// as XLA compiles the JAX text on the CPU (kernels/ref.py says how that was
// found).
//
// C interface for ctypes: each entry launches on the caller's stream and
// returns cudaGetLastError() (0 on success).  Nothing synchronises and
// nothing allocates; the Python wrappers allocate the outputs.

#include <cstdint>
#include <type_traits>
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Per-leaf QSGD codes: sign(x) floor(s |x| / norm + xi), one row per leaf
// (or per block row of a large leaf); norm has 0 replaced by 1.  TX is
// float, or __nv_bfloat16 (s |x| rounded to bf16 first).
template <typename TX, typename TC>
__global__ void qsgd_leaf_codes_kernel(const TX* __restrict__ x,
                                       const float* __restrict__ xi,
                                       const float* __restrict__ norm, float s,
                                       TC* __restrict__ out, int64_t len) {
  constexpr bool kBf16 = sizeof(TX) == 2;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * len;
  const float nrm = norm[blockIdx.y];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    const float v = to_f32(x[base + i]);
    float m = __fmul_rn(s, fabsf(v));
    if (kBf16) m = round_bf16(m);
    const float level = floorf(__fadd_rn(__fdiv_rn(m, nrm), xi[base + i]));
    out[base + i] = static_cast<TC>(static_cast<int>(__fmul_rn(sign_of(v), level)));
  }
}

template <typename TX>
__global__ void sign_codes_kernel(const TX* __restrict__ x,
                                  int8_t* __restrict__ out, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    out[i] = static_cast<int8_t>(static_cast<int>(sign_of(to_f32(x[i]))));
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

template <bool PIPELINED>
__global__ void ef_update_kernel(float* __restrict__ x,
                                 float* __restrict__ x_hat,
                                 float* __restrict__ s,
                                 const float* __restrict__ q_self,
                                 const float* __restrict__ q_nbr,
                                 const float* __restrict__ w_self,
                                 const float* __restrict__ w_nbr, float gamma,
                                 int64_t len, int64_t ld_x, int64_t ld_q) {
  const int64_t row = blockIdx.y;
  x += row * ld_x;
  x_hat += row * ld_x;
  s += row * ld_x;
  q_self += row * ld_q;
  q_nbr += row * ld_q;
  const float ws = w_self[row];
  const float wn = w_nbr[row];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    const float qs = q_self[i];
    const float xhat_o = x_hat[i];
    const float s_o = s[i];
    const float xhat_n = __fadd_rn(xhat_o, qs);
    const float mix = __fadd_rn(__fmul_rn(ws, qs), __fmul_rn(wn, q_nbr[i]));
    const float s_n = __fadd_rn(s_o, mix);
    const float d = PIPELINED ? __fsub_rn(s_o, xhat_o) : __fsub_rn(s_n, xhat_n);
    x[i] = __fadd_rn(x[i], __fmul_rn(gamma, d));
    x_hat[i] = xhat_n;
    s[i] = s_n;
  }
}

// One element of the bf16-state EF update; x, x_hat and s are updated in
// place through the references.  TQ is the payloads' type: bf16, or f32
// (the per-leaf engine's QSGD and sign payloads).
template <bool PIPELINED, typename TQ>
__device__ __forceinline__ void ef_bf16_one(float& x, __nv_bfloat16& x_hat,
                                            __nv_bfloat16& s, TQ q_self,
                                            TQ q_nbr, float ws, float wn,
                                            float gamma, bool mix_in_bf16) {
  constexpr bool kF32Q = sizeof(TQ) == 4;
  const float qs = to_f32(q_self);
  const float xhat_o = __bfloat162float(x_hat);
  const float s_old = __bfloat162float(s);
  const float xhat_n = round_bf16(__fadd_rn(xhat_o, kF32Q ? round_bf16(qs) : qs));
  const float nbr = __fmul_rn(wn, to_f32(q_nbr));
  float s_n, s_x;
  if (kF32Q) {
    s_n = s_x = round_bf16(__fadd_rn(s_old, round_bf16(__fadd_rn(__fmul_rn(ws, qs), nbr))));
  } else if (mix_in_bf16) {
    const float mix = round_bf16(
        __fadd_rn(round_bf16(__fmul_rn(ws, qs)), round_bf16(nbr)));
    s_n = s_x = round_bf16(__fadd_rn(s_old, mix));
  } else {
    const float mix = round_bf16(__fadd_rn(__fmul_rn(ws, qs), nbr));
    s_n = round_bf16(__fadd_rn(s_old, mix));
    s_x = round_bf16(__fadd_rn(s_old, round_bf16(__fmaf_rn(ws, qs, nbr))));
  }
  const float d = PIPELINED ? __fsub_rn(s_old, xhat_o) : __fsub_rn(s_x, xhat_n);
  x = __fmaf_rn(gamma, d, x);
  x_hat = __float2bfloat16_rn(xhat_n);
  s = __float2bfloat16_rn(s_n);
}

// VEC consecutive elements per thread and iteration: 4 when the row length
// and both strides are multiples of 4 and the buffers are aligned for it (x
// read as float4, the bf16 buffers as 8-byte words), else 1.
template <int VEC, bool PIPELINED, typename TQ>
__global__ void ef_update_bf16_kernel(float* __restrict__ x,
                                      __nv_bfloat16* __restrict__ x_hat,
                                      __nv_bfloat16* __restrict__ s,
                                      const TQ* __restrict__ q_self,
                                      const TQ* __restrict__ q_nbr,
                                      const float* __restrict__ w_self,
                                      const float* __restrict__ w_nbr,
                                      float gamma, int mix_in_bf16,
                                      int64_t len, int64_t ld_x, int64_t ld_q) {
  struct alignas(2 * VEC) Bf { __nv_bfloat16 v[VEC]; };
  struct alignas(4 * VEC) Fl { float v[VEC]; };
  struct alignas(sizeof(TQ) * VEC) Qv { TQ v[VEC]; };
  const int64_t row = blockIdx.y;
  const float ws = w_self[row];
  const float wn = w_nbr[row];
  const bool in_bf16 = mix_in_bf16 != 0;
  Fl* xv = reinterpret_cast<Fl*>(x + row * ld_x);
  Bf* hv = reinterpret_cast<Bf*>(x_hat + row * ld_x);
  Bf* sv = reinterpret_cast<Bf*>(s + row * ld_x);
  const Qv* qv = reinterpret_cast<const Qv*>(q_self + row * ld_q);
  const Qv* nv = reinterpret_cast<const Qv*>(q_nbr + row * ld_q);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len / VEC; i += stride) {
    Fl xs = xv[i];
    Bf hs = hv[i], ss = sv[i];
    const Qv qs = qv[i], ns = nv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      ef_bf16_one<PIPELINED, TQ>(xs.v[j], hs.v[j], ss.v[j], qs.v[j], ns.v[j],
                                 ws, wn, gamma, in_bf16);
    }
    xv[i] = xs;
    hv[i] = hs;
    sv[i] = ss;
  }
}

// The replica update of the topology-process engine (the JAX package's
// make_process_choco_fn, jnp there).  TS is the EF state's type (float or
// bf16), TQ the payloads' (float, or bf16 with bf16 state); round_state
// rounds to TS (nothing for f32), as the JAX text's .astype(h.dtype) does.
// The multiply-adds are the FMAs XLA contracts the JAX text into on the
// CPU (kernels/ref.py:replica_matching_ref, replica_stale_ref), explicit
// here (__fmaf_rn) and nowhere else.
template <typename TS>
__device__ __forceinline__ float round_state(float v) {
  if constexpr (std::is_same<TS, float>::value) {
    return v;
  } else {
    return round_bf16(v);
  }
}

template <typename TS>
__device__ __forceinline__ TS store_state(float v) {
  if constexpr (std::is_same<TS, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// Matching form, one sampled round r: H_r += send q_self, S_r += q_nbr,
// x += (gamma v_r) (S_r - H_r), in place.  send and gv are per node row.
template <typename TS, typename TQ>
__global__ void replica_matching_kernel(float* __restrict__ x,
                                        TS* __restrict__ h,
                                        TS* __restrict__ s,
                                        const TQ* __restrict__ q_self,
                                        const TQ* __restrict__ q_nbr,
                                        const float* __restrict__ send,
                                        const float* __restrict__ gv,
                                        int64_t len, int64_t ld_x,
                                        int64_t ld_q) {
  const int64_t row = blockIdx.y;
  x += row * ld_x;
  h += row * ld_x;
  s += row * ld_x;
  q_self += row * ld_q;
  q_nbr += row * ld_q;
  const float sd = send[row];
  const float g = gv[row];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    const float h_n = round_state<TS>(__fadd_rn(
        to_f32(h[i]), round_state<TS>(__fmul_rn(sd, to_f32(q_self[i])))));
    const float s_n = round_state<TS>(
        __fadd_rn(to_f32(s[i]), round_state<TS>(to_f32(q_nbr[i]))));
    x[i] = __fmaf_rn(g, __fsub_rn(s_n, h_n), x[i]);
    h[i] = store_state<TS>(h_n);
    s[i] = store_state<TS>(s_n);
  }
}

// Ring form, link failures and bounded staleness: x_hat += q_self and the
// recycled own-ring slot takes st(q_self); per round r, S_r += q_r (the
// payload always arrives) and the recycled slot of ring r takes st(q_r);
// diff_r = (S_r - x_hat) - sum_{j < d_r} (ring_r[j] - own[j]), ring and own
// slot 0 being this round's increments and slot j those of j rounds back;
// acc = sum_r w_r diff_r, w_r the round's receive weight (under link
// failures times the sampled edge mask): w_0 d_0 alone, fma(w_0, d_0,
// w_1 d_1) with two rounds, then fma(w_r, d_r, acc); x = fma(gamma, acc, x).
// One launch for all R rounds.  d_r is the row's delay on round r's edge
// (the (R, rows) int32 array dl, clamped to tau; not read at tau 0, where
// no ring is kept: link failures): only the slots j < d_r are read.  reps
// holds the R replicas' pointers, the R payloads', the R tau receive-ring
// slots' (ring r's slot j at 2R + r tau + j) and the tau own-ring slots',
// in device memory, so neither R, tau nor the rows are capped.  VEC
// consecutive elements per thread: 4 when the row length and both strides
// are multiples of 4 and every buffer is aligned for it (the wrapper checks
// the pointers), each buffer then read and written in words of 4 elements;
// else 1.
template <int VEC, typename TS, typename TQ>
__global__ void replica_stale_kernel(float* __restrict__ x,
                                     TS* __restrict__ h,
                                     const TQ* __restrict__ q_self,
                                     void* const* __restrict__ reps,
                                     const float* __restrict__ w,
                                     const int* __restrict__ dl, int rounds,
                                     int tau, int64_t rows, float gamma,
                                     int64_t len, int64_t ld_x,
                                     int64_t ld_q) {
  struct alignas(4 * VEC) Fl { float v[VEC]; };
  struct alignas(sizeof(TS) * VEC) Sv { TS v[VEC]; };
  struct alignas(sizeof(TQ) * VEC) Qv { TQ v[VEC]; };
  const int64_t row = blockIdx.y;
  Fl* xv = reinterpret_cast<Fl*>(x + row * ld_x);
  Sv* hv = reinterpret_cast<Sv*>(h + row * ld_x);
  const Qv* qv = reinterpret_cast<const Qv*>(q_self + row * ld_q);
  void* const* rings = reps + 2 * rounds;
  void* const* own = rings + rounds * tau;
  const auto slot = [&](void* p) {
    return reinterpret_cast<Sv*>(static_cast<TS*>(p) + row * ld_x);
  };
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len / VEC; i += stride) {
    Fl xs = xv[i];
    Sv hs = hv[i];
    const Qv qs = qv[i];
    float q_own[VEC], h_n[VEC], acc[VEC], d0[VEC];
    Sv own0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      q_own[k] = round_state<TS>(to_f32(qs.v[k]));
      h_n[k] = round_state<TS>(__fadd_rn(to_f32(hs.v[k]), q_own[k]));
      own0.v[k] = store_state<TS>(q_own[k]);
      hs.v[k] = store_state<TS>(h_n[k]);
    }
    if (tau > 0) slot(own[0])[i] = own0;
    float w0 = 0.0f;
    for (int r = 0; r < rounds; ++r) {
      Sv* srv = slot(reps[r]);
      const Qv* qrv = reinterpret_cast<const Qv*>(
          static_cast<const TQ*>(reps[rounds + r]) + row * ld_q);
      void* const* ring = rings + r * tau;
      Sv ss = srv[i];
      const Qv qr = qrv[i];
      Sv ring0;
      float q_in[VEC], d[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        q_in[k] = round_state<TS>(to_f32(qr.v[k]));
        const float s_n = round_state<TS>(__fadd_rn(to_f32(ss.v[k]), q_in[k]));
        ss.v[k] = store_state<TS>(s_n);
        ring0.v[k] = store_state<TS>(q_in[k]);
        d[k] = __fsub_rn(s_n, h_n[k]);
      }
      srv[i] = ss;
      if (tau > 0) slot(ring[0])[i] = ring0;
      const int delay = tau > 0 ? min(dl[r * rows + row], tau) : 0;
      for (int j = 0; j < delay; ++j) {
        if (j == 0) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            d[k] = __fsub_rn(d[k], __fsub_rn(q_in[k], q_own[k]));
          }
        } else {
          const Sv rr = slot(ring[j])[i];
          const Sv orr = slot(own[j])[i];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            d[k] = __fsub_rn(d[k],
                             __fsub_rn(to_f32(rr.v[k]), to_f32(orr.v[k])));
          }
        }
      }
      const float wr = w[r * rows + row];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (r == 0) {
          d0[k] = d[k];
          acc[k] = __fmul_rn(wr, d[k]);
        } else if (r == 1) {
          acc[k] = __fmaf_rn(w0, d0[k], __fmul_rn(wr, d[k]));
        } else {
          acc[k] = __fmaf_rn(wr, d[k], acc[k]);
        }
      }
      if (r == 0) w0 = wr;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      xs.v[k] = __fmaf_rn(gamma, acc[k], xs.v[k]);
    }
    xv[i] = xs;
    hv[i] = hs;
  }
}

template <typename T>
struct TypeTag {
  using type = T;
};

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

template <typename TX, typename TC>
int launch_leaf_codes(const void* x, const float* xi, const float* norm,
                      float s, void* out, int64_t n, int64_t len,
                      cudaStream_t stream) {
  const dim3 grid(blocks_for(len), static_cast<unsigned int>(n));
  qsgd_leaf_codes_kernel<TX, TC><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), xi, norm, s, static_cast<TC*>(out), len);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool PIPELINED, typename TQ>
void launch_ef_bf16(float* x, __nv_bfloat16* x_hat, __nv_bfloat16* s,
                    const void* q_self, const void* q_nbr, const float* w_self,
                    const float* w_nbr, float gamma, int mix_in_bf16,
                    int64_t n, int64_t len, int64_t ld_x, int64_t ld_q,
                    cudaStream_t stream) {
  const TQ* qs = static_cast<const TQ*>(q_self);
  const TQ* qn = static_cast<const TQ*>(q_nbr);
  if (len % 4 == 0 && ld_x % 4 == 0 && ld_q % 4 == 0 && aligned(x, 16) &&
      aligned(x_hat, 8) && aligned(s, 8) && aligned(qs, 4 * sizeof(TQ)) &&
      aligned(qn, 4 * sizeof(TQ))) {
    const dim3 grid(blocks_for(len / 4), static_cast<unsigned int>(n));
    ef_update_bf16_kernel<4, PIPELINED, TQ><<<grid, kThreads, 0, stream>>>(
        x, x_hat, s, qs, qn, w_self, w_nbr, gamma, mix_in_bf16, len, ld_x,
        ld_q);
  } else {
    const dim3 grid(blocks_for(len), static_cast<unsigned int>(n));
    ef_update_bf16_kernel<1, PIPELINED, TQ><<<grid, kThreads, 0, stream>>>(
        x, x_hat, s, qs, qn, w_self, w_nbr, gamma, mix_in_bf16, len, ld_x,
        ld_q);
  }
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

int qsgd_leaf_codes(const void* x, int x_bf16, const float* xi,
                    const float* norm, float s, void* out, int out_i16,
                    int64_t n, int64_t len, cudaStream_t stream) {
  if (x_bf16) {
    return out_i16 ? launch_leaf_codes<__nv_bfloat16, int16_t>(
                         x, xi, norm, s, out, n, len, stream)
                   : launch_leaf_codes<__nv_bfloat16, int8_t>(
                         x, xi, norm, s, out, n, len, stream);
  }
  return out_i16 ? launch_leaf_codes<float, int16_t>(x, xi, norm, s, out, n,
                                                      len, stream)
                 : launch_leaf_codes<float, int8_t>(x, xi, norm, s, out, n,
                                                     len, stream);
}

int sign_codes(const void* x, int x_bf16, int8_t* out, int64_t total,
               cudaStream_t stream) {
  if (x_bf16) {
    sign_codes_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), out, total);
  } else {
    sign_codes_kernel<float><<<blocks_for(total), kThreads, 0, stream>>>(
        static_cast<const float*>(x), out, total);
  }
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
              float gamma, int pipelined, int64_t n, int64_t len,
              int64_t ld_x, int64_t ld_q, cudaStream_t stream) {
  const dim3 grid(blocks_for(len), static_cast<unsigned int>(n));
  if (pipelined) {
    ef_update_kernel<true><<<grid, kThreads, 0, stream>>>(
        x, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma, len, ld_x, ld_q);
  } else {
    ef_update_kernel<false><<<grid, kThreads, 0, stream>>>(
        x, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma, len, ld_x, ld_q);
  }
  return static_cast<int>(cudaGetLastError());
}

int ef_update_bf16(float* x, __nv_bfloat16* x_hat, __nv_bfloat16* s,
                   const void* q_self, const void* q_nbr, int q_f32,
                   const float* w_self, const float* w_nbr, float gamma,
                   int mix_in_bf16, int pipelined, int64_t n, int64_t len,
                   int64_t ld_x, int64_t ld_q, cudaStream_t stream) {
  const auto run = [&](auto pipe, auto q) {
    launch_ef_bf16<decltype(pipe)::value, typename decltype(q)::type>(
        x, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma, mix_in_bf16, n, len,
        ld_x, ld_q, stream);
  };
  using Bq = TypeTag<__nv_bfloat16>;
  using Fq = TypeTag<float>;
  if (pipelined) {
    q_f32 ? run(std::true_type{}, Fq{}) : run(std::true_type{}, Bq{});
  } else {
    q_f32 ? run(std::false_type{}, Fq{}) : run(std::false_type{}, Bq{});
  }
  return static_cast<int>(cudaGetLastError());
}

// form 0: matching (s is S_r, q q_nbr, aux0 send, aux1 gamma v, reps
// unused); form 1: link failures (tau 0, aux0 the (R, n) weights recv_r
// keep_r, aux1 unused) and bounded staleness (aux0 the (R, n) receive
// weights, aux1 the (R, n) int32 delays), reps the device array of the R
// replicas', the R payloads', then the R tau receive-ring and the tau
// own-ring slots' pointers; s and q unused; vec4: 4 elements a thread, the
// caller having checked every pointer's alignment.
int replica_update(int form, float* x, void* h, const void* q_self, void* s,
                   const void* q, void* const* reps, int rounds, int tau,
                   const float* aux0, const void* aux1, float gamma,
                   int state_bf16, int q_f32, int vec4, int64_t n,
                   int64_t len, int64_t ld_x, int64_t ld_q,
                   cudaStream_t stream) {
  if (rounds < 1 || (form == 0 && rounds != 1) || form < 0 || form > 1 ||
      tau < 0 || (form == 0 && tau != 0) || (tau > 0 && aux1 == nullptr) ||
      (vec4 && (form != 1 || len % 4 || ld_x % 4 || ld_q % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks_for(len), static_cast<unsigned int>(n));
  const dim3 grid4(blocks_for(len / 4), static_cast<unsigned int>(n));
  const auto run = [&](auto ts, auto tq) {
    using TS = typename decltype(ts)::type;
    using TQ = typename decltype(tq)::type;
    if (form == 0) {
      replica_matching_kernel<TS, TQ><<<grid, kThreads, 0, stream>>>(
          x, static_cast<TS*>(h), static_cast<TS*>(s),
          static_cast<const TQ*>(q_self), static_cast<const TQ*>(q), aux0,
          static_cast<const float*>(aux1), len, ld_x, ld_q);
    } else if (vec4) {
      replica_stale_kernel<4, TS, TQ><<<grid4, kThreads, 0, stream>>>(
          x, static_cast<TS*>(h), static_cast<const TQ*>(q_self), reps, aux0,
          static_cast<const int*>(aux1), rounds, tau, n, gamma, len, ld_x,
          ld_q);
    } else {
      replica_stale_kernel<1, TS, TQ><<<grid, kThreads, 0, stream>>>(
          x, static_cast<TS*>(h), static_cast<const TQ*>(q_self), reps, aux0,
          static_cast<const int*>(aux1), rounds, tau, n, gamma, len, ld_x,
          ld_q);
    }
  };
  using Bf = TypeTag<__nv_bfloat16>;
  using Fl = TypeTag<float>;
  if (!state_bf16) {
    run(Fl{}, Fl{});
  } else if (q_f32) {
    run(Bf{}, Fl{});
  } else {
    run(Bf{}, Bf{});
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
