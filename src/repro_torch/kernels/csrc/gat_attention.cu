// GAT edge attention and SDDMM over fixed-fanout neighbour matrices, for
// Hopper (sm_90a).
//
//   gat_attention: alpha[i,f,h] = softmax_f(<q_h[i], k_h[nbr[i,f]]> / sqrt(dh))
//                  with masked slots filled with -1e30 before the softmax and
//                  multiplied by 0 after it; out (N, F, heads) f32.
//   sddmm:         e[i,f] = <q[i], k[nbr[i,f]]> * mask[i,f]; out (N, F) f32.
//
// Replace the Pallas TPU kernels src/repro/kernels/gat_attention.py::
// gat_attention and src/repro/kernels/sddmm.py::sddmm.  sddmm is the scoring
// half of gat_attention with one head, no scale and no softmax; both share
// `row_dots` below.
//
// Bound: bytes.  Each edge gathers one row of k (D * 4 bytes in f32) for
// 2 * D flops.  Design: one warp per output row.  The warp stages q's row in
// shared memory as f32, then for each f in order gathers k's row (lanes over
// the columns of one head, so each head's slice is one coalesced read),
// forms each head's dot with an in-order per-lane sum and a butterfly
// reduction across the warp, and keeps the F x heads scores in shared
// memory.  The softmax over F (F is the fanout, 8 by default) runs per head
// on one lane each: the same divide by sqrtf(dh), -1e30 fill, max-subtracted
// expf, sum and divide as jax.nn.softmax.  A row whose slots are all masked
// comes out all 0 (uniform 1/F, then times 0), exactly as in JAX.  Nothing of
// the score tensor reaches device memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// scores[f * heads + hh] = <q_hh, k_hh[nbr[f]]> for f < F, hh < heads.
// qs: the row of q in shared memory (f32); called by all 32 lanes.
template <typename T>
__device__ __forceinline__ void row_dots(const float* qs,
                                         const T* __restrict__ k,
                                         const int32_t* __restrict__ nbr_row,
                                         int F, int D, int heads,
                                         float* scores, int lane) {
  const int dh = D / heads;
  for (int f = 0; f < F; ++f) {
    const T* kr = k + (long long)nbr_row[f] * D;
    for (int hh = 0; hh < heads; ++hh) {
      const int c0 = hh * dh;
      float part = 0.0f;
      for (int c = lane; c < dh; c += 32)
        part = __fadd_rn(part, __fmul_rn(qs[c0 + c], to_f32(kr[c0 + c])));
      // butterfly: every lane ends with the same bits
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(kFull, part, o));
      if (lane == 0) scores[f * heads + hh] = part;
    }
  }
}

// stage q's row in this warp's shared memory, as f32
template <typename T>
__device__ __forceinline__ void stage_row(float* qs, const T* __restrict__ q,
                                          long long r, int D, int lane) {
  const T* qr = q + r * D;
  for (int c = lane; c < D; c += 32) qs[c] = to_f32(qr[c]);
  __syncwarp();
}

template <typename T>
__global__ void gat_attention_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const int32_t* __restrict__ nbr,
                                     const uint8_t* __restrict__ mask,
                                     float* __restrict__ out, long long N,
                                     int F, int D, int heads) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * warps + wid;
  if (r >= N) return;                    // whole warp; no block barrier
  float* qs = smem + (long long)wid * (D + F * heads);
  float* sc = qs + D;
  stage_row(qs, q, r, D, lane);
  row_dots(qs, k, nbr + r * F, F, D, heads, sc, lane);
  __syncwarp();

  const float scale = sqrtf((float)(D / heads));
  const uint8_t* mrow = mask + r * F;
  float* orow = out + r * F * heads;
  for (int hh = lane; hh < heads; hh += 32) {
    float mx = 0.0f;
    for (int f = 0; f < F; ++f) {        // s / sqrt(dh), -1e30 fill, max
      const float s = mrow[f] ? __fdiv_rn(sc[f * heads + hh], scale) : -1e30f;
      sc[f * heads + hh] = s;
      mx = (f == 0) ? s : fmaxf(mx, s);
    }
    float sum = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float e = expf(__fsub_rn(sc[f * heads + hh], mx));
      sc[f * heads + hh] = e;
      sum = __fadd_rn(sum, e);
    }
    for (int f = 0; f < F; ++f)
      orow[f * heads + hh] =
          __fmul_rn(__fdiv_rn(sc[f * heads + hh], sum), mrow[f] ? 1.0f : 0.0f);
  }
}

template <typename T>
__global__ void sddmm_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const int32_t* __restrict__ nbr,
                             const uint8_t* __restrict__ mask,
                             float* __restrict__ out, long long N, int F,
                             int D) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * warps + wid;
  if (r >= N) return;
  float* qs = smem + (long long)wid * (D + F);
  float* sc = qs + D;
  stage_row(qs, q, r, D, lane);
  row_dots(qs, k, nbr + r * F, F, D, 1, sc, lane);
  __syncwarp();
  for (int f = lane; f < F; f += 32)
    out[r * F + f] = __fmul_rn(sc[f], mask[r * F + f] ? 1.0f : 0.0f);
}

size_t smem_bytes(int warps, int D, int F, int heads) {
  return (size_t)warps * (D + (size_t)F * heads) * sizeof(float);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q and k share it).  One warp per
// row, `warps` rows per block.  Returns the launch's cudaError_t.
extern "C" int deal_gat_attention(const void* q, const void* k,
                                  const int32_t* nbr, const uint8_t* mask,
                                  float* out, long long N, int F, int D,
                                  int heads, int dtype, int warps,
                                  void* stream) {
  if (N <= 0) return 0;
  if (heads < 1 || D % heads != 0 || warps < 1 || warps > 32)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(warps, D, F, heads);
  const dim3 grid((unsigned)((N + warps - 1) / warps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gat_attention_kernel<float><<<grid, warps * 32, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), nbr, mask,
        out, N, F, D, heads);
  else if (dtype == 1)
    gat_attention_kernel<__nv_bfloat16><<<grid, warps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), nbr, mask, out, N, F, D, heads);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int deal_sddmm(const void* q, const void* k, const int32_t* nbr,
                          const uint8_t* mask, float* out, long long N, int F,
                          int D, int dtype, int warps, void* stream) {
  if (N <= 0) return 0;
  if (warps < 1 || warps > 32) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(warps, D, F, 1);
  const dim3 grid((unsigned)((N + warps - 1) / warps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sddmm_kernel<float><<<grid, warps * 32, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), nbr, mask,
        out, N, F, D);
  else if (dtype == 1)
    sddmm_kernel<__nv_bfloat16><<<grid, warps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), nbr, mask, out, N, F, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
