// Fanout-gather SPMM for Hopper (sm_90a), with an optional fused id table.
//
//   out[i, :] = sum_f  coef(w[i,f] * mask[i,f]) * h[idx(i,f), :]
//   idx(i,f)  = nbr[i,f]                 (spmm)
//             = table[nbr[i,f]]          (gather_spmm)
//
// Replaces the Pallas TPU kernels src/repro/kernels/spmm.py::spmm and
// src/repro/kernels/gather_spmm.py::gather_spmm.  Like them it rounds the
// coefficient w*mask to h's dtype before the f32 sum, multiplies masked
// slots by their exact 0.0 instead of skipping them, and casts the f32 sum
// back to h's dtype.
//
// Bound: bytes.  Each edge gathers one row of h (D * 4 bytes in f32) for
// 2 * D flops, far below the card's ridge point.  Design: a 2-D block of
// threads, threadIdx.x over 16-byte column vectors of a row (neighbouring
// threads on neighbouring addresses, so each gathered row is one coalesced
// read), threadIdx.y over rows.  Each thread keeps its VEC-column sum in f32
// registers and walks f in order, so every output element is the same sum in
// the same order whatever the tiling: the output is bitwise identical across
// (block_rows, block_cols).  Products and sums are rounded separately
// (__fmul_rn / __fadd_rn, no contraction into FMA), as the TPU kernel's
// `acc + coef * row` is.  Ragged R and D are masked in the kernel, so callers
// pad nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// round an f32 to the feature dtype and back (identity for f32)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC consecutive elements as f32: one 16-byte load when VEC > 1
__device__ __forceinline__ void load_vec(const float* p, float (&x)[1]) {
  x[0] = p[0];
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[1]) {
  x[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {          // element 2i is the low half
    x[2 * i] = __uint_as_float(words[i] << 16);
    x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&x)[1]) {
  p[0] = x[0];
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&x)[1]) {
  p[0] = __float2bfloat16_rn(x[0]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&x)[8]) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i]));
    const uint32_t hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i + 1]));
    words[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) =
      make_uint4(words[0], words[1], words[2], words[3]);
}

template <typename HT, int VEC>
__global__ void spmm_kernel(const HT* __restrict__ h,
                            const int32_t* __restrict__ table,
                            const float* __restrict__ w,
                            const uint8_t* __restrict__ mask,
                            const int32_t* __restrict__ nbr,
                            HT* __restrict__ out, long long R, int F, int D) {
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (r >= R || c >= D) return;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  const long long e0 = r * F;
  for (int f = 0; f < F; ++f) {
    int32_t idx = nbr[e0 + f];
    if (table != nullptr) idx = table[idx];
    // (w * mask) in f32, rounded to h's dtype, as spmm.py:76 does
    const float wm = __fmul_rn(w[e0 + f], mask[e0 + f] ? 1.0f : 0.0f);
    const float coef = round_to(wm, h);
    float x[VEC];
    load_vec(h + (long long)idx * D + c, x);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(coef, x[i]));
  }
  store_vec(out + r * D + c, acc);
}

template <typename HT, int VEC>
cudaError_t launch(const void* h, const int32_t* table, const float* w,
                   const uint8_t* mask, const int32_t* nbr, void* out,
                   long long R, int F, int D, int block_rows, int block_cols,
                   cudaStream_t stream) {
  const long long nvec = D / VEC;
  const dim3 block(block_cols, block_rows);
  const dim3 grid((unsigned)((R + block_rows - 1) / block_rows),
                  (unsigned)((nvec + block_cols - 1) / block_cols));
  spmm_kernel<HT, VEC><<<grid, block, 0, stream>>>(
      static_cast<const HT*>(h), table, w, mask, nbr, static_cast<HT*>(out), R,
      F, D);
  return cudaGetLastError();
}

template <typename HT>
cudaError_t launch_vec(const void* h, const int32_t* table, const float* w,
                       const uint8_t* mask, const int32_t* nbr, void* out,
                       long long R, int F, int D, int vec, int block_rows,
                       int block_cols, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(HT);
  if (vec == 1)
    return launch<HT, 1>(h, table, w, mask, nbr, out, R, F, D, block_rows,
                         block_cols, stream);
  if (vec == kVec && D % kVec == 0 &&
      reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch<HT, kVec>(h, table, w, mask, nbr, out, R, F, D, block_rows,
                            block_cols, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// h_dtype: 0 = float32, 1 = bfloat16; w is float32.  `table` may be null
// (spmm).  Returns the launch's cudaError_t; launches on `stream`, does not
// sync.
extern "C" int deal_spmm(const void* h, const int32_t* table, const float* w,
                         const uint8_t* mask, const int32_t* nbr, void* out,
                         long long R, int F, int D, int h_dtype, int vec,
                         int block_rows, int block_cols, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  if (block_rows < 1 || block_cols < 1 || block_rows * block_cols > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_dtype == 0)
    return launch_vec<float>(h, table, w, mask, nbr, out, R, F, D, vec,
                             block_rows, block_cols, s);
  if (h_dtype == 1)
    return launch_vec<__nv_bfloat16>(h, table, w, mask, nbr, out, R, F, D,
                                     vec, block_rows, block_cols, s);
  return cudaErrorInvalidValue;
}
