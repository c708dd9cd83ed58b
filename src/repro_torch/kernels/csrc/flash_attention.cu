// Flash attention (online softmax over tiles of keys) for Hopper (sm_90a).
//
//   out[b,i,h,:] = sum_j p[i,j] * v[b,j,h/G,:]
//   p[i,:]       = softmax over the live j of (scale * q[b,i,h,:]) . k[b,j,h/G,:]
//
// A key j is live for query row i when j < Skv, j <= q_offset + i (causal),
// and q_offset + i - j < window (when a window is given).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention, and serves models/attention.py::flash_attention_jnp's GQA
// layout as well: q (B, Sq, H, hd), k and v (B, Skv, K, hd), each with its
// own strides and the last dimension contiguous.  Query head h reads kv head
// h / (H / K), as attention.py:89 splits H into (K, G).  The Pallas
// signature, (BH, S, hd), is the case H = K = 1.  Nothing is copied or
// padded: ragged Sq and Skv are masked here.
//
// Bound: operations.  At the prefill shape (B=4, S=2048, H=15, K=5, hd=64,
// causal) the live (i, j) pairs need 4 * hd flops each, 32.2 GFLOP, against
// 84 MB of q, k, v and out in f32: 0.48 ms at the f32 rate against 0.025 ms
// at the memory rate.  This first version does the math in f32 FMAs outside
// the tensor cores.  Design: one block of 128 threads per (batch, head, tile
// of query rows).  One thread holds one query row for hd <= 64; two (hd <=
// 128) or four (hd <= 256) threads share a row, each with every second or
// fourth 4-wide group of it.  q * scale and the f32 accumulator stay in
// registers.  The block stages 32 keys (16 when hd > 128) and their values
// at a time in shared memory as f32 (zero past Skv and past hd), and every
// thread reads them as 16-byte broadcasts.  Scores are formed 16 keys
// at a time; for each such chunk the running max m, sum l and accumulator
// are rescaled by expf(m_old - m_new), as the TPU kernel does per key block.
// Tiles that lie wholly above the causal diagonal, or before the window, of
// every row of the block are skipped: once a row has seen a live key, a
// masked key adds exp(-1e30 - m) = 0 there, so the result is the same.  A
// row with no live key at all (only a window or an offset can do that) comes
// out as the mean of v over all Skv keys, which is what a softmax over -1e30
// fills gives.  The output is acc / max(l, 1e-30) in q's type.  No fast math:
// expf and the division are IEEE.
//
// This kernel takes float32.  bfloat16 runs on the tensor cores, in
// flash_attention_sm90.cu, which takes the same arguments.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;   // per block
constexpr int kChunk = 16;      // keys scored per online-softmax update
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, H, K, Sq, Skv, hd;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int causal, has_window;
  long long window, q_offset;
  float scale;
};

// DS: dims held per thread; TPR: threads per query row, hd <= DS * TPR;
// TK: keys staged in shared memory at a time (2 * TK * DS * TPR floats).
template <typename T, int DS, int TPR, int TK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int HDP = DS * TPR;          // padded head dim in shared memory
  constexpr int NG = DS / 4;             // 4-wide groups per thread
  constexpr int BQ = kThreads / TPR;     // query rows per block
  __shared__ __align__(16) float Ks[TK * HDP];
  __shared__ __align__(16) float Vs[TK * HDP];

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.K);
  // heaviest (latest, under a causal mask) tiles of rows first
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int row = r0 + tid / TPR, sub = tid % TPR;
  const bool row_ok = row < a.Sq;
  const long long qpos = a.q_offset + row;

  const T* qrow = static_cast<const T*>(a.q) + b * a.sqb + (long long)row * a.sqs
                  + h * a.sqh;
  const T* kb = static_cast<const T*>(a.k) + b * a.skb + kh * a.skh;
  const T* vb = static_cast<const T*>(a.v) + b * a.svb + kh * a.svh;

  float qr[DS], acc[DS];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (sub + TPR * i) + e;
      qr[4 * i + e] = (row_ok && d < a.hd) ? to_f32(qrow[d]) * a.scale : 0.0f;
      acc[4 * i + e] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;
  bool seen = false;

  // keys that any row of this block can see
  const int r_last = min(r0 + BQ, a.Sq) - 1;
  long long kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, a.q_offset + r_last + 1);
  long long kv_begin = 0;
  if (a.has_window) kv_begin = max(0LL, a.q_offset + r0 - a.window + 1);
  const long long t_begin = (kv_begin / TK) * TK;

  for (long long t0 = t_begin; t0 < kv_end; t0 += TK) {
    for (int idx = tid; idx < TK * HDP; idx += kThreads) {
      const int j = idx / HDP, d = idx % HDP;
      const long long kv = t0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kv < a.Skv && d < a.hd) {
        kx = to_f32(kb[kv * a.sks + d]);
        vx = to_f32(vb[kv * a.svs + d]);
      }
      Ks[idx] = kx;
      Vs[idx] = vx;
    }
    __syncthreads();
    const float4* K4 = reinterpret_cast<const float4*>(Ks);
    const float4* V4 = reinterpret_cast<const float4*>(Vs);
#pragma unroll 1
    for (int c = 0; c < TK; c += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kk = K4[(c + j) * (HDP / 4) + sub + TPR * i];
          s[j] = fmaf(qr[4 * i], kk.x, s[j]);
          s[j] = fmaf(qr[4 * i + 1], kk.y, s[j]);
          s[j] = fmaf(qr[4 * i + 2], kk.z, s[j]);
          s[j] = fmaf(qr[4 * i + 3], kk.w, s[j]);
        }
      }
      // the row's threads sum their parts; each ends with the same bits
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          s[j] += __shfl_xor_sync(kFull, s[j], o);
      }
      float mc = m;
      unsigned live = 0;                 // bit j: key c + j is live
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const long long kv = t0 + c + j;
        if (row_ok && kv < a.Skv && (!a.causal || kv <= qpos)
            && (!a.has_window || qpos - kv < a.window)) {
          mc = fmaxf(mc, s[j]);
          live |= 1u << j;
        }
      }
      if (!live) continue;               // nothing live for this row here
      const float corr = expf(m - mc);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = ((live >> j) & 1u) ? expf(s[j] - mc) : 0.0f;
        psum += s[j];
      }
      l = l * corr + psum;
      m = mc;
      seen = true;
#pragma unroll
      for (int i = 0; i < DS; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const float4 vv = V4[(c + j) * (HDP / 4) + sub + TPR * i];
          acc[4 * i] = fmaf(s[j], vv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
        }
      }
    }
    __syncthreads();
  }
  if (!row_ok) return;

  T* orow = static_cast<T*>(a.out) + (((long long)b * a.Sq + row) * a.H + h) * a.hd;
  if (!seen) {                           // no live key: uniform softmax
#pragma unroll
    for (int i = 0; i < NG; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (sub + TPR * i) + e;
        if (d >= a.hd) continue;
        float sum = 0.0f;
        for (long long kv = 0; kv < a.Skv; ++kv)
          sum += to_f32(vb[kv * a.svs + d]);
        store(orow + d, sum / (float)a.Skv);
      }
    }
    return;
  }
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NG; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (sub + TPR * i) + e;
      if (d < a.hd) store(orow + d, acc[4 * i + e] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const dim3 block(kThreads);
  auto grid = [&](int tpr) {
    const int bq = kThreads / tpr;
    return dim3((unsigned)(a.B * a.H), (unsigned)((a.Sq + bq - 1) / bq));
  };
  if (a.hd <= 64)
    flash_kernel<T, 64, 1, 32><<<grid(1), block, 0, s>>>(a);
  else if (a.hd <= 128)
    flash_kernel<T, 64, 2, 32><<<grid(2), block, 0, s>>>(a);
  else
    flash_kernel<T, 64, 4, 16><<<grid(4), block, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32 (q, k, v and out share it).  Strides
// are in elements; the head dimension of each tensor is contiguous, and out
// is a contiguous (B, Sq, H, hd).  window is read only when has_window != 0.
// Returns the launch's cudaError_t.
extern "C" int deal_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int Sq, int Skv, int hd, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, int causal, int has_window,
    long long window, long long q_offset, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (H < 1 || K < 1 || H % K != 0 || Skv < 1 || hd < 1 || hd > 256
      || (long long)B * H > 0x7fffffffLL || (Sq + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  const Args a{q,   k,   v,   out, B,   H,   K,      Sq,         Skv,
               hd,  sqb, sqs, sqh, skb, sks, skh,    svb,        svs,
               svh, causal, has_window, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  return cudaErrorInvalidValue;
}
