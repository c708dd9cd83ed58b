// Flash attention in f32 (online softmax over tiles of keys) for Hopper
// (sm_90a).
//
//   out[b,i,h,:] = sum_j p[i,j] * v[b,j,h/G,:]
//   p[i,:]       = softmax over the live j of (scale * q[b,i,h,:]) . k[b,j,h/G,:]
//
// q and k have head dim hd, v and out head dim vd, which may differ (MLA:
// hd 192, vd 128).
// A key j is live for query row i when j < Skv, j <= q_offset + i (causal),
// and q_offset + i - j < window (when a window is given).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention, and serves models/attention.py::flash_attention_jnp's GQA
// layout as well: q (B, Sq, H, hd), k (B, Skv, K, hd) and v (B, Skv, K, vd), each with its
// own strides and the last dimension contiguous.  Query head h reads kv head
// h / (H / K), as attention.py:89 splits H into (K, G).  The Pallas
// signature, (BH, S, hd), is the case H = K = 1.  Nothing is copied or
// padded: ragged Sq and Skv are masked here.
//
// Bound: operations.  At the prefill shape (B=4, S=2048, H=15, K=5, hd=64,
// causal) the live (i, j) pairs need 4 * hd flops each, 32.2 GFLOP, against
// 84 MB of q, k, v and out in f32: 0.48 ms at the f32 rate (67 TFLOP/s,
// outside the tensor cores: f32 stays full f32 in this port, no TF32)
// against 0.025 ms at the memory rate.  So the kernel is as fast as it
// keeps the FMA pipe fed, and the design is that of a SIMT SGEMM:
//
// - Register blocking.  A block of 16 x TY threads takes BM = TY * TM query
//   rows of one (batch, head) and walks tiles of BN = 16 * TN keys.  Thread
//   (ty, tx) owns rows ty*TM .. ty*TM+TM-1 and keys tx + 16 j (j < TN) of
//   the scores, so one 16-byte shared-memory load of k serves TM rows and
//   one of q serves TN keys: TM * TN * 4 FMAs per TM + TN loads (10.7 at
//   8 x 4), where a thread-a-row kernel gets 4.  For P . V it owns the
//   same rows and the columns 4 tx + 64 c (c < hd_pad / 64) of the f32
//   accumulator, in registers.  The 16 threads of a row are half a warp,
//   so the row's max and sum are xor shuffles over 1, 2, 4, 8.
// - Asynchronous copies.  q (once, then scaled in place) and the K and V
//   tiles are copied into shared memory with cp.async: 16-byte cp.async.cg
//   where the view's base and strides are 16-byte aligned, else 4-byte
//   cp.async.ca, the same arithmetic either way; rows past Skv (or Sq) and
//   columns past hd arrive as zeros (src-size 0).  One K and one V buffer:
//   the next tile's K is in flight during the softmax and P . V, the next
//   V during the next q . K (three barriers a tile), so each copy has half
//   a tile of compute to land,
//   at half the shared memory of double buffers (a third block on the SM
//   at hd <= 128).  Rows are kept
//   key-major with a pitch of hd_pad + 4 floats, so the 16 key rows a
//   half-warp reads at once fall on distinct banks.
// - P (the tile's probabilities) goes through shared memory, key-major,
//   to the P . V product; only the warp that wrote a row reads it.
// - Online softmax, once per key tile: the row's tile max (masked keys
//   -inf), m_new = max(m, tile max), corr = expf(m - m_new), p =
//   expf(s - m_new), l = l * corr + (the thread's p summed in key order),
//   acc *= corr.  l stays a per-thread partial and is summed over the 16
//   threads at the end (xor 1, 2, 4, 8).
// - Causal and window: tiles wholly outside every row's live range are
//   never copied or computed; only tiles that cross the diagonal, the
//   window's edge or Skv evaluate a mask.  The heaviest row tiles
//   (latest, under a causal mask) are launched first.
// - One kernel for every shape: a tile by max(hd, vd) (<= 64, <= 128,
//   <= 256; Tile64 / Tile128 / Tile256 below, mirrored by `simt_tiling` in
//   flash_attention.py), chosen by shape alone.  V and the accumulator
//   are as wide as the tile's q and k (VDP = HDP; a narrower vd is
//   zero-filled), except at hd > 128 with vd <= 128 (MLA), whose
//   Tile256v128 holds V and the accumulator at 128 columns: half the
//   accumulator's registers and V's shared memory.  They were picked on the
//   card by tools/flash_tiles.py among tiles with no register spills.
//   What bounds them now: a thread keeps its scores, accumulator and
//   fragments in about 168 registers, so an SM holds 12 warps (hd <= 128);
//   with so few, the shared-memory loads (one per 10.7 FMAs) and the
//   barriers around each tile are not hidden.
//
// Summation order, fixed by hd alone: each score is its hd products summed
// in d order (fmaf, from 0); the accumulator sums p * v over the keys of a
// tile in key order, tile after tile; l is 16 per-thread partials (each in
// key order) added by a fixed xor tree.  No atomics and no split of the
// keys over blocks, so the same inputs give the same bits on every run.
// A row with no live key at all (only a window or an offset can do that)
// comes out as the mean of v over all Skv keys, which is what a softmax
// over -1e30 fills gives.  The output is acc / max(l, 1e-30) in q's type.
// No fast math: expf and the division are IEEE.
//
// This kernel takes float32.  bfloat16 runs on the tensor cores, in
// flash_attention_sm90.cu, which takes the same arguments.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTX = 16;               // threads of a row group (half a warp)
constexpr size_t kSmemMax = 232448;   // 227 KB, a block's most
constexpr size_t kSmemSM = 233472;    // 228 KB, an SM's
constexpr float kNegInf = -INFINITY;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int B, H, K, Sq, Skv, hd, vd;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int causal, has_window;
  long long window, q_offset;
  float scale;
  int vq, vk, vv;                     // 16-byte copies allowed for q, k, v
};

// HDP: q and k's head dim padded (64, 128 or 256); TM x TN: a thread's rows
// x keys of the scores; TY: row groups of 16 threads; UD: 4-column steps of
// q . K unrolled together; UP: keys of P . V unrolled together; VDP: v's
// head dim padded (at most HDP).  One K and one V buffer: the next tile's K
// loads during the softmax and P . V, the next V during the next q . K.
template <int HDP_, int TM_, int TN_, int TY_, int UD_, int UP_,
          int VDP_ = HDP_>
struct Tile {
  static constexpr int HDP = HDP_, TM = TM_, TN = TN_, TY = TY_;
  static constexpr int UD = UD_, UP = UP_, VDP = VDP_;
  static constexpr int NT = kTX * TY;          // threads a block
  static constexpr int BM = TY * TM;           // query rows a block
  static constexpr int BN = kTX * TN;          // keys a tile
  static constexpr int TC = VDP / kTX;         // output columns a thread
  static constexpr int LD = HDP + 4;           // q, K row pitch (floats)
  static constexpr int LDV = VDP + 4;          // V row pitch (floats)
  static constexpr int LDP = BM + 4;           // P key pitch (floats)
  static constexpr int K_OFF = BM * LD;
  static constexpr int V_OFF = K_OFF + BN * LD;
  static constexpr int P_OFF = V_OFF + BN * LDV;
  static constexpr size_t SMEM = (size_t)(P_OFF + BN * LDP) * sizeof(float);
  // blocks an SM holds by shared memory (1 KB reserved a block), as many
  // as leave each thread 128 registers
  static constexpr int FIT = (int)(kSmemSM / (SMEM + 1024));
  static constexpr int RFIT = 512 / NT;
  static constexpr int MINB = FIT < 1 ? 1 : FIT > RFIT ? RFIT : FIT;
  static_assert(TM % 4 == 0 && HDP % 64 == 0 && HDP % (4 * UD) == 0 &&
                    VDP % 64 == 0 && VDP <= HDP && BN % UP == 0,
                "tile shape");
  static_assert(SMEM <= kSmemMax, "a block's shared memory");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [g0, g0 + ROWS) of a (rows, hd) view whose rows are `ld` floats
// apart, into dst (ROWS x W, pitch W + 4); rows at or past `lim` and
// columns past hd arrive as 0.  Consecutive threads take consecutive
// 16-byte chunks of a row.  `src` itself is a valid address for the zero
// fills.
template <class TL, int ROWS, int W = TL::HDP>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ld, long long g0,
                                      long long lim, int hd, bool vec) {
  constexpr int CH = W / 4;
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * CH; c += TL::NT) {
    const int r = c / CH, d = (c % CH) * 4;
    const long long g = g0 + r;
    const bool row_ok = g < lim;
    const float* from = src + (row_ok ? g * ld + d : 0);
    float* to = dst + r * (W + 4) + d;
    if (vec) {
      const bool ok = row_ok && d < hd;
      cp_async16(to, ok ? from : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && d + e < hd;
        cp_async4(to + e, ok ? from + e : src, ok);
      }
    }
  }
}

template <class TL>
__global__ void __launch_bounds__(TL::NT, TL::MINB)
flash_kernel(const Args a) {
  constexpr int TM = TL::TM, TN = TL::TN, TC = TL::TC, BM = TL::BM;
  constexpr int BN = TL::BN, LD = TL::LD, LDP = TL::LDP, HDP = TL::HDP;
  constexpr int VDP = TL::VDP, LDV = TL::LDV;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + TL::K_OFF;          // BN x LD
  float* Vs = Qs + TL::V_OFF;
  float* Ps = Qs + TL::P_OFF;          // BN x LDP, key-major

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.K);
  // heaviest (latest, under a causal mask) tiles of rows first
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const float* qb = a.q + b * a.sqb + h * a.sqh;
  const float* kb = a.k + b * a.skb + kh * a.skh;
  const float* vb = a.v + b * a.svb + kh * a.svh;

  // keys that any row of this block can see
  const int r_last = min(r0 + BM, a.Sq) - 1;
  long long kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, a.q_offset + r_last + 1);
  long long kv_begin = 0;
  if (a.has_window) kv_begin = max(0LL, a.q_offset + r0 - a.window + 1);
  const long long t_begin = kv_begin / BN * BN;
  const int n_tiles =
      kv_end > t_begin ? (int)((kv_end - t_begin + BN - 1) / BN) : 0;

  // cp.async groups: q with the first K, then the first V; then each
  // tile's next K, then its next V
  stage<TL, BM>(Qs, qb, a.sqs, r0, a.Sq, a.hd, a.vq);
  if (n_tiles > 0) stage<TL, BN>(Ks, kb, a.sks, t_begin, a.Skv, a.hd, a.vk);
  cp_commit();
  if (n_tiles > 0)
    stage<TL, BN, VDP>(Vs, vb, a.svs, t_begin, a.Skv, a.vd, a.vv);
  cp_commit();
  cp_wait_one();                       // q and the first K have landed
  __syncthreads();
  for (int i = tid; i < BM * HDP; i += TL::NT) {
    float* p = Qs + (i / HDP) * LD + i % HDP;
    *p = *p * a.scale;                 // read again after the loop's barrier
  }

  float acc[TM][TC], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.0f;
  }
  const long long qpos0 = a.q_offset + r0 + ty * TM;   // row ty*TM's position

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const long long t0 = t_begin + (long long)t * BN;
    cp_wait_one();                     // this tile's K has landed
    __syncthreads();

    // scores: TM rows x TN keys, each summed in d order
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
    const float* qrow = Qs + ty * TM * LD;
    const float* krow = Ks + tx * LD;
#pragma unroll 1
    for (int d0 = 0; d0 < HDP; d0 += 4 * TL::UD) {
#pragma unroll
      for (int u = 0; u < TL::UD; ++u) {
        const int d = d0 + 4 * u;
        float4 kv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          kv[j] = *reinterpret_cast<const float4*>(krow + j * kTX * LD + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + i * LD + d);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
    }
    cp_wait_all();                     // this tile's V has landed
    __syncthreads();                   // K is free: the next K in flight
    if (t + 1 < n_tiles)
      stage<TL, BN>(Ks, kb, a.sks, t0 + BN, a.Skv, a.hd, a.vk);
    cp_commit();

    // the mask, only on a tile that crosses Skv, the diagonal or the window
    const bool edge =
        t0 + BN > a.Skv || (a.causal && t0 + BN - 1 > a.q_offset + r0) ||
        (a.has_window && a.q_offset + r_last - t0 >= a.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long qp = qpos0 + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const long long kv = t0 + tx + kTX * j;
          const bool live = kv < a.Skv && (!a.causal || kv <= qp) &&
                            (!a.has_window || qp - kv < a.window);
          if (!live) s[i][j] = kNegInf;
        }
      }
    }

    // online softmax, once a tile
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mt = s[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mt = fmaxf(mt, s[i][j]);
#pragma unroll
      for (int o = 1; o < kTX; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
      const float mn = fmaxf(m[i], mt);
      const bool any = mn != kNegInf;  // a live key so far
      const float corr = any ? expf(m[i] - mn) : 1.0f;
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = any ? expf(s[i][j] - mn) : 0.0f;
        ps += s[i][j];
      }
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] *= corr;
    }
    // P, key-major: a thread's TM rows of key tx + 16 j as 16-byte stores
#pragma unroll
    for (int j = 0; j < TN; ++j) {
#pragma unroll
      for (int i = 0; i < TM; i += 4)
        *reinterpret_cast<float4*>(Ps + (tx + kTX * j) * LDP + ty * TM + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    }
    __syncwarp();                      // a row's P is its own warp's

    // acc += P . V over the tile's keys in order
    const float* prow = Ps + ty * TM;
    const float* vrow = Vs + tx * 4;
#pragma unroll 1
    for (int k0 = 0; k0 < BN; k0 += TL::UP) {
#pragma unroll
     for (int ku = 0; ku < TL::UP; ++ku) {
      const int kk = k0 + ku;
      float4 p[TM / 4], vv[TC / 4];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(prow + kk * LDP + 4 * i);
#pragma unroll
      for (int c = 0; c < TC / 4; ++c)
        vv[c] = *reinterpret_cast<const float4*>(vrow + kk * LDV + 64 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 pi = p[i / 4];
        const float pv = (i % 4 == 0) ? pi.x : (i % 4 == 1) ? pi.y
                         : (i % 4 == 2) ? pi.z : pi.w;
#pragma unroll
        for (int c = 0; c < TC / 4; ++c) {
          acc[i][4 * c] = fmaf(pv, vv[c].x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(pv, vv[c].y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pv, vv[c].z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pv, vv[c].w, acc[i][4 * c + 3]);
        }
      }
     }
    }
    __syncthreads();                   // V and P are free: the next V
    if (t + 1 < n_tiles)
      stage<TL, BN, VDP>(Vs, vb, a.svs, t0 + BN, a.Skv, a.vd, a.vv);
    cp_commit();
  }

  // out = acc / max(l, 1e-30); no live key at all: the mean of v
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o = 1; o < kTX; o <<= 1) lt += __shfl_xor_sync(kFull, lt, o);
    const int row = r0 + ty * TM + i;
    if (row >= a.Sq) continue;
    float* orow = a.out + (((long long)b * a.Sq + row) * a.H + h) * a.vd;
    if (m[i] == kNegInf) {
      for (int c = 0; c < TC; ++c) {
        const int d = 4 * tx + 64 * (c / 4) + c % 4;
        if (d >= a.vd) continue;
        float sum = 0.0f;
        for (long long kv = 0; kv < a.Skv; ++kv) sum += vb[kv * a.svs + d];
        orow[d] = sum / (float)a.Skv;
      }
      continue;
    }
    const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int c = 0; c < TC / 4; ++c) {
      const int d = 4 * tx + 64 * c;
      const float4 o = make_float4(acc[i][4 * c] / denom,
                                   acc[i][4 * c + 1] / denom,
                                   acc[i][4 * c + 2] / denom,
                                   acc[i][4 * c + 3] / denom);
      if (d + 3 < a.vd && a.vd % 4 == 0) {
        *reinterpret_cast<float4*>(orow + d) = o;
      } else {
        if (d < a.vd) orow[d] = o.x;
        if (d + 1 < a.vd) orow[d + 1] = o.y;
        if (d + 2 < a.vd) orow[d + 2] = o.z;
        if (d + 3 < a.vd) orow[d + 3] = o.w;
      }
    }
  }
}

// the variant each head dim takes (simt_tiling in flash_attention.py
// mirrors it): rows and keys a tile, threads, shared memory
using Tile64 = Tile<64, 8, 4, 8, 1, 4>;
using Tile128 = Tile<128, 8, 2, 8, 1, 1>;
using Tile256 = Tile<256, 4, 4, 16, 2, 4>;
using Tile256v128 = Tile<256, 4, 4, 16, 2, 4, 128>;    // MLA: vd <= 128

template <class TL>
cudaError_t run(const Args& a, cudaStream_t s) {
  auto kern = flash_kernel<TL>;
  if (TL::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Sq + TL::BM - 1) /
                                                    TL::BM));
  kern<<<grid, TL::NT, TL::SMEM, s>>>(a);
  return cudaGetLastError();
}

// the tile's width: max(hd, vd)
int rows_for(int w) {
  return w <= 64 ? Tile64::BM : w <= 128 ? Tile128::BM : Tile256::BM;
}

// a view may take 16-byte copies when its base and every stride it steps
// along (a dimension of size 1 is never stepped) are 16-byte multiples
bool vec16(const void* p, int hd, long long n0, long long s0, long long n1,
           long long s1, long long n2, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && hd % 4 == 0 &&
         (n0 < 2 || s0 % 4 == 0) && (n1 < 2 || s1 % 4 == 0) &&
         (n2 < 2 || s2 % 4 == 0);
}

// the checks and the argument block the C entry shares with the tile
// sweep (tools/flash_tiles.cu); returns a cudaError_t, 0 when `a` is set
int make_args(Args* a, const void* q, const void* k, const void* v,
              void* out, int B, int H, int K, int Sq, int Skv, int hd,
              int vd, long long sqb, long long sqs, long long sqh, long long skb,
              long long sks, long long skh, long long svb, long long svs,
              long long svh, int causal, int has_window, long long window,
              long long q_offset, float scale, int dtype, int rows) {
  if (dtype != 0 || H < 1 || K < 1 || H % K != 0 || Skv < 1 || hd < 1 ||
      hd > 256 || vd < 1 || vd > 256 || (long long)B * H > 0x7fffffffLL ||
      (Sq + rows - 1) / rows > 65535)
    return cudaErrorInvalidValue;
  *a = Args{static_cast<const float*>(q),
            static_cast<const float*>(k),
            static_cast<const float*>(v),
            static_cast<float*>(out),
            B, H, K, Sq, Skv, hd, vd,
            sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
            causal, has_window, window, q_offset, scale,
            vec16(q, hd, B, sqb, Sq, sqs, H, sqh),
            vec16(k, hd, B, skb, Skv, sks, K, skh),
            vec16(v, vd, B, svb, Skv, svs, K, svh)};
  return 0;
}

}  // namespace

// dtype code: 0 = float32 (q, k, v and out share it).  hd is q and k's head
// dim, vd v's and out's.  Strides are in elements; the head dimension of
// each tensor is contiguous, and out is a contiguous (B, Sq, H, vd).
// window is read only when has_window != 0.  Returns the launch's
// cudaError_t.
extern "C" int deal_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int Sq, int Skv, int hd, int vd, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, int causal, int has_window,
    long long window, long long q_offset, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  Args a;
  const int w = hd > vd ? hd : vd;
  const int err = make_args(&a, q, k, v, out, B, H, K, Sq, Skv, hd, vd, sqb,
                            sqs, sqh, skb, sks, skh, svb, svs, svh, causal,
                            has_window, window, q_offset, scale, dtype,
                            rows_for(w));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w <= 64) return run<Tile64>(a, s);
  if (w <= 128) return run<Tile128>(a, s);
  if (vd <= 128) return run<Tile256v128>(a, s);
  return run<Tile256>(a, s);
}
