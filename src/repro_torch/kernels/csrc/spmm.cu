// Fanout-gather SPMM for Hopper (sm_90a), with an optional fused id table
// and optional per-head weights; and, at the end, the mean-aggregation
// weights it reads in GraphSAGE and GCN, built from the mask on the card.
//
//   out[i, c] = sum_f  coef(w[i,f,hd(c)] * mask[i,f]) * h[idx(i,f), c]
//   idx(i,f)  = nbr[i,f]                 (spmm)
//             = table[nbr[i,f]]          (gather_spmm)
//   hd(c)     = c / (D / heads)          (w is (R, F) when heads == 1)
//
// Replaces the Pallas TPU kernels src/repro/kernels/spmm.py::spmm and
// src/repro/kernels/gather_spmm.py::gather_spmm.  With heads > 1 one launch
// computes what GAT's attend ran as one launch per head (repro's
// PallasExecutor.attend): head k's weights on h's k-th block of D / heads
// columns, each output element the same sum in the same order.  w is read
// through its strides (row, slot, head), so a transposed softmax view is
// not copied.
//
// Numerics, as the TPU kernel's: the coefficient is w * mask in f32,
// rounded to h's dtype; each output element is an f32 sum over f in order,
// starting at +0.0, with __fmul_rn / __fadd_rn (no contraction into FMA);
// the sum is cast back to h's dtype.  A row's result depends on no other
// row, and on no tiling.
//
// Masked slots are skipped, where the TPU kernel adds 0.0 * row.  For a
// finite row that gives the same bits: 0.0 * row is +0.0 or -0.0, and
// acc + (+-0.0) == acc for every acc other than -0.0.  The accumulator is
// never -0.0: it starts at +0.0, and under round-to-nearest a sum is -0.0
// only when both addends are -0.0 (an exact cancellation gives +0.0, and
// there is no flush to zero here).  The one difference: a masked slot whose
// row or weight holds Inf or NaN no longer turns the output into NaN, as
// the TPU kernel's 0.0 * Inf does.  Masked ids must still be in range.
//
// Bound: bytes.  Each live slot gathers one row of h (D * 4 bytes in f32)
// from a random place for 2 * D flops, about 100x below the ridge point, so
// tensor cores are of no use.  The bytes that set the time are device
// memory's: the output (R * D, written once), nbr / mask / w, and the
// gathered rows that miss L2 (h is 537 MB at the main path's shape, L2 50
// MB).  Design: a 2-D block, threadIdx.x over a row's 16-byte chunks
// (neighbouring threads on neighbouring addresses, so a gathered row is one
// coalesced read), threadIdx.y over rows.  A thread walks its row's slots
// in f order, loading each slot's nbr, mask and weight together, and
// gathers h's chunk only for a live slot: a masked slot's row is never
// read, and a row with no live slot gathers nothing and writes its zeros.
// The output goes out with streaming (evict-first) stores, and nbr, mask
// and w are loaded under an evict-first L2 policy, so neither pushes the
// gathered rows out of L2.  About 30 registers a thread: 64 warps an SM
// keep the gathers in flight.  Slower on the card (tools/spmm_designs.py
// times them; PERF.md, findings): a warp serving 32 / F rows with a ballot
// of the live slots, its live rows copied into shared memory with Hopper's
// bulk asynchronous copy in a two-stage pipeline, or every live chunk
// loaded into registers before any sum.  Chunks are 16 bytes (4 f32, 8
// bf16) where the head width allows it, else one element; rows whose base
// is not 16-byte aligned take narrow loads of the same chunks.  Every
// output element is the same sum in the same order whatever the chunk
// width, the alignment or the tiling, so the output is bitwise the same
// across all of them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;      // threads a block

struct Args {
  const void* h;             // (N, D) rows, contiguous
  const int32_t* table;      // (N,) id map, or null
  const float* w;            // (R, F[, heads]) read through its strides
  long long swr, swf, swh;   // w's strides in elements (swh unused at 1 head)
  const uint8_t* mask;       // (R, F)
  const int32_t* nbr;        // (R, F)
  void* out;                 // (R, D), contiguous
  long long R;
  int F, D, heads;
  bool vec;                  // 16-byte loads and stores
};

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// V consecutive elements of a row: one 16-byte load where `vec` says the
// addresses allow it, else V narrow loads of the same elements
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
  __device__ __forceinline__ void load(const T* __restrict__ p, bool vec) {
    if constexpr (sizeof(T) * V == 16) {
      if (vec) {
        *reinterpret_cast<uint4*>(v) =
            __ldg(reinterpret_cast<const uint4*>(p));
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __ldg(p + j);
  }
  __device__ __forceinline__ void store(T* p, bool vec) const {
    if constexpr (sizeof(T) * V == 16) {
      if (vec) {                         // streaming: evict first
        __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(v));
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
};

// Loads of what a launch reads once (nbr, mask, w): L2 evicts them first,
// so the gathered rows of h stay in it longer
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ int32_t load_once(const int32_t* p, uint64_t pol) {
  int32_t x;
  asm volatile("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
               : "=r"(x) : "l"(p), "l"(pol));
  return x;
}
__device__ __forceinline__ float load_once(const float* p, uint64_t pol) {
  float x;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(x) : "l"(p), "l"(pol));
  return x;
}
__device__ __forceinline__ bool load_once(const uint8_t* p, uint64_t pol) {
  unsigned short x;
  asm volatile("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;"
               : "=h"(x) : "l"(p), "l"(pol));
  return x != 0;
}

// write a chunk's sum as h's dtype
template <typename T, int V>
__device__ __forceinline__ void put(const Args& a, long long row, int c,
                                    const float (&acc)[V]) {
  Chunk<T, V> y;
#pragma unroll
  for (int e = 0; e < V; ++e) from_f32(acc[e], &y.v[e]);
  y.store(static_cast<T*>(a.out) + row * a.D + c * V, a.vec);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
spmm_kernel(const Args a) {
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;     // the chunk
  const int NC = a.D / V;
  if (r >= a.R || c >= NC) return;
  const T* h = static_cast<const T*>(a.h);
  const long long e0 = r * a.F;
  const float* wr = a.w + r * a.swr + (long long)(c / (NC / a.heads)) * a.swh;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  const uint64_t once = evict_first();
  for (int f = 0; f < a.F; ++f) {        // nbr, mask and weight together
    int id = load_once(a.nbr + e0 + f, once);
    const bool live = load_once(a.mask + e0 + f, once);
    const float w = load_once(wr + (long long)f * a.swf, once);
    if (live) {                          // the gather: live slots only
      if (a.table != nullptr) id = __ldg(a.table + id);
      Chunk<T, V> x;
      x.load(h + (long long)id * a.D + c * V, a.vec);
      const float coef = round_to(w, h);  // w * 1.0: a live slot
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(coef, to_f32(x.v[e])));
    }
  }
  put<T, V>(a, r, c, acc);
}

template <typename T, int V>
cudaError_t go(const Args& a, int block_rows, int block_cols,
               cudaStream_t s) {
  const long long nc = a.D / V;
  const dim3 grid((unsigned)((a.R + block_rows - 1) / block_rows),
                  (unsigned)((nc + block_cols - 1) / block_cols));
  spmm_kernel<T, V><<<grid, dim3(block_cols, block_rows), 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(Args a, int block_rows, int block_cols, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = (a.D / a.heads) % kVec == 0;   // chunks within a head
  a.vec = wide && reinterpret_cast<uintptr_t>(a.h) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  return wide ? go<T, kVec>(a, block_rows, block_cols, s)
              : go<T, 1>(a, block_rows, block_cols, s);
}

// ---------------------------------------------------------------------------
// Mean-aggregation weights of a fanout mask, on the card where the mask is:
//
//   w[r, f] = mask[r, f] / max(sum_f' mask[r, f'], 1)       (R, F) float32
//
// Replaces no TPU kernel.  The JAX package builds these weights with numpy
// on the host (core.gnn_models.mean_weights), and so did the port, which
// then copied them, pageable, to the card that already held the mask: at
// 2^23 rows and fanout 25, a float64 intermediate of 1.6 GB and a copy of
// 0.84 GB for every layer graph of every epoch.  This kernel replaces that.
//
// Numerics, numpy's: 1 / deg divided in f64 (IEEE, round to nearest) and
// rounded to f32, a masked slot +0.0, so the weights are bitwise numpy's.
//
// Bound: bytes.  A launch reads R * F mask bytes and writes R * F * 4 weight
// bytes, with a few operations a slot: at 3.35 TB/s, 0.313 ms at 2^23 x 25
// and 0.125 ms at 2^23 x 10.  Design: a block takes a tile of whole rows
// (tile_rows, chosen by the wrapper to hold about 8 KiB of slots: a
// multiple of 16, so that every tile's mask bytes start 16-byte aligned
// where the mask does, at any fanout up to 512), whose mask bytes are
// contiguous.  It copies them into shared memory with 16-byte coalesced
// loads (byte loads at an unaligned base and at the ragged end), under a
// streaming cache hint: each byte is read once.
// A thread a row counts the row's live slots there and stores 1 / deg.  The
// tile's weights are contiguous too: a thread writes four slots as one
// 16-byte streaming store, their mask bytes one 32-bit shared load, so a
// warp writes 512 contiguous bytes an instruction.  (A thread a row writing
// its F floats would write 32 rows' scattered pieces an instruction, and
// waste most of each sector.)  One integer division a store finds the
// first slot's row.  The tile's output starts 16-byte aligned: the wrapper
// allocates it, and a tile starts at a row that is a multiple of 4.

constexpr int kMwThreads = 256;
constexpr size_t kMwMaxShared = 48 * 1024;   // without an opt-in attribute

__global__ void __launch_bounds__(kMwThreads)
mean_weights_kernel(const uint8_t* __restrict__ mask, float* __restrict__ out,
                    long long R, int F, int tile_rows) {
  extern __shared__ __align__(16) uint8_t tile[];
  float* inv = reinterpret_cast<float*>(
      tile + (((size_t)tile_rows * F + 15) & ~(size_t)15));
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)min((long long)tile_rows, R - r0);
  const int n = rows * F;                      // the tile's slots
  const uint8_t* m = mask + r0 * F;
  float* o = out + r0 * F;

  int copied = 0;                              // the mask's bytes, shared
  if ((reinterpret_cast<uintptr_t>(m) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(m);
    uint4* dst = reinterpret_cast<uint4*>(tile);
    for (int i = threadIdx.x; i < n >> 4; i += blockDim.x)
      dst[i] = __ldcs(src + i);
    copied = n & ~15;
  }
  for (int i = copied + threadIdx.x; i < n; i += blockDim.x)
    tile[i] = __ldcs(m + i);
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const uint8_t* row = tile + r * F;
    int deg = 0;
    for (int f = 0; f < F; ++f) deg += row[f] != 0;
    inv[r] = __double2float_rn(1.0 / (double)max(deg, 1));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n >> 2; i += blockDim.x) {
    const int e = i << 2;
    const uint32_t live = *reinterpret_cast<const uint32_t*>(tile + e);
    int r = e / F, f = e - r * F;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = (live >> (8 * j)) & 0xff ? inv[r] : 0.0f;
      if (++f == F) { f = 0; ++r; }
    }
    __stcs(reinterpret_cast<float4*>(o) + i,
           make_float4(v[0], v[1], v[2], v[3]));
  }
  for (int e = (n & ~3) + threadIdx.x; e < n; e += blockDim.x)
    o[e] = tile[e] ? inv[e / F] : 0.0f;
}

}  // namespace

// mask (R, F) bool, contiguous; out (R, F) float32, contiguous and 16-byte
// aligned.  tile_rows rows a block, a positive multiple of 4 whose tile
// (mask bytes and one float a row) fits 48 KiB of shared memory.  Returns
// the launch's cudaError_t; launches on `stream`, does not sync.
extern "C" int deal_mean_weights(const uint8_t* mask, float* out, long long R,
                                 int F, int tile_rows, void* stream) {
  if (R <= 0 || F <= 0) return 0;
  const size_t shared = (((size_t)tile_rows * F + 15) & ~(size_t)15) +
                        (size_t)tile_rows * sizeof(float);
  if (tile_rows < 4 || tile_rows % 4 != 0 || shared > kMwMaxShared ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long grid = (R + tile_rows - 1) / tile_rows;
  mean_weights_kernel<<<(unsigned)grid, kMwThreads, shared,
                        static_cast<cudaStream_t>(stream)>>>(mask, out, R, F,
                                                             tile_rows);
  return cudaGetLastError();
}

// h_dtype: 0 = float32, 1 = bfloat16; w is float32, (R, F) with heads = 1
// or (R, F, heads), strides (swr, swf, swh) in elements.  `table` may be
// null (spmm).  block_rows x block_cols threads a block (rows, and chunks
// of a row), at most 1024.  Returns the launch's cudaError_t; launches on
// `stream`, does not sync.
extern "C" int deal_spmm(const void* h, const int32_t* table, const float* w,
                         long long swr, long long swf, long long swh,
                         const uint8_t* mask, const int32_t* nbr, void* out,
                         long long R, int F, int D, int heads, int h_dtype,
                         int block_rows, int block_cols, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  if (F < 0 || heads < 1 || D % heads != 0 || block_rows < 1 ||
      block_cols < 1 || block_rows * block_cols > kMaxThreads)
    return cudaErrorInvalidValue;
  const Args a{h, table, w, swr, swf, swh, mask, nbr, out, R, F, D, heads,
               false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_dtype == 0) return launch<float>(a, block_rows, block_cols, s);
  if (h_dtype == 1)
    return launch<__nv_bfloat16>(a, block_rows, block_cols, s);
  return cudaErrorInvalidValue;
}
