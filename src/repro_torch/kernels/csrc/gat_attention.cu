// GAT edge attention and SDDMM over fixed-fanout neighbour matrices, for
// Hopper (sm_90a).
//
//   gat_attention: alpha[i,f,h] = softmax_f(<q_h[i], k_h[nbr[i,f]]> / sqrt(dh))
//                  with masked slots filled with -1e30 before the softmax and
//                  0 after it; out (N, F, heads) f32.
//   sddmm:         e[i,f] = <q[i], k[nbr[i,f]]> for a live slot, 0 for a
//                  masked one; out (N, F) f32.  q and k may be row-strided
//                  views (ldq, ldk elements between rows).
//
// Replace the Pallas TPU kernels src/repro/kernels/gat_attention.py::
// gat_attention and src/repro/kernels/sddmm.py::sddmm.  sddmm is the scoring
// half of gat_attention with one head, no scale and no softmax; both are
// `scores_kernel` below.
//
// Bound: bytes, by way of latency.  Each live slot gathers one row of k
// (D * 4 bytes in f32) from a random place for 2 * D flops, so the kernel
// is as fast as it keeps gathers in flight.  Design: one warp serves
// 32 / F2 rows at once (F2: F rounded up to a power of two), in five steps.
//   1. Lane s = row * F2 + f reads nbr and mask of slot f (F <= 32); a
//      ballot gives the live set.  A group of rows with no live slot writes
//      its zeros and gathers nothing, and no row without a live slot has
//      its q row read.
//   2. The live slots' k rows are cut into chunks of V columns (V = 4 in
//      f32, 8 in bf16: one 16-byte load a lane) and the (live slot, chunk)
//      pairs dealt round the warp, up to IT a lane.  Every lane issues all
//      its loads back to back into registers before it uses any, then the
//      q rows go to shared memory as f32, so q's and k's latency overlap.
//      A masked slot has no pair: its k row is never read.
//   3. Each pair's partial: its V products summed in column order, kept in
//      shared memory.
//   4. The dot of a live slot and head h: h's chunk partials summed in
//      chunk order, for every head at once (lane per (slot, head) pair).
//   5. gat_attention: the softmax over f on all 32 x heads (slot, head)
//      pairs, heads passes of the warp: divide by sqrtf(dh), -1e30 for a
//      masked slot, max and sum by xor shuffles across the lanes of one
//      row's head, max-subtracted expf, divide.  A pass whose slots are
//      all masked only writes its zeros.  Nothing of the score tensor
//      reaches device memory.
// Summation order depends on (D, heads, F, dtype) alone: V is 4 or 8 where
// the head width dh allows it, else 1; a view whose base or row stride is
// not 16-byte aligned takes narrow loads in the same lane-to-column mapping
// and the same order; a row's result depends on no other row of its group
// or launch.  f32 accumulation, __f*_rn arithmetic, no fast math, no
// atomics.
//
// Masked slots: gat_attention writes exactly 0 there, and an all-masked row
// comes out all 0 (JAX: uniform 1/F, then times 0).  sddmm writes +0.0
// where the TPU kernel's dot * 0.0 gives -0.0 for a negative dot; the two
// compare equal.  A masked slot's k row is never read, so an Inf or NaN
// there does not reach the output (the TPU kernel's 0 * Inf gives NaN).
//
// Shapes: scores_kernel takes F <= 32 (a lane a slot), heads a power of
// two up to 32 (a lane's pair holds one head), one warp's shared memory
// within a block's 227 KB.  Every other shape with heads dividing D goes
// to `wide_kernel`, chosen by shape alone (`kernel_for` in
// gat_attention.py makes the same choice), so a row's bits depend on (D,
// heads, F, dtype) and on no other row.  It is bound by the same gathers
// and by instruction issue: each (slot, head) dot is a serial sum that
// must stay in column order, and the softmax pays an IEEE expf and divide
// per live score.  Design: a warp serves RW = 32 / F2 rows (F2: F rounded
// up to a power of two, 32 for F > 32, so RW = 1 there), in four steps.
//   1. The mask and nbr of a window of two passes of 32 slots (lane l: row
//      l / F2, slot l % F2 of the pass) are loaded at once; ballots give
//      the window's live list (slot ids and positions, in slot order).  A
//      masked slot's output is written at once (0; -1e30 scores for the
//      softmax of F <= 32).  A group with no live slot writes its zeros
//      and gathers nothing; only rows with a live slot have their q row
//      read, once, into shared memory.
//   2. The listed slots' k rows go to shared memory in passes of PS rows
//      (`wide_pass`: enough for 32 (slot, head) pairs, at most about 8
//      KB): consecutive lanes copy consecutive 16 bytes of one row
//      (cp.async.cg; 32 lanes are one 128-column f32 row, and a 32-column
//      row takes 8 lanes, so 4 rows go at once), and the whole pass's
//      copies, with the q rows on the first pass, are issued before any is
//      waited for.  A view whose base or row stride is not 16-byte aligned
//      is copied element by element through registers into the same
//      layout.  A masked slot's k row is never read.  Rows sit 16 x odd
//      bytes apart (`wide_pitch16`), so the lanes of one step read
//      distinct bank quads.
//   3. A lane per (listed slot, head) pair, slots fastest, computes the dot
//      from shared memory in column order (16-byte reads where the head
//      width allows): the first product, then each next one added, __f*_rn
//      throughout, the order of the plain loop.  gat_attention divides it
//      by sqrtf(dh) into the scores; sddmm writes it out.
//   4. gat_attention's softmax per head, four heads at a time: for F > 32
//      over the row's live scores (the lanes take the list in strides of
//      32), for F <= 32 over f (the F2 lanes of a row, masked slots
//      -1e30); max and sum by xor shuffles, max-subtracted expf, divide;
//      exactly 0 on a masked slot and on an all-masked row.  sddmm takes
//      the kernel with one head, no scale and no softmax.
// The wrapper raises only where the chosen kernel's warp would pass 227 KB
// of shared memory.
//
//   rgat_attention: R-GAT's relation-wise GATConv attention (OGB-LSC
//                  MAG240M's rgnn.py, arXiv:2103.09430), for slot f of row i
//                  of relation g = rel[i,f] and head h,
//                    e = LeakyReLU(s_src[tid[i,f], h] + s_dst[i, g, h])
//                    alpha[i,f,h] = softmax of e over i's live slots of g
//                  (0 where the slot is masked or of no relation); out
//                  (N, F, heads) f32.  s_src holds each projected table
//                  row's source scores <W_g x_j, a_src>, s_dst each row's
//                  target score of each relation <W_g x_i, a_dst>.
// Replaces no TPU kernel (the JAX package has no relational GNN): it is
// added for R-GAT.  Bound: bytes.  A slot reads its mask, relation, table
// row and 2 x heads scores and writes heads floats, a few operations
// each; the alpha written, (N, F, heads) f32, is most of the bytes.
// Design: scores_kernel's narrow layout (a lane a slot, 32 / F2 rows a
// warp), the scores in registers, a softmax a relation that a slot of the
// warp holds (warp-uniform loop, xor shuffles within a row's lanes), and
// float4 loads and stores of 4 heads.  No shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemMax = 232448;   // 227 KB, a block's most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// V consecutive elements of a row: one 16-byte read-only load where `vec`
// says the addresses allow it, else V narrow loads of the same elements.
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
};

// columns a chunk holds: 16 bytes where the head width allows, else 1
template <typename T>
int chunk_cols(int D, int heads) {
  constexpr int kVec = 16 / sizeof(T);
  return (D / heads) % kVec == 0 ? kVec : 1;
}

// floor(log2(n)) for n >= 1
__host__ __device__ __forceinline__ int log2_floor(int n) {
  int s = 0;
  while ((2 << s) <= n) ++s;
  return s;
}

// w / n and w % n for a runtime n: a shift and a mask where n is a power
// of two (the main path's chunk counts), else the division
struct DivMod {
  int n, shift;
  bool pow2;
  __device__ __forceinline__ explicit DivMod(int n_)
      : n(n_), shift(log2_floor(n_)), pow2((n_ & (n_ - 1)) == 0) {}
  __device__ __forceinline__ int div(int w) const {
    return pow2 ? w >> shift : w / n;
  }
  __device__ __forceinline__ int mod(int w) const {
    return pow2 ? w & (n - 1) : w % n;
  }
};

// V f32 values at p in shared memory (16-byte aligned where V % 4 == 0):
// 16-byte accesses, so a warp's 32 consecutive chunks take the fewest
// shared-memory wavefronts
template <int V>
__device__ __forceinline__ void smem_get(const float* p, float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + e);
      x[e] = t.x, x[e + 1] = t.y, x[e + 2] = t.z, x[e + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = p[e];
  }
}
template <int V>
__device__ __forceinline__ void smem_put(float* p, const float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = x[e];
  }
}

// F rounded up to a power of two: the lanes one row's slots take
__host__ __device__ __forceinline__ int slot_lanes(int F) {
  int f2 = 1;
  while (f2 < F) f2 *= 2;
  return f2;
}

// shared memory of one warp, in 4-byte words, rounded up to 16 bytes: q's
// rows as f32 (32 / F2 rows of D), the chunk partials of up to 32 live
// slots (D/V chunks of kPart words: chunk-major, one word of padding, so
// the lanes of one chunk and of one (slot, head) pair hit distinct banks),
// the live slots' k rows and lanes (2 x 32) and, for the softmax, one
// row's values a lane (F2 x heads, at least 32)
constexpr int kPart = 33;
__host__ __device__ __forceinline__ int warp_words(int F, int D, int V,
                                                   int heads, bool softmax) {
  const int pairs = slot_lanes(F) * heads;
  const int w = 32 / slot_lanes(F) * D + kPart * (D / V) + 64 +
                (softmax ? (pairs > 32 ? pairs : 32) : 0);
  return (w + 3) / 4 * 4;
}

// the wide kernel's shared memory: q and k rows as their dtype, each row
// padded to an odd number of 16-byte units; PS k rows (a pass: enough
// slots for 32 (slot, head) pairs, at most about kPassWords words) and RW
// q rows; the live list of a window of up to two passes of
// 32 slots (slot ids and positions); the RW rows' F x heads scores for the
// softmax, none for sddmm.  In 4-byte words, a multiple of 4.
constexpr int kPassWords = 2048;
__host__ __device__ __forceinline__ int wide_pitch16(int D, int size) {
  return ((D * size + 15) / 16) | 1;
}
__host__ __device__ __forceinline__ int wide_rows(int F) {
  return F <= 32 ? 32 / slot_lanes(F) : 1;
}
__host__ __device__ __forceinline__ int wide_list(int F) {
  return F <= 32 ? 32 : 64;
}
__host__ __device__ __forceinline__ int wide_pass(int D, int heads,
                                                  int size) {
  const int fill = (32 + heads - 1) / heads;      // 32 (slot, head) pairs
  const int fit = kPassWords / (4 * wide_pitch16(D, size));
  const int p = fill < fit ? fill : fit;
  return p < 1 ? 1 : p > 32 ? 32 : p;
}
__host__ __device__ __forceinline__ int wide_words(int F, int D, int heads,
                                                   int size, bool softmax) {
  const int rw = wide_rows(F);
  return (wide_pass(D, heads, size) + rw) * 4 * wide_pitch16(D, size) +
         2 * wide_list(F) +
         (softmax ? (rw * F * heads + 3) / 4 * 4 : 0) +
         (softmax && F > 32 ? (F + 3) / 4 * 4 : 0);
}

// at most 64 registers a thread, so 4 full blocks fit an SM
template <typename T, int V, int IT, bool SOFTMAX>
__global__ void __launch_bounds__(kMaxWarps * 32, 4)
scores_kernel(const T* __restrict__ q, long long ldq,
              const T* __restrict__ k, long long ldk,
              const int32_t* __restrict__ nbr,
              const uint8_t* __restrict__ mask, float* __restrict__ out,
              long long N, int F, int D, int heads, bool vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int F2 = slot_lanes(F), RW = 32 / F2;   // lanes a row, rows a warp
  const int f2_shift = log2_floor(F2);
  const long long r0 =
      ((long long)blockIdx.x * (blockDim.x / 32) + wid) * RW;
  if (r0 >= N) return;                   // whole warp; no block barrier
  const int NC = D / V;                  // chunks of a row
  const int G = NC / heads;              // chunks of a head
  const DivMod chunk(NC);
  const int width = SOFTMAX ? heads : 1;
  float* qs = smem + (long long)wid * warp_words(F, D, V, heads, SOFTMAX);
  float* part = qs + RW * D;             // [chunk][live slot j]
  int* ids = reinterpret_cast<int*>(part + kPart * NC);
  int* slot = ids + 32;                  // lane of live slot j
  float* sc = reinterpret_cast<float*>(slot + 32);
  const unsigned row_slots = F2 == 32 ? kFull : (1u << F2) - 1u;

  // 1. lane s = row * F2 + f holds slot f of row r0 + row; the live set by
  // ballot
  const int f = lane & (F2 - 1);
  const long long r = r0 + (lane >> f2_shift);
  const bool in = f < F && r < N;
  bool live = false;
  int id = 0;
  if (in) {
    live = mask[r * F + f] != 0;
    id = nbr[r * F + f];
  }
  const unsigned live_set = __ballot_sync(kFull, live);
  const int nlive = __popc(live_set);
  if (nlive == 0) {                      // no gather, not even q's rows
    const long long n = (N - r0 < RW ? N - r0 : RW) * F * width;
    for (long long p = lane; p < n; p += 32) out[r0 * F * width + p] = 0.0f;
    return;
  }
  const int j_mine = __popc(live_set & ((1u << lane) - 1u));
  if (live) {
    ids[j_mine] = id;
    slot[j_mine] = lane;
  }
  __syncwarp();

  // 2. every (live slot, chunk) pair's load in flight, then the q rows
  // that have a live slot
  const int items = nlive * NC;          // item w = j * NC + chunk
  Chunk<T, V> kb[IT];
  auto issue = [&](int base) {
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      if (base + i * 32 >= items) break;     // the warp's last item
      const int w = base + i * 32 + lane;
      if (w < items)
        kb[i].load(k + (long long)ids[chunk.div(w)] * ldk +
                       chunk.mod(w) * V, vec);
    }
  };
  issue(0);
  for (int t = lane; t < RW * NC; t += 32) {
    const int row = chunk.div(t), c = chunk.mod(t);
    if ((live_set >> (row * F2)) & row_slots) {
      Chunk<T, V> x;
      x.load(q + (r0 + row) * ldq + c * V, vec);
      float xf[V];
#pragma unroll
      for (int e = 0; e < V; ++e) xf[e] = to_f32(x.v[e]);
      smem_put(qs + row * D + c * V, xf);
    }
  }
  __syncwarp();

  // 3. each pair's partial: its V products in column order
  for (int base = 0;;) {
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      if (base + i * 32 >= items) break;     // the warp's last load
      const int w = base + i * 32 + lane;
      if (w < items) {
        const int j = chunk.div(w), c = chunk.mod(w);
        float qc[V];
        smem_get(qs + (slot[j] >> f2_shift) * D + c * V, qc);
        float s = __fmul_rn(qc[0], to_f32(kb[i].v[0]));
#pragma unroll
        for (int e = 1; e < V; ++e)
          s = __fadd_rn(s, __fmul_rn(qc[e], to_f32(kb[i].v[e])));
        part[c * kPart + j] = s;
      }
    }
    base += 32 * IT;
    if (base >= items) break;
    issue(base);                         // past IT a lane: the next batch
  }
  __syncwarp();

  // 4. the dot of live slot j and head h: h's chunk partials in chunk order
  auto dot = [&](int j, int h) {
    const float* pp = part + h * G * kPart + j;
    float s = pp[0];
    for (int g = 1; g < G; ++g) s = __fadd_rn(s, pp[g * kPart]);
    return s;
  };
  if constexpr (!SOFTMAX) {
    if (in) out[r * F + f] = live ? dot(j_mine, 0) : 0.0f;
  } else {
    // 5. softmax over f.  Pair p = s * heads + h (s the slot's lane) sits
    // on lane p % 32 of pass p / 32, heads passes in all.  A row's pairs
    // are RP aligned lanes of one pass, or PPR whole passes: a lane takes
    // its passes of the row in order, then xor offsets heads .. RP / 2 (at
    // most 16) join the lanes of its head.  Pads and masked slots hold
    // -1e30.  Passes whose slots are all masked only write their zeros.
    const DivMod head(heads);
    const int RP = F2 * heads;
    const int span = RP < 32 ? RP : 32, PPR = RP < 32 ? 1 : RP / 32;
    const int slots = 32 / heads * PPR;  // slots of PPR passes
    const unsigned block_slots = slots == 32 ? kFull : (1u << slots) - 1u;
    const float scale = sqrtf((float)(D / heads));
    for (int i0 = 0; i0 < heads; i0 += PPR) {
      const bool any = (live_set >> (i0 * 32 / heads)) & block_slots;
      float mx = -1e30f;
      for (int i = i0; any && i < i0 + PPR; ++i) {
        const int p = i * 32 + lane, s = head.div(p);
        float v = -1e30f;
        if ((live_set >> s) & 1u)
          v = __fdiv_rn(
              dot(__popc(live_set & ((1u << s) - 1u)), head.mod(p)), scale);
        sc[(i - i0) * 32 + lane] = v;
        mx = fmaxf(mx, v);
      }
      float sum = 0.0f;
      if (any) {
        for (int o = heads; o < span; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        for (int i = i0; i < i0 + PPR; ++i) {
          float* e_p = sc + (i - i0) * 32 + lane;
          const float e = expf(__fsub_rn(*e_p, mx));
          *e_p = e;
          sum = __fadd_rn(sum, e);
        }
        for (int o = heads; o < span; o <<= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, o));
      }
      for (int i = i0; i < i0 + PPR; ++i) {
        const int p = i * 32 + lane, s = head.div(p), fs = s & (F2 - 1);
        const long long rs = r0 + (s >> f2_shift);
        if (fs < F && rs < N)
          out[(rs * F + fs) * heads + head.mod(p)] =
              (live_set >> s) & 1u ? __fdiv_rn(sc[(i - i0) * 32 + lane], sum)
                                   : 0.0f;
      }
    }
  }
}

template <typename T, int V, bool SOFTMAX>
void go(int IT, long long groups, int warps, size_t smem, cudaStream_t s,
        const void* q, long long ldq, const void* k, long long ldk,
        const int32_t* nbr, const uint8_t* mask, float* out, long long N,
        int F, int D, int heads, bool vec) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const unsigned grid = (unsigned)((groups + warps - 1) / warps);
#define DEAL_SCORES(I)                                                  \
  {                                                                     \
    auto kern = scores_kernel<T, V, I, SOFTMAX>;                        \
    if (smem > 48 * 1024)                                               \
      cudaFuncSetAttribute(kern,                                        \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, \
                           (int)smem);                                  \
    kern<<<grid, warps * 32, smem, s>>>(qt, ldq, kt, ldk, nbr, mask,    \
                                        out, N, F, D, heads, vec);      \
  }
  switch (IT) {
    case 1: DEAL_SCORES(1); break;
    case 2: DEAL_SCORES(2); break;
    case 4: DEAL_SCORES(4); break;
    default: DEAL_SCORES(8); break;
  }
#undef DEAL_SCORES
}

// R-GAT's attention: a lane a slot, as scores_kernel lays it out (lane
// row * F2 + f, 32 / F2 rows a warp), R-GAT's 4 heads a lane in registers.
// A live slot of a known relation g loads its source score (one float4 of
// its table row t) and its row's target score of g (one float4), and
// scores them LeakyReLU(src + dst); the softmax runs once for each
// relation that a slot of the warp holds, over the lanes of one row (xor
// shuffles below F2), the other relations' slots at -1e30: max, expf of
// the difference, sum, divide.  Masked slots, pads and slots of no
// relation (g < 0) write 0.  The three float arrays are 16-byte aligned
// (the wrapper checks), so a slot's heads move as one float4.
constexpr int kRgatHeads = 4;
__global__ void __launch_bounds__(kMaxWarps * 32)
rgat_attention_kernel(const float4* __restrict__ s_src,
                      const float4* __restrict__ s_dst,
                      const int32_t* __restrict__ tid,
                      const int8_t* __restrict__ rel,
                      const uint8_t* __restrict__ mask,
                      float4* __restrict__ out, long long N, int F, int nrel,
                      float slope) {
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int F2 = slot_lanes(F), RW = 32 / F2;
  const int f2_shift = log2_floor(F2);
  const long long r0 =
      ((long long)blockIdx.x * (blockDim.x / 32) + wid) * RW;
  if (r0 >= N) return;                   // whole warp
  const int f = lane & (F2 - 1);
  const long long r = r0 + (lane >> f2_shift);
  const bool in = f < F && r < N;
  int g = -1;
  if (in && mask[r * F + f]) g = rel[r * F + f];
  const bool live = g >= 0 && g < nrel;
  float e[kRgatHeads], a[kRgatHeads];
#pragma unroll
  for (int h = 0; h < kRgatHeads; ++h) e[h] = a[h] = 0.0f;
  if (live) {
    const float4 u = __ldg(s_src + tid[r * F + f]);
    const float4 v = __ldg(s_dst + r * nrel + g);
    const float x[kRgatHeads] = {u.x, u.y, u.z, u.w};
    const float y[kRgatHeads] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < kRgatHeads; ++h) {
      const float s = __fadd_rn(x[h], y[h]);
      e[h] = s > 0.0f ? s : __fmul_rn(s, slope);
    }
  }
  for (int k = 0; k < nrel; ++k) {
    const bool mine = live && g == k;
    if (!__any_sync(kFull, mine)) continue;    // warp-uniform
#pragma unroll
    for (int h = 0; h < kRgatHeads; ++h) {
      float mx = mine ? e[h] : -1e30f;
      for (int o = F2 / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float x = mine ? expf(__fsub_rn(e[h], mx)) : 0.0f;
      float sum = x;
      for (int o = F2 / 2; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, o));
      if (mine) a[h] = __fdiv_rn(x, sum);
    }
  }
  if (in) out[r * F + f] = make_float4(a[0], a[1], a[2], a[3]);
}

int launch_rgat(const float* s_src, const float* s_dst, const int32_t* tid,
                const int8_t* rel, const uint8_t* mask, float* out,
                long long N, int F, int heads, int nrel, float slope,
                int warps, void* stream) {
  if (N <= 0) return 0;
  if (F < 1 || F > 32 || heads != kRgatHeads || nrel < 1 || nrel > 127 ||
      warps < 1 || warps > kMaxWarps ||
      reinterpret_cast<uintptr_t>(s_src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s_dst) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const int rows = 32 / slot_lanes(F);   // rows a warp
  const long long groups = (N + rows - 1) / rows;
  const unsigned grid = (unsigned)((groups + warps - 1) / warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rgat_attention_kernel<<<grid, warps * 32, 0, s>>>(
      reinterpret_cast<const float4*>(s_src),
      reinterpret_cast<const float4*>(s_dst), tid, rel, mask,
      reinterpret_cast<float4*>(out), N, F, nrel, slope);
  return cudaGetLastError();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of D elements, row i from rowp(i) (skipped where null),
// to dst + i * pitch: 16-byte cp.async chunks where `vec`, consecutive
// lanes on consecutive chunks of a row (32 / NC rows at a time where a row
// has NC < 32 chunks), one row pointer a row; else element by element
// through registers, eight loads a lane in flight at a time.
template <typename T, typename RowP>
__device__ __forceinline__ void copy_rows(T* dst, int pitch, int rows,
                                          int D, bool vec, int lane,
                                          RowP rowp) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int nc = D / E;
    if (nc <= 32 && 32 % nc == 0) {
      const int per = 32 / nc, ri = lane / nc, c = (lane % nc) * E;
      for (int i = ri; i < rows; i += per) {
        const T* p = rowp(i);
        if (p) cp_async16(dst + i * pitch + c, p + c);
      }
    } else {
      for (int i = 0; i < rows; ++i) {
        const T* p = rowp(i);
        if (!p) continue;
        for (int c = lane * E; c < D; c += 32 * E)
          cp_async16(dst + i * pitch + c, p + c);
      }
    }
    return;
  }
  const DivMod nc(D);
  for (int w0 = 0; w0 < rows * D; w0 += 32 * 8) {
    T x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = w0 + 32 * u + lane;
      const T* p = w < rows * D ? rowp(nc.div(w)) : nullptr;
      if (p) x[u] = __ldg(p + nc.mod(w));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = w0 + 32 * u + lane;
      if (w < rows * D && rowp(nc.div(w)))
        dst[nc.div(w) * pitch + nc.mod(w)] = x[u];
    }
  }
}

// the n products of a and b (shared memory) in column order: the first,
// then each next one added; V columns a 16-byte read where V > 1
template <typename T, int V>
__device__ __forceinline__ float dot_cols(const T* a, const T* b, int n) {
  alignas(16) T av[V];
  alignas(16) T bv[V];
  auto get = [&](int c) {
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(av) = *reinterpret_cast<const uint4*>(a + c);
      *reinterpret_cast<uint4*>(bv) = *reinterpret_cast<const uint4*>(b + c);
    } else {
      av[0] = a[c];
      bv[0] = b[c];
    }
  };
  get(0);
  float s = __fmul_rn(to_f32(av[0]), to_f32(bv[0]));
#pragma unroll
  for (int e = 1; e < V; ++e)
    s = __fadd_rn(s, __fmul_rn(to_f32(av[e]), to_f32(bv[e])));
  for (int c = V; c < n; c += V) {
    get(c);
#pragma unroll
    for (int e = 0; e < V; ++e)
      s = __fadd_rn(s, __fmul_rn(to_f32(av[e]), to_f32(bv[e])));
  }
  return s;
}

// the wide path (see the note at the top): a warp serves RW rows; every
// exchange between lanes goes through the warp's own shared memory
// (after __syncwarp) or shuffles, so warps never wait for each other.  At
// most 48 registers a thread, so 5 blocks of 8 warps fit an SM: the
// kernel waits on its gathers, and more warps in flight hide them better
// than registers would.
template <typename T, int V, bool SOFTMAX>
__global__ void __launch_bounds__(kMaxWarps * 32, 5)
wide_kernel(const T* __restrict__ q, long long ldq,
            const T* __restrict__ k, long long ldk,
            const int32_t* __restrict__ nbr,
            const uint8_t* __restrict__ mask, float* __restrict__ out,
            long long N, int F, int D, int heads, bool vec) {
  extern __shared__ float4 smem4[];
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int F2 = F <= 32 ? slot_lanes(F) : 32;   // lanes of a row's pass
  const int RW = 32 / F2;                         // rows a warp
  const long long r0 =
      ((long long)blockIdx.x * (blockDim.x / 32) + wid) * RW;
  if (r0 >= N) return;                   // whole warp; no block barrier
  const int pitch = wide_pitch16(D, sizeof(T)) * 16 / sizeof(T);
  const int PS = wide_pass(D, heads, sizeof(T));
  const int LC = wide_list(F);
  const int dh = D / heads;
  const int width = SOFTMAX ? heads : 1;
  T* Ks = reinterpret_cast<T*>(
      reinterpret_cast<float*>(smem4) +
      (long long)wid * wide_words(F, D, heads, sizeof(T), SOFTMAX));
  T* Qs = Ks + PS * pitch;               // after the pass's k rows
  int* ids = reinterpret_cast<int*>(Qs + RW * pitch);
  int* pos = ids + LC;                   // live slot j: row * F + f
  float* sc = reinterpret_cast<float*>(pos + LC);
  // F > 32: the row's scores in live-list order, and each one's slot
  int* lf = reinterpret_cast<int*>(sc + (RW * F * heads + 3) / 4 * 4);
  const int row = lane / F2, fl = lane % F2;
  const long long r = r0 + row;
  const unsigned row_slots = F2 == 32 ? kFull : (1u << F2) - 1u;
  const int chunks = (F + F2 - 1) / F2;  // passes of 32 slots (F <= 32: 1)
  const float scale = sqrtf((float)dh);
  bool q_read = false;
  int seen = 0;                          // live slots of earlier windows

  for (int c0 = 0; c0 < chunks; c0 += 2) {   // a window of two passes
    // 1. every mask and nbr load of the window at once, then its live list;
    // a masked slot's output is 0 (F <= 32 with the softmax: -1e30 scores)
    bool in[2], live[2];
    int id[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = (c0 + u) * F2 + fl;
      in[u] = c0 + u < chunks && f < F && r < N;
      live[u] = in[u] && mask[r * F + f] != 0;
      id[u] = in[u] ? nbr[r * F + f] : 0;
    }
    int cnt = 0;
    unsigned rows_live = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = (c0 + u) * F2 + fl;
      const unsigned b = __ballot_sync(kFull, live[u]);
      if (in[u] && !live[u]) {
        if (SOFTMAX && F <= 32) {
          for (int h = 0; h < heads; ++h)
            sc[(row * F + f) * heads + h] = -1e30f;
        } else {
          for (int h = 0; h < width; ++h) out[(r * F + f) * width + h] = 0.0f;
        }
      }
      if (live[u]) {
        const int j = cnt + __popc(b & ((1u << lane) - 1u));
        ids[j] = id[u];
        pos[j] = row * F + f;
        if (SOFTMAX && F > 32) lf[seen + j] = f;
      }
      cnt += __popc(b);
      for (int i = 0; i < RW; ++i)
        if ((b >> (i * F2)) & row_slots) rows_live |= 1u << i;
    }
    if (cnt == 0) {
      if (F > 32) continue;              // nothing to gather in the window
      // no live slot in the group: its zeros, and no gather, not even q
      const long long n = (N - r0 < RW ? N - r0 : RW) * F * width;
      for (long long p = lane; p < n; p += 32) out[r0 * F * width + p] = 0.0f;
      return;
    }
    __syncwarp();
    // 2. the q rows with a live slot (once, with the first pass's copies),
    // then the passes of k rows: a pass's copies are all issued before any
    // is waited for
    if (!q_read) {
      copy_rows(Qs, pitch, RW, D, vec, lane, [&](int i) -> const T* {
        return (rows_live >> i) & 1u ? q + (r0 + i) * ldq : nullptr;
      });
      q_read = true;
    }
    for (int j0 = 0; j0 < cnt; j0 += PS) {
      const int m = cnt - j0 < PS ? cnt - j0 : PS;
      if (j0 > 0) __syncwarp();          // the last pass's dots are done
      copy_rows(Ks, pitch, m, D, vec, lane, [&](int i) -> const T* {
        return k + (long long)ids[j0 + i] * ldk;
      });
      cp_commit();
      cp_wait<0>();
      __syncwarp();
      // 3. a lane per (slot, head) pair, slots fastest; the scores of a row
      // with F > 32 are kept in live-list order
      const DivMod by_m(m);
      for (int pp = lane; pp < m * heads; pp += 32) {
        const int h = by_m.div(pp), jj = by_m.mod(pp);
        const int ps = pos[j0 + jj];
        const float s = dot_cols<T, V>(Qs + (ps / F) * pitch + h * dh,
                                       Ks + jj * pitch + h * dh, dh);
        if constexpr (SOFTMAX)
          sc[(F <= 32 ? ps : seen + j0 + jj) * heads + h] =
              __fdiv_rn(s, scale);
        else
          out[r0 * F + ps] = s;
      }
    }
    __syncwarp();                        // ids, pos and Ks are free
    seen += cnt;
  }
  if constexpr (!SOFTMAX) return;
  __syncwarp();
  if (F > 32) {
    // 4a. softmax of the row over its live slots, four heads at a time:
    // lanes take the live list in strides of 32, max and sum by xor
    // shuffles; a masked slot's 0 is already written
    for (int h0 = 0; h0 < heads; h0 += 4) {
      const int nh = heads - h0 < 4 ? heads - h0 : 4;
      float mx[4], sum[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[u] = -1e30f, sum[u] = 0.0f;
      for (int j = lane; j < seen; j += 32) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nh) mx[u] = fmaxf(mx[u], sc[j * heads + h0 + u]);
      }
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(kFull, mx[u], o));
      }
      for (int j = lane; j < seen; j += 32) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u < nh) {
            float* sp = sc + j * heads + h0 + u;
            const float e = expf(__fsub_rn(*sp, mx[u]));
            *sp = e;
            sum[u] = __fadd_rn(sum[u], e);
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sum[u] = __fadd_rn(sum[u], __shfl_xor_sync(kFull, sum[u], o));
      }
      for (int j = lane; j < seen; j += 32) {
        float* op = out + (r0 * F + lf[j]) * heads + h0;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nh) op[u] = __fdiv_rn(sc[j * heads + h0 + u], sum[u]);
      }
    }
    return;
  }
  // 4b. softmax over f, four heads at a time: the row's F2 lanes, xor
  // shuffles
  for (int h0 = 0; h0 < heads; h0 += 4) {
    const int nh = heads - h0 < 4 ? heads - h0 : 4;
    float mx[4], sum[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[u] = -1e30f, sum[u] = 0.0f;
    for (int f = fl; f < F; f += F2) {
      const float* sp = sc + (row * F + f) * heads + h0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < nh) mx[u] = fmaxf(mx[u], sp[u]);
    }
    for (int o = F2 / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        mx[u] = fmaxf(mx[u], __shfl_xor_sync(kFull, mx[u], o));
    }
    for (int f = fl; f < F; f += F2) {
      float* sp = sc + (row * F + f) * heads + h0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < nh) {
          const float e = expf(__fsub_rn(sp[u], mx[u]));
          sp[u] = e;
          sum[u] = __fadd_rn(sum[u], e);
        }
      }
    }
    for (int o = F2 / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        sum[u] = __fadd_rn(sum[u], __shfl_xor_sync(kFull, sum[u], o));
    }
    if (r < N) {
      for (int f = fl; f < F; f += F2) {
        const bool lv = mask[r * F + f] != 0;
        const float* sp = sc + (row * F + f) * heads + h0;
        float* op = out + (r * F + f) * heads + h0;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < nh) op[u] = lv ? __fdiv_rn(sp[u], sum[u]) : 0.0f;
      }
    }
  }
}

// whether scores_kernel takes the shape (else wide_kernel does)
__host__ __forceinline__ bool narrow_takes(int F, int D, int V, int heads,
                                           bool softmax) {
  return F <= 32 && heads <= 32 && (heads & (heads - 1)) == 0 &&
         (size_t)warp_words(F, D, V, heads, softmax) * sizeof(float) <=
             kSmemMax;
}

template <typename T, bool SOFTMAX>
int launch(const void* q, long long ldq, const void* k, long long ldk,
           const int32_t* nbr, const uint8_t* mask, float* out, long long N,
           int F, int D, int heads, int warps, void* stream) {
  if (N <= 0) return 0;
  if (F < 1 || D < 1 || heads < 1 || D % heads != 0 || warps < 1 ||
      warps > kMaxWarps)
    return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  const int V = chunk_cols<T>(D, heads);
  const bool vec = V == kVec && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   ldq % V == 0 && ldk % V == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!narrow_takes(F, D, V, heads, SOFTMAX)) {
    const size_t smem = (size_t)warps *
                        wide_words(F, D, heads, sizeof(T), SOFTMAX) *
                        sizeof(float);
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    const int rows = wide_rows(F);        // rows a group
    const long long groups = (N + rows - 1) / rows;
    const unsigned grid = (unsigned)((groups + warps - 1) / warps);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
#define DEAL_WIDE(VV)                                                   \
  {                                                                     \
    auto kern = wide_kernel<T, VV, SOFTMAX>;                            \
    if (smem > 48 * 1024)                                               \
      cudaFuncSetAttribute(kern,                                        \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, \
                           (int)smem);                                  \
    kern<<<grid, warps * 32, smem, s>>>(qt, ldq, kt, ldk, nbr, mask,    \
                                        out, N, F, D, heads, vec);      \
  }
    if (V == kVec)
      DEAL_WIDE(kVec)
    else
      DEAL_WIDE(1)
#undef DEAL_WIDE
    return cudaGetLastError();
  }
  const size_t smem =
      (size_t)warps * warp_words(F, D, V, heads, SOFTMAX) * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  // loads a lane holds at once: up to 32 live slots' D / V chunks over 32
  // lanes, at most 8
  const int per_lane = D / V;
  const int IT = per_lane <= 1 ? 1 : per_lane <= 2 ? 2 : per_lane <= 4 ? 4
                                                                         : 8;
  const int rows = 32 / slot_lanes(F);   // rows a warp
  const long long groups = (N + rows - 1) / rows;
  if (V == kVec)
    go<T, kVec, SOFTMAX>(IT, groups, warps, smem, s, q, ldq, k, ldk, nbr,
                         mask, out, N, F, D, heads, vec);
  else
    go<T, 1, SOFTMAX>(IT, groups, warps, smem, s, q, ldq, k, ldk, nbr, mask,
                      out, N, F, D, heads, false);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q and k share it).  `warps`
// (1..8) warps a block, each on groups of 32 / F2 rows (F2: F rounded up
// to a power of two; one row for F > 32 in wide_kernel).  Returns the launch's cudaError_t.
extern "C" int deal_gat_attention(const void* q, const void* k,
                                  const int32_t* nbr, const uint8_t* mask,
                                  float* out, long long N, int F, int D,
                                  int heads, int dtype, int warps,
                                  void* stream) {
  if (dtype == 0)
    return launch<float, true>(q, D, k, D, nbr, mask, out, N, F, D, heads,
                               warps, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, D, k, D, nbr, mask, out, N, F, D,
                                       heads, warps, stream);
  return cudaErrorInvalidValue;
}

// q and k: rows ldq and ldk elements apart, columns unit-stride.
extern "C" int deal_sddmm(const void* q, const void* k, const int32_t* nbr,
                          const uint8_t* mask, float* out, long long N, int F,
                          int D, long long ldq, long long ldk, int dtype,
                          int warps, void* stream) {
  if (dtype == 0)
    return launch<float, false>(q, ldq, k, ldk, nbr, mask, out, N, F, D, 1,
                                warps, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, ldq, k, ldk, nbr, mask, out, N,
                                        F, D, 1, warps, stream);
  return cudaErrorInvalidValue;
}

// R-GAT's attention (rgat_attention_kernel): s_src (rows, heads) and s_dst
// (N, nrel, heads) f32; tid (N, F) int32 rows of s_src; rel (N, F) int8
// relations, -1 for none; out (N, F, heads) f32.  heads 4, F <= 32, the
// float arrays 16-byte aligned.
extern "C" int deal_rgat_attention(const float* s_src, const float* s_dst,
                                   const int32_t* tid, const int8_t* rel,
                                   const uint8_t* mask, float* out,
                                   long long N, int F, int heads, int nrel,
                                   float slope, int warps, void* stream) {
  return launch_rgat(s_src, s_dst, tid, rel, mask, out, N, F, heads, nrel,
                     slope, warps, stream);
}

