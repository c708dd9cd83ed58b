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
// to `wide_kernel`, a simple one: a warp a row, the lanes walk the row's
// slots in passes of 32 and a lane gathers the k row of its own live
// slot; each (slot, head) dot is its dh products summed in column order
// (16-byte loads where the head width and the addresses allow, the same
// order either way); the F x heads scores sit in shared memory (4 F heads
// bytes a warp); the softmax per head divides by sqrtf(dh), takes -1e30
// for a masked slot, max and sum by lane-strided loops and xor shuffles,
// max-subtracted expf, divide.  sddmm takes it with one head, no scale and
// no softmax, writing the scores straight out.  The choice is by shape
// alone (`kernel_for` in gat_attention.py makes the same one), so a row's
// bits depend on (D, heads, F, dtype) and on no other row.  The wrapper
// raises only where the chosen kernel's warp would pass 227 KB of shared
// memory.
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

// shared memory of one warp of wide_kernel, in 4-byte words (16-byte
// aligned): the row's F x heads scores for the softmax, none for sddmm
__host__ __device__ __forceinline__ int wide_words(int F, int heads,
                                                   bool softmax) {
  return softmax ? (F * heads + 3) / 4 * 4 : 0;
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

// the wide path: one warp a row (see the note at the top).  Lane f % 32
// holds slot f; every lane reads and writes only its own scores in shared
// memory, so the shuffles are the only exchange between lanes.
template <typename T, int V, bool SOFTMAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
wide_kernel(const T* __restrict__ q, long long ldq,
            const T* __restrict__ k, long long ldk,
            const int32_t* __restrict__ nbr,
            const uint8_t* __restrict__ mask, float* __restrict__ out,
            long long N, int F, int D, int heads, bool vec) {
  extern __shared__ float4 smem4[];
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) + wid;
  if (r >= N) return;                    // whole warp; no block barrier
  const int dh = D / heads;
  float* sc = reinterpret_cast<float*>(smem4) +
              (long long)wid * wide_words(F, heads, SOFTMAX);
  const T* qr = q + r * ldq;
  const float scale = sqrtf((float)dh);
  for (int f = lane; f < F; f += 32) {
    const bool live = mask[r * F + f] != 0;
    const T* kr = k + (live ? (long long)nbr[r * F + f] * ldk : 0);
    for (int h = 0; h < heads; ++h) {
      float s = 0.0f;
      if (live) {
        for (int c = h * dh; c < (h + 1) * dh; c += V) {
          Chunk<T, V> qc, kc;
          qc.load(qr + c, vec);
          kc.load(kr + c, vec);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float p = __fmul_rn(to_f32(qc.v[e]), to_f32(kc.v[e]));
            s = (c == h * dh && e == 0) ? p : __fadd_rn(s, p);
          }
        }
      }
      if constexpr (SOFTMAX)
        sc[f * heads + h] = live ? __fdiv_rn(s, scale) : -1e30f;
      else
        out[r * F + f] = live ? s : 0.0f;
    }
  }
  if constexpr (SOFTMAX) {
    for (int h = 0; h < heads; ++h) {
      float mx = -1e30f;
      for (int f = lane; f < F; f += 32) mx = fmaxf(mx, sc[f * heads + h]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      float sum = 0.0f;
      for (int f = lane; f < F; f += 32) {
        const float e = expf(__fsub_rn(sc[f * heads + h], mx));
        sc[f * heads + h] = e;
        sum = __fadd_rn(sum, e);
      }
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, o));
      for (int f = lane; f < F; f += 32)
        out[(r * F + f) * heads + h] =
            mask[r * F + f] ? __fdiv_rn(sc[f * heads + h], sum) : 0.0f;
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
    const size_t smem =
        (size_t)warps * wide_words(F, heads, SOFTMAX) * sizeof(float);
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((N + warps - 1) / warps);
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
// (1..8) warps a block, each on groups of 32 / F2 rows (scores_kernel) or
// on one row (wide_kernel).  Returns the launch's cudaError_t.
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
