// Two designs of the fanout-gather SPMM that tools/spmm_designs.py times
// against the kernel in src/repro_torch/kernels/csrc/spmm.cu (a thread per
// (row, 16-byte chunk) walking its row's slots).  Same function, same bits:
//
//   out[i, c] = sum_f  w[i,f,hd(c)] * mask[i,f] * h[idx(i,f), c]
//   idx(i,f)  = nbr[i,f], or table[nbr[i,f]] when a table is given
//
// f32 only, F <= 32, D a multiple of 4 with 16-byte chunks inside a head,
// h 16-byte aligned; each output element an f32 sum over the live slots in
// f order from +0.0, with __fmul_rn / __fadd_rn.  Both share step 1:
//
//   1. A warp serves a group of G = 32 / F2 rows (F2: F rounded up to a
//      power of two).  Lane s = row * F2 + f reads nbr and mask of slot f
//      (and table[nbr] for a live slot); a ballot gives the live set, and
//      the j-th live slot (in (row, f) order) is the one whose lane has j
//      live lanes below it.  Lane pairs p = lane, lane + 32, ... stand for
//      (row p / NC, 16-byte chunk p % NC) of the group's output.
//
// "regs" (design 0): the register gather of gat_attention.cu.  The live
// ids go to shared memory; a lane walks its pairs' live slots in order and
// issues IT chunk loads into registers before it sums any of them, then
// the next IT.  A warp a group; `warps` warps a block.
//
// "bulk" (design 1): Hopper's bulk asynchronous copy, in a two-stage
// software pipeline.  Each live lane copies its whole h row into the
// stage's shared-memory ring (row j at ring[j]) with cp.async.bulk,
// completing on the stage's mbarrier, which lane 0 armed with the group's
// byte count.  Warps are persistent: a warp issues the next group's
// copies before it waits for and sums the current group, and loads the
// metadata (mask, nbr, w) of the group after that, so no load waits on
// another and bytes in flight cost no registers.  The live slots'
// coefficients go to shared memory beside their rows (heads <= 4).  A
// stage holds the worst case, 32 rows of D floats (16 KB at D = 128), so a
// warp takes two of them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* h;            // (N, D), 16-byte aligned
  const int32_t* table;      // (N,) or null
  const float* w;            // (R, F[, heads]) through its strides
  long long swr, swf, swh;
  const uint8_t* mask;       // (R, F)
  const int32_t* nbr;        // (R, F)
  float* out;                // (R, D)
  long long R;
  int F, D, heads;
};

struct Group {               // step 1 for one group of rows
  long long r0;
  unsigned set;              // live slots, bit s = row * F2 + f
  int id;                    // this lane's slot's source row (if live)
  bool live;
};

__device__ __forceinline__ Group read_group(const Args& a, long long grp,
                                            int F2, int G, int lane) {
  Group g;
  g.r0 = grp * G;
  const int f = lane & (F2 - 1);
  const long long r = g.r0 + lane / F2;
  g.live = false;
  g.id = 0;
  if (f < a.F && r < a.R) {
    g.live = a.mask[r * a.F + f] != 0;
    g.id = __ldg(a.nbr + r * a.F + f);   // beside the mask, not after it
    if (g.live && a.table != nullptr) g.id = __ldg(a.table + g.id);
  }
  g.set = __ballot_sync(kFull, g.live);
  return g;
}

// the live slots of row `row` of a group, and the index j of its first
__device__ __forceinline__ unsigned row_bits(unsigned set, int row, int F2,
                                             int* j0) {
  const int sh = row * F2;               // < 32
  *j0 = __popc(set & ((1u << sh) - 1u));
  const unsigned m = F2 == 32 ? kFull : (1u << F2) - 1u;
  return (set >> sh) & m;
}

__device__ __forceinline__ float coef(const Args& a, long long r, int f,
                                      int c, int NC) {
  return __ldg(a.w + r * a.swr + (long long)f * a.swf +
               (long long)(c / (NC / a.heads)) * a.swh);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// ---- design 0: registers ------------------------------------------------

template <int IT>
__global__ void __launch_bounds__(256) regs_kernel(const Args a) {
  __shared__ int ids_all[8][32];
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  int F2 = 1;
  while (F2 < a.F) F2 *= 2;
  const int G = 32 / F2, NC = a.D / 4, P = G * NC;
  const long long grp = (long long)blockIdx.x * (blockDim.x / 32) + wid;
  if (grp * G >= a.R) return;            // whole warp
  const Group g = read_group(a, grp, F2, G, lane);
  int* ids = ids_all[wid];
  if (g.live) ids[__popc(g.set & ((1u << lane) - 1u))] = g.id;
  __syncwarp();
  const int T = (P - lane + 31) / 32;    // this lane's pairs
  auto out_at = [&](int t) {             // pair t's output chunk, or null
    const int p = lane + 32 * t;
    const long long r = g.r0 + p / NC;
    return r < a.R ? a.out + r * a.D + (p % NC) * 4 : nullptr;
  };
  // the loader's cursor: pair lt, its live bits left, the next slot's j
  int lt = 0, lj = 0;
  unsigned lbits = 0;
  if (T > 0) lbits = row_bits(g.set, lane / NC, F2, &lj);
  int cur = 0;                           // the pair being summed
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  while (lt < T) {
    float4 x[IT];
    float cf[IT];
    int tag[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) {       // IT loads in flight
      while (lbits == 0 && lt < T) {
        if (++lt < T)
          lbits = row_bits(g.set, (lane + 32 * lt) / NC, F2, &lj);
      }
      tag[i] = -1;
      if (lt < T) {
        const int p = lane + 32 * lt, c = p % NC;
        const long long r = g.r0 + p / NC;
        const int f = __ffs(lbits) - 1;
        lbits &= lbits - 1;
        x[i] = __ldg(reinterpret_cast<const float4*>(
            a.h + (long long)ids[lj] * a.D + c * 4));
        cf[i] = coef(a, r, f, c, NC);
        tag[i] = lt;
        ++lj;
      }
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) {       // then the sums, in order
      if (tag[i] < 0) continue;
      for (; cur < tag[i]; ++cur) {      // finished pairs; empty ones 0
        if (float* o = out_at(cur)) store4(o, acc);
        acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
      }
      acc[0] = __fadd_rn(acc[0], __fmul_rn(cf[i], x[i].x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(cf[i], x[i].y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(cf[i], x[i].z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(cf[i], x[i].w));
    }
  }
  for (; cur < T; ++cur) {
    if (float* o = out_at(cur)) store4(o, acc);
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  }
}

// ---- design 1: bulk copies, two stages ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ __forceinline__ size_t stage_floats(int D) {
  return (size_t)32 * D;
}

constexpr int kHeadsMax = 4;             // bulk: coefficients a live slot

// shared memory of a block of `warps` warps: two stages of rows, two of
// coefficients, two barriers
__host__ __device__ __forceinline__ size_t bulk_bytes(int warps, int D) {
  return (size_t)warps * (2 * stage_floats(D) * 4 + 2 * 32 * kHeadsMax * 4 +
                          16);
}

struct Meta {                // one lane's slot of a group, loaded ahead
  bool live;
  int id;
  float w[kHeadsMax];
};

__device__ __forceinline__ Meta load_meta(const Args& a, long long grp,
                                          int F2, int G, int lane) {
  Meta m{false, 0, {0.f, 0.f, 0.f, 0.f}};
  const int f = lane & (F2 - 1);
  const long long r = grp * G + lane / F2;
  if (f < a.F && r < a.R) {              // no load waits on another
    m.live = a.mask[r * a.F + f] != 0;
    m.id = __ldg(a.nbr + r * a.F + f);
    const float* wr = a.w + r * a.swr + (long long)f * a.swf;
#pragma unroll
    for (int k = 0; k < kHeadsMax; ++k)
      if (k < a.heads) m.w[k] = __ldg(wr + (long long)k * a.swh);
  }
  return m;
}

__global__ void __launch_bounds__(256) bulk_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  int F2 = 1;
  while (F2 < a.F) F2 *= 2;
  const int G = 32 / F2, NC = a.D / 4, P = G * NC;
  const long long groups = (a.R + G - 1) / G;
  const long long step = (long long)gridDim.x * warps;
  float* base = reinterpret_cast<float*>(smem4);
  float* ring = base + wid * 2 * stage_floats(a.D);
  float* cw = base + warps * 2 * stage_floats(a.D) +
              wid * 2 * 32 * kHeadsMax;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
                      base + warps * 2 * (stage_floats(a.D) +
                                          32 * kHeadsMax)) + 2 * wid;
  if (lane == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const uint32_t row_bytes = a.D * 4;

  // a group's copies into stage s, from metadata loaded an iteration ago
  auto issue = [&](int s, const Meta& m) {
    int id = m.id;
    if (m.live && a.table != nullptr) id = __ldg(a.table + id);
    const unsigned set = __ballot_sync(kFull, m.live);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_u32(bar + s)),
                      "r"(__popc(set) * row_bytes) : "memory");
    __syncwarp();
    if (m.live) {
      const int j = __popc(set & ((1u << lane) - 1u));
#pragma unroll
      for (int k = 0; k < kHeadsMax; ++k)
        cw[(s * 32 + j) * kHeadsMax + k] = m.w[k];
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_u32(ring + s * stage_floats(a.D) + (size_t)j * a.D)),
             "l"(reinterpret_cast<uint64_t>(a.h + (long long)id * a.D)),
             "r"(row_bytes), "r"(smem_u32(bar + s))
          : "memory");
    }
    return set;
  };

  long long grp = (long long)blockIdx.x * warps + wid;
  if (grp >= groups) return;             // whole warp
  unsigned set[2];
  uint32_t phase[2] = {0u, 0u};
  set[0] = issue(0, load_meta(a, grp, F2, G, lane));
  Meta ahead{};
  if (grp + step < groups) ahead = load_meta(a, grp + step, F2, G, lane);
  for (int s = 0; grp < groups; s ^= 1) {
    const long long next = grp + step;
    if (next < groups) {                 // the next group's copies, then
      set[s ^ 1] = issue(s ^ 1, ahead);  // the one after's metadata, in
      if (next + step < groups)          // flight while this one is summed
        ahead = load_meta(a, next + step, F2, G, lane);
    }
    __syncwarp();                        // coefficients written
    uint32_t done;
    do {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_u32(bar + s)), "r"(phase[s]) : "memory");
    } while (!done);
    phase[s] ^= 1u;
    const float* st = ring + s * stage_floats(a.D);
    const float* cs = cw + s * 32 * kHeadsMax;
    const long long r0 = grp * G;
    for (int p = lane; p < P; p += 32) {
      const int row = p / NC, c = p % NC, hd = c / (NC / a.heads);
      const long long r = r0 + row;
      if (r >= a.R) continue;
      int j;
      unsigned bits = row_bits(set[s], row, F2, &j);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (; bits != 0; bits &= bits - 1, ++j) {
        const float4 x =
            *reinterpret_cast<const float4*>(st + (size_t)j * a.D + c * 4);
        const float cf = cs[j * kHeadsMax + hd];
        acc[0] = __fadd_rn(acc[0], __fmul_rn(cf, x.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(cf, x.y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(cf, x.z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(cf, x.w));
      }
      store4(a.out + r * a.D + c * 4, acc);
    }
    __syncwarp();                        // the stage is read: free it for
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // copies
    grp = next;
  }
}

}  // namespace

// design 0 (regs: `it` loads a lane in flight, 4, 8 or 16) or 1 (bulk);
// `warps` warps a block (at most 8).  Returns the launch's cudaError_t.
extern "C" int spmm_design(int design, const float* h, const int32_t* table,
                           const float* w, long long swr, long long swf,
                           long long swh, const uint8_t* mask,
                           const int32_t* nbr, float* out, long long R,
                           int F, int D, int heads, int warps, int it,
                           void* stream) {
  if (R <= 0 || F < 1 || F > 32 || D % 4 != 0 || heads < 1 ||
      (design == 1 && heads > kHeadsMax) ||
      (D / heads) % 4 != 0 || warps < 1 || warps > 8 ||
      reinterpret_cast<uintptr_t>(h) % 16 != 0)
    return cudaErrorInvalidValue;
  const Args a{h, table, w, swr, swf, swh, mask, nbr, out, R, F, D, heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int F2 = 1;
  while (F2 < F) F2 *= 2;
  const long long groups = (R + 32 / F2 - 1) / (32 / F2);
  const unsigned blocks = (unsigned)((groups + warps - 1) / warps);
  if (design == 0) {
    if (it == 4) regs_kernel<4><<<blocks, 32 * warps, 0, s>>>(a);
    else if (it == 8) regs_kernel<8><<<blocks, 32 * warps, 0, s>>>(a);
    else if (it == 16) regs_kernel<16><<<blocks, 32 * warps, 0, s>>>(a);
    else return cudaErrorInvalidValue;
    return cudaGetLastError();
  }
  if (design != 1) return cudaErrorInvalidValue;
  const size_t smem = bulk_bytes(warps, D);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaFuncSetAttribute(bulk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bulk_kernel,
                                                32 * warps, smem);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const unsigned persistent = (unsigned)(sms * per_sm);
  bulk_kernel<<<blocks < persistent ? blocks : persistent, 32 * warps, smem,
                s>>>(a);
  return cudaGetLastError();
}
