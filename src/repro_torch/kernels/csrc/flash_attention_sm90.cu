// Flash attention on Hopper's tensor cores (sm_90a): the bf16 path.
//
//   out[b,i,h,:] = sum_j p[i,j] * v[b,j,h/G,:]
//   p[i,:]       = softmax over live j of (scale * q[b,i,h,:]) . k[b,j,h/G,:]
//
// A key j is live for query row i when j < Skv, j <= q_offset + i (causal),
// and q_offset + i - j < window (when a window is given).  q and k have head
// dim hd, v and out head dim vd, which may differ (MLA: hd 192, vd 128).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (pallas_call at line 65) and serves models/attention.py::
// flash_attention_jnp's GQA layout.  Every bf16 call takes this kernel, for
// any hd and vd up to 256; flash_attention.cu is the f32 path only.  Both
// take the same arguments.
//
// Bound: operations.  At the prefill shape (B=4, S=2048, H=15, K=5, hd=64,
// causal) the live (i, j) pairs need 4 * hd flops each, 32.2 GFLOP: 0.033 ms
// at 989 TFLOP/s bf16 against 0.012 ms for the 42 MB of q, k, v and out at
// 3.35 TB/s.  Only the tensor cores reach that rate, so both products run on
// wgmma and the rest of the design keeps them fed:
//
// - One block of 384 threads per (batch, head, tile of 128 query rows),
//   heaviest (latest, under a causal mask) tiles first.  Warpgroup 0 is the
//   producer: one thread issues TMA loads, and the warpgroup gives its
//   registers to the two consumer warpgroups (setmaxnreg 24 / 240), each of
//   which owns 64 query rows.
// - q, k and v are read in place through 4-D tensor maps over their
//   (hd, heads, seq, batch) strides, built on the host per call: no copy, no
//   padding.  TMA zero-fills rows past Sq or Skv and columns past hd.  Each
//   tile lands in shared memory as 64-column blocks of 128-byte rows, with
//   the 128-byte swizzle that the wgmma descriptors name.  The q tile is
//   loaded once; k and v tiles of BN keys stream through a ring of NST
//   stages, each with a "full" mbarrier (TMA bytes arrived) and an "empty"
//   one (all eight consumer warps done), so loads run ahead of the math.
// - S = q . k^T: wgmma m64nBNk16, q and k both K-major from shared memory,
//   f32 accumulator in registers.  The online softmax works on that
//   fragment: a thread holds two rows (g and g + 8 of its warp's 16), the
//   row max and sum need two shuffles across a quad.  The scale is applied
//   to the f32 score, in the log2 domain (scale * log2(e) folded in, so the
//   exponent is exp2f); masked scores are the -1e30 fill.  Masks are tested
//   per element only on tiles that cross a row's live range.
// - O += P . v: P is the S fragment rounded to bf16 in place (the f32
//   accumulator layout of m64nN is the register A layout of m64k16, two
//   keys to a 32-bit register), so P never goes through shared memory.
//   v is B in its natural (key, d) layout: bf16 wgmma reads B N-major
//   (imm-trans-b), so v is never transposed.
// - Overlap, as FlashAttention-3 does it.  Within a warpgroup, tile j's S
//   and tile j-1's P . v are issued together, and tile j's softmax runs
//   while P . v does (this holds a stage one tile longer, so it needs three
//   stages: hd <= 128).  Between the two warpgroups, named barriers make
//   them take turns at issuing (ping-pong), so one's softmax runs under the
//   other's wgmma; both then walk every tile of the block.  With two
//   stages (hd 256, whose tiles are 64 keys) neither is done, and a
//   warpgroup skips the tiles dead for all of its rows.
// - Head dims.  A tile is Tile<HD, VD, BN, NST>: q and k held at HD
//   columns, v and the O fragment at VD.  hd <= 64 and vd <= 64 take <64,
//   64, 128, 3>; both <= 128 take <128, 128, 128, 3>; MLA (hd <= 192, vd <=
//   128) takes <192, 128, 64, 3>; the rest <256, 256, 64, 2>.  A head dim
//   below its tile's is zero-filled by TMA.  At MLA's shape, V and O at 128
//   columns (not 256) halve the O fragment (64 registers) and V's stages,
//   and q and k at 192 columns skip a quarter of the zero-filled q . k^T of
//   a 256-column tile: the three stages fit in 173,112 bytes, so MLA runs
//   with the overlap and ping-pong below.  tools/flash_tc_stages.py builds
//   it with DEAL_TC_MLA_STAGES=2 (no overlap) and =0 (no MLA tile: <256,
//   256, 64, 2>) to time both against it.
// - The end: acc / max(l, 1e-30), stored as bf16.  A row with no live key
//   at all (only a window or an offset can do that) comes out as the mean of
//   v over all Skv keys, which is what a softmax over -1e30 fills gives.
//
// Registers: ptxas reports 168 a thread (the 65,536 of the SM over 384
// threads); setmaxnreg moves them to the consumers.  Shared memory: 115,768
// bytes at hd <= 64, 230,456 at hd <= 128, 173,112 for MLA, 197,672 at hd
// <= 256.
//
// Numerics against JAX's flash_attention_jnp: P is rounded to bf16 before
// P . v (JAX keeps p in f32; the row sum l here is taken over the f32 p), and
// the exponent is exp2f of the log2-scaled score.  No fast math otherwise.
#include <cuda.h>          // CUtensorMap and its enums; the encoder is
#include <cuda_runtime.h>  // looked up at run time: the build needs no -lcuda
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // query rows per block: two consumer warpgroups
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
#ifndef DEAL_TC_MLA_STAGES
#define DEAL_TC_MLA_STAGES 3    // stages of MLA's tile; 0: none (the header)
#endif

struct Args {
  const __nv_bfloat16* v;       // read directly only for rows with no live key
  __nv_bfloat16* out;           // contiguous (B, Sq, H, vd)
  int H, K, Sq, Skv, hd, vd;
  long long svb, svs, svh;
  int causal, has_window;
  long long window, q_offset;
  float scale_log2;             // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused; N-major: next 64-column block), stride byte
// offset (next group of 8 rows: 1024 bytes here), all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
         | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
         | (1ull << 62);
}

// named barriers 1 and 2 (0 is __syncthreads), over both consumer
// warpgroups: one syncs on its own, the other arrives at it
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) . B (64 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) (+)= A (64 x 16, smem) . B (128 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, smem,
// N-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, smem,
// N-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) . B (16 x 256, smem,
// N-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// HD: q and k's head dim held (hd is zero-filled up to it); VD: v's and
// O's (vd likewise); BN: keys per tile; NST: stages of the k/v ring.  Shared
// memory: the q tile, then NST k tiles, NST v tiles, then the barriers; each
// tile is HD / 64 (v: VD / 64) blocks of 128-byte rows.
template <int HD, int VD, int BN, int NST>
struct Tile {
  static_assert(HD % 64 == 0 && VD % 64 == 0 && VD != 192, "tile widths");
  static constexpr int kColBlocks = HD / 64;
  static constexpr int kVColBlocks = VD / 64;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKBytes = BN * HD * 2;           // one k tile
  static constexpr int kVBytes = BN * VD * 2;           // one v tile
  static constexpr int kSmem = kQBytes + NST * (kKBytes + kVBytes)
                               + (2 * NST + 1) * 8 + 1024;   // + alignment
};

template <int HD, int VD, int BN, int NST>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Args a) {
  using T = Tile<HD, VD, BN, NST>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: every tile starts on one
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = sQ + T::kQBytes;
  uint8_t* sV = sK + NST * T::kKBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NST * T::kVBytes);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.K);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // heaviest tiles first
  // the key tiles that any row of this block can see
  const long long r_last = min(r0 + kBM, a.Sq) - 1;
  long long kv_end = a.Skv, kv_begin = 0;
  if (a.causal) kv_end = min(kv_end, a.q_offset + r_last + 1);
  if (a.has_window) kv_begin = max(0LL, a.q_offset + r0 - a.window + 1);
  const long long t_first = kv_begin / BN;
  const int n_tiles = (int)max(0LL, (kv_end + BN - 1) / BN - t_first);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // uniform over the warp (a wgmma on a path it thinks divergent is
  // serialized)
  const int wg = __shfl_sync(kFull, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kColBlocks; ++c)
        tma_load(sQ + c * kBM * 128, &tq, qbar, 64 * c, h, r0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NST;
        const int key0 = (int)((t_first + it) * BN);
        mbar_wait(&empty[s], ((it / NST) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::kKBytes + T::kVBytes);
#pragma unroll
        for (int c = 0; c < T::kColBlocks; ++c)
          tma_load(sK + s * T::kKBytes + c * BN * 128, &tk, &full[s], 64 * c,
                   kh, key0, b);
#pragma unroll
        for (int c = 0; c < T::kVColBlocks; ++c)
          tma_load(sV + s * T::kVBytes + c * BN * 128, &tv, &full[s], 64 * c,
                   kh, key0, b);
      }
    }
    return;
  }

  // consumer warpgroups: 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, cq = lane % 4;
  const int w0 = r0 + 64 * cw;
  // the thread's two rows (g and g + 8 of its warp's 16) see keys [lo, hi)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long qpos = a.q_offset + w0 + 16 * warp + g + 8 * r;
    long long l_ = 0, h_ = a.Skv;
    if (a.causal) h_ = min(h_, qpos + 1);
    if (a.has_window) l_ = max(l_, qpos - a.window + 1);
    lo[r] = (int)min(l_, (long long)a.Skv);
    hi[r] = (int)max(h_, 0LL);
  }
  // keys that some row of the warpgroup sees, [wk_begin, wk_end), and keys
  // that all of its rows see, [wk_lo, wk_hi): tiles inside need no mask
  const long long w_last = min(w0 + 63, a.Sq - 1);
  long long wk_begin = 0, wk_end = w0 < a.Sq ? a.Skv : 0;
  long long wk_lo = 0, wk_hi = a.Skv;
  if (a.causal) {
    wk_end = min(wk_end, a.q_offset + w_last + 1);
    wk_hi = min(wk_hi, a.q_offset + w0 + 1);
  }
  if (a.has_window) {
    wk_begin = max(0LL, a.q_offset + w0 - a.window + 1);
    wk_lo = max(0LL, a.q_offset + w_last - a.window + 1);
  }

  float o[VD / 2];
#pragma unroll
  for (int i = 0; i < VD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_u32(sQ) + cw * 64 * 128;
  float sc[BN / 2];                    // S, then P in f32, of one tile
  uint32_t pa[BN / 16][4];             // P in bf16: the A operand of P . v

  // S = q . k^T for the tile in stage s, issued and committed, not waited
  // for: HD / 16 steps of 16 columns (a 64-column block is one swizzle
  // atom; a step inside it is 32 bytes on)
  auto issue_s = [&](int s) {
    const uint32_t k_addr = smem_u32(sK + s * T::kKBytes);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t col = (ks % 4) * 32;
      wgmma_ss<BN>(
          sc, desc_sw128(q_addr + (ks / 4) * kBM * 128 + col, 16, 1024),
          desc_sw128(k_addr + (ks / 4) * BN * 128 + col, 16, 1024), ks > 0);
    }
    wgmma_commit();
    fence_regs(sc);
  };
  // O += P . v for the tile in stage s, issued and committed: v N-major,
  // 16 keys (2048 bytes) a step, the next 64 columns of vd BN * 128 on
  auto issue_pv = [&](int s) {
    const uint32_t v_addr = smem_u32(sV + s * T::kVBytes);
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks)
      wgmma_rs<VD>(o, pa[ks],
                   desc_sw128(v_addr + ks * 16 * 128, BN * 128, 1024));
    wgmma_commit();
    fence_regs(o);
    fence_regs(pa);
  };
  // the online softmax on S of the tile at key0, in place: sc[4i + e] is
  // row g + 8 (e / 2), key key0 + 8i + 2cq + e % 2.  Updates m and l;
  // returns in corr the factor o must be scaled by
  auto softmax = [&](long long key0, float (&corr)[2]) {
    const bool masked = key0 < wk_lo || key0 + BN > wk_hi;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = sc[4 * i + e] * a.scale_log2;
        if (masked) {
          const int kv = (int)key0 + 8 * i + 2 * cq + (e & 1);
          if (kv < lo[e >> 1] || kv >= hi[e >> 1]) t = kNegInf;
        }
        sc[4 * i + e] = t;
        mx[e >> 1] = fmaxf(mx[e >> 1], t);
      }
    }
    float mu[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      // a row with no live key yet holds only fills: exp2(t - inf) = 0
      mu[r] = mx[r] == kNegInf ? __int_as_float(0x7f800000) : mx[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * i + e] - mu[e >> 1]);
        sc[4 * i + e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
  };
  // o *= corr, and P to bf16 in place (the f32 accumulator layout of
  // m64nN is the register A layout of m64k16, two keys to a register)
  auto rescale_and_pack = [&](const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < VD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[ks][j] = pack_bf16(sc[8 * ks + 2 * j], sc[8 * ks + 2 * j + 1]);
    }
  };
  auto release = [&](int s) {          // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  auto pass = [&](int it) {            // a tile dead for every row here
    mbar_wait(&full[it % NST], (it / NST) & 1);
    release(it % NST);
  };

  // With three stages: overlap within a warpgroup (below), and ping-pong
  // between the two: they take turns to issue their products, so that
  // one's softmax runs under the other's wgmma.  A turn is a bar.sync on
  // the warpgroup's own barrier, which the other's bar.arrive opens;
  // warpgroup 0 goes first.  Both walk every tile of the block (the same
  // number of turns), masking what is dead for their rows.  Without it, a
  // warpgroup walks only the tiles live for some of its rows.
  constexpr bool kOverlap = NST >= 3;
  auto turn_begin = [&]() { if constexpr (kOverlap) bar_sync(1 + cw); };
  auto turn_end = [&]() { if constexpr (kOverlap) bar_arrive(2 - cw); };
  int live_lo = 0, live_hi = n_tiles;
  if (!kOverlap) {
    live_lo = (int)min((long long)n_tiles, max(0LL, wk_begin / BN - t_first));
    live_hi = (int)max((long long)live_lo,
                       min((long long)n_tiles,
                           (wk_end + BN - 1) / BN - t_first));
  }
  mbar_wait(qbar, 0);
  for (int it = 0; it < live_lo; ++it) pass(it);
  if (live_lo < live_hi) {
    float corr[2];
    int s = live_lo % NST;
    if (kOverlap && cw == 1) bar_arrive(1);
    mbar_wait(&full[s], (live_lo / NST) & 1);
    turn_begin();
    issue_s(s);
    turn_end();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax((t_first + live_lo) * BN, corr);
    rescale_and_pack(corr);
    for (int it = live_lo + 1; it < live_hi; ++it) {
      const int prev = s;
      s = it % NST;
      if constexpr (kOverlap) {
        // this tile's S and the last tile's P . v together; the softmax
        // runs while P . v does
        mbar_wait(&full[s], (it / NST) & 1);
        turn_begin();
        issue_s(s);
        issue_pv(prev);
        turn_end();
        wgmma_wait<1>();
        fence_regs(sc);
        softmax((t_first + it) * BN, corr);
        wgmma_wait<0>();
        fence_regs(o);
        release(prev);
      } else {
        // two stages: the last tile's stage goes back before this one's
        // S, or the producer would wait a whole tile for it
        issue_pv(prev);
        wgmma_wait<0>();
        fence_regs(o);
        release(prev);
        mbar_wait(&full[s], (it / NST) & 1);
        issue_s(s);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax((t_first + it) * BN, corr);
      }
      rescale_and_pack(corr);
    }
    issue_pv(s);                       // the last live tile's P . v
    wgmma_wait<0>();
    fence_regs(o);
    release(s);
  }
  for (int it = live_hi; it < n_tiles; ++it) pass(it);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  const bool pairs = (a.vd & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + 16 * warp + g + 8 * r;
    if (row >= a.Sq) continue;
    __nv_bfloat16* orow =
        a.out + (((long long)b * a.Sq + row) * a.H + h) * a.vd;
    if (l[r] == 0.0f) {                // no live key: mean of v
      const __nv_bfloat16* vb = a.v + b * a.svb + kh * a.svh;
      for (int j = 0; j < VD / 8; ++j) {
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * j + 2 * cq + e;
          if (d >= a.vd) continue;
          float acc = 0.0f;
          for (long long kv = 0; kv < a.Skv; ++kv)
            acc += __bfloat162float(vb[kv * a.svs + d]);
          orow[d] = __float2bfloat16(acc / (float)a.Skv);
        }
      }
      continue;
    }
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < VD / 8; ++j) {
      const int d = 8 * j + 2 * cq;
      const float x0 = o[4 * j + 2 * r] / denom;
      const float x1 = o[4 * j + 2 * r + 1] / denom;
      if (pairs && d + 1 < a.vd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < a.vd) orow[d] = __float2bfloat16(x0);
        if (d + 1 < a.vd) orow[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---------------------------------------------------------------- host --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (batch, seq, heads, hd) bf16 view as a 4-D map (hd innermost), read in
// boxes of 64 columns x `rows` rows of one head; strides in elements
bool make_map(CUtensorMap* map, const void* base, int hd, int heads, int seq,
              int batch, long long sb, long long ss, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(base), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Views {
  const void *q, *k;
  int B;
  long long sqb, sqs, sqh, skb, sks, skh;
};

template <int HD, int VD, int BN, int NST>
cudaError_t launch(const Views& w, const Args& a, cudaStream_t s) {
  using T = Tile<HD, VD, BN, NST>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, w.q, a.hd, a.H, a.Sq, w.B, w.sqb, w.sqs, w.sqh, kBM)
      || !make_map(&tk, w.k, a.hd, a.K, a.Skv, w.B, w.skb, w.sks, w.skh, BN)
      || !make_map(&tv, a.v, a.vd, a.K, a.Skv, w.B, a.svb, a.svs, a.svh, BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_tc_kernel<HD, VD, BN, NST>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(w.B * a.H), (unsigned)((a.Sq + kBM - 1) / kBM));
  kernel<<<grid, kThreads, T::kSmem, s>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

// The arguments of deal_flash_attention (flash_attention.cu); dtype must be
// 1 (bfloat16), hd and vd at most 256.  TMA's rules on top: every base
// address 16-byte aligned and every stride (in elements) a multiple of 8, or
// the call returns cudaErrorInvalidValue.  Returns the launch's cudaError_t.
extern "C" int deal_flash_attention_tc(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int Sq, int Skv, int hd, int vd, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, int causal, int has_window,
    long long window, long long q_offset, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (dtype != 1 || H < 1 || K < 1 || H % K != 0 || Skv < 1 || hd < 1
      || hd > 256 || vd < 1 || vd > 256 || (long long)B * H > 0x7fffffffLL
      || (Sq + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  const Args a{static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(out), H, K, Sq, Skv, hd, vd, svb,
               svs, svh, causal, has_window, window, q_offset,
               scale * 1.4426950408889634f};
  const Views w{q, k, B, sqb, sqs, sqh, skb, sks, skh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64 && vd <= 64) return launch<64, 64, 128, 3>(w, a, s);
  if (hd <= 128 && vd <= 128) return launch<128, 128, 128, 3>(w, a, s);
#if DEAL_TC_MLA_STAGES > 0
  if (hd <= 192 && vd <= 128)
    return launch<192, 128, 64, DEAL_TC_MLA_STAGES>(w, a, s);
#endif
  return launch<256, 256, 64, 2>(w, a, s);
}
