#!/usr/bin/env python3
"""Drive the PyTorch port of Deal on one NVIDIA GPU, and hold each of its
hand-written CUDA kernels against the kernel's plain PyTorch version.

    python3 chip_smoke.py

Phases (the flash phase runs right after the kernels); any failure ends
the run with a non-zero exit code:

1. card:   the card's name and power limit; build the kernels with nvcc
   (one process per source, in parallel), print each source's registers,
   spills and ptxas performance warnings, check that the f32 flash
   kernel's tiles for hd <= 128 spill nothing, and count the HGMMA
   (wgmma) instructions in the tensor-core flash kernel's SASS.
2. kernels: each kernel at the main path's shapes (ogbn-papers100M
   stand-in, N = 1,048,576, fanout 8, D = 128, 4 heads) against its plain
   version on the card: quantized f32 (< 5e-7), random f32 and bf16 at
   the tolerances of tests/test_kernels.py, attention on random f32
   (< 5e-7); spmm and gather_spmm bitwise across tilings and on row
   subsets, rows with no live slot exactly 0, and their heads-weighted
   form (GAT's
   attend: w a strided (R, 8, 4) view) bitwise the four per-head
   launches; gat_attention and sddmm bitwise on row subsets, and sddmm
   on strided per-head column slices against their contiguous copies.
   [tune]: ``tuning.ensure_tuned`` for spmm and gather_spmm at those
   shapes over their grid of 15 tilings (rows x chunks a block) into a
   fresh table under ``build/``, each tiling timed with CUDA events
   (median of 20) and its output bitwise the default tiling's; the
   slice phase's gcn session binds that table
   (``ExecutorSpec(name="cuda", block_table=...)``), picks the winner,
   and its ``infer_all`` is bitwise an untuned executor's epoch.
   [gat-wide]: the wide scoring kernel (F > 32 or heads not a power of
   two: the live slots' k rows copied into shared memory a pass at a
   time, a lane per (slot, head) dot) against the same plain versions:
   gat_attention
   on the layer graph sampled at fanout 64 (D = 128, 4 heads; quantized
   f32 < 5e-7, random f32 and bf16 at the tolerances of
   tests/test_kernels.py) and at fanout 8 with D = 96 and 3 heads, and
   sddmm at fanout 64 (D = 32 and strided head slices); row subsets
   bitwise; times beside the live-slot bound and the plain version.
   Times with CUDA events (median of 20 after warm-up): the kernel, the
   plain version, one PyTorch library call where there is one, and the
   least time the card could take (bytes over 3.35 TB/s or flops over
   the f32 peak, whichever is larger, counting what this run's data
   needs), and each kernel's time over its bound and over its library
   call.
3. slice:  ``Session.build(cfg, device="cuda").infer_all()`` for gcn,
   sage and gat (4 heads; fused and unfused attention), each against
   the "ref" executor on the card with the same params (atol 1e-4,
   rtol 3e-3), with each kernel's launches counted over that run; then
   the warm epoch split into the DenseIO build, ``prepare`` and
   ``run_model``, and ``run_model`` once more under spans (ms per op).
   [serve]: first (before the sessions) whether a row of
   ``torch.matmul`` keeps its bits as the row count changes, and that
   the executors' ``gemm_rows`` does.  Then, in the gcn and the fused
   gat session (4 store shards, tail onboarding), ``Session.serve()``:
   the full epoch, 64 queries of 256 rows through the engine, one
   mutation batch (4,096 edge adds, 1,024 edge removes, 1,024 feature
   updates, 256 node adds) folded by ``refresh()`` (its time split into
   the DenseIO build, the ops on the card and the rest), then
   ``full_epoch()``.  Checks: every level of the refreshed store is
   bitwise a fresh full epoch over the mutated layer graphs and
   features; the same batch refreshed in chunks of 4,096 rows by a
   second engine (QoS, one chunk a step) and on a store capped at
   262,144 rows a level (recompute on a miss) gives the same bytes; the
   same steps through "ref" on the card agree within atol 1e-4, rtol
   3e-3; gather_spmm (and gat_attention for gat) launch.
   [layerwise]: in the gcn, sage and (fused) gat sessions,
   ``local_<model>_infer`` through "cuda" over the session's layer
   graphs, X and params: bitwise ``Session.infer_all``, within atol
   1e-4, rtol 3e-3 of the engine through "ref", with its launches; then
   (after the feature prep) ``ego_batched_gcn_infer``, the Fig 14
   baseline, on the stand-in at scale 8 (131,072 nodes; the host's
   frontier walks at 1M nodes would take too long) in batches of 6% of
   the nodes, within atol 1e-4, rtol 1e-4 of ``local_gcn_infer`` (and
   whether it is bitwise), its GEMM rows beside DEAL's 3 N and both
   times.
4. fused feature prep: ``fused_load_spmm`` through the cuda executor
   against "ref", counting the gather_spmm launches.
   [launcher]: ``repro_torch.launch.serve_embeddings``' own functions
   (``config_from_args``, ``_serve_session``, ``drive``) on gcn in the
   [serve] phase's world (4 store shards), telemetry on with the scrape
   endpoint on a free port and a snapshot file under ``build/``: a few
   ticks of queries and edge mutations whose staleness bound fires a
   refresh, while a thread scrapes /metrics, /healthz and /stats (each
   200, ``deal_`` series, /nope 404); then ``dump_trace`` through the
   port's ``validate_trace`` (coverage >= 0.9; the stage categories
   construct, sample, featprep, ops, serve, refresh, store; the spans
   serve.tick and refresh.layer) and ``check_trace``, its coverage and
   stage breakdown printed, and the endpoint stopped by ``close()``.
   [dist]: the distributed executor on a 4 x 2 mesh of shards, all on
   the card (no interconnect is measured): ``Session.build(cfg)
   .infer_all()`` with executor "dist" for gcn, sage and gat (1 head:
   dist GAT has heads = 1 semantics), each within atol 1e-4, rtol 3e-3
   of the single-card "cuda" executor on the same params, with the
   plan build (``dist.bind``), the epoch and the bytes each primitive
   copied; ``DistributedLayerwise`` for gat with 4 heads on 2 x 4
   against the 1-head result; on gcn's layer 0 the dist SPMM and SDDMM
   through the kernels against their plain versions, grouped against
   monolithic, the graph-exchange and all-gather SPMMs, the deal_ring
   and cagnet GEMMs and SDDMM approach (i) against DEAL's, and per
   layer the bytes DEAL's SPMM copies (exactly M x ``comm_volume``'s
   unique-row figure; the padded figure and the graph exchange's
   beside it); then ``serve()`` and a trickle (64 edge adds, 16
   feature updates, 8 node adds) through ``refresh()`` on the mesh,
   every level bitwise a dist full epoch, and a second session whose
   ``dist_local_cutover`` routes part of the same refresh to the local
   "cuda" executor (within atol 1e-4, rtol 3e-3).  spmm and sddmm must
   launch on the mesh, gather_spmm on the local routes.
   [cluster]: ``Session.build(cfg).serve()`` with ``cluster.n_shards =
   2`` on the stand-in at 1,048,576 nodes (gat, 4 heads, fused
   attention, tail onboarding): two worker processes on the card, each
   building the world, behind the router; the ready wait; against a
   single-process engine on the parent session's own world, 64 queries
   of 256 rows bitwise before and after one trickle commit (64 edge
   adds, 16 feature updates, 8 node adds), whose refresh, WAL and
   checkpoint times each worker reports; every shard's store digests
   equal the single process's; shard 1 killed with SIGKILL and
   restarted (build, restore and replay times) while shard 0 runs the
   ``checkpoint`` op (its time), digests equal again;
   the router's /healthz scraped once; the workers' own launch counts
   (their ``status``) added to the totals, with gather_spmm and
   gat_attention launched; every process's peak memory; no worker left
   after ``close()``.
5. flash kernels: ``flash_attention`` at the dense-transformer prefill
   shape (smollm-360m: B=4, S=2048, 15 query heads over 5 kv heads,
   hd=64, causal), a ragged S=1000, a sliding window of 256 and the
   Pallas (BH, S, hd) signature, each in f32 (the register-blocked f32
   kernel, atol 2e-5, rtol 3e-2) and in bf16 (the tensor-core kernel,
   atol 8e-3, rtol 1e-2) against its plain version; all four bf16 calls
   and no f32 one must take the tensor-core kernel.  Times both kernels,
   the plain version, the library yardstick
   (``scaled_dot_product_attention``, causal, GQA) in f32 and bf16, and
   the bounds (f32 FMA rate for f32, bf16 tensor-core rate for bf16).
   Then both kernels at hd 128 (qwen2.5-14b's 40 query heads over 8 kv
   heads, B=1, S=4096, causal), each against its plain version and SDPA
   in its type, beside its bound.  Then MLA (deepseek-v2's prefill
   attention: B=2, S=2048, H=K=128, q and k at hd 192, v at 128 a view of
   the kv projection, causal) on both kernels against the plain version
   at the same tolerances, timed beside the plain version, SDPA (null,
   with the reason, where it refuses) and the bounds; a ragged S=1000 in
   both types; and a misaligned v view (f32 bitwise the aligned one,
   bf16 refused: TMA).  Then both kernels at the ssm phase's attention
   shapes, each against the plain version at the same tolerances and
   timed beside SDPA and the bound: zamba2's shared attention (B=2,
   S=2048, H=K=32, hd 112, causal), whisper's encoder (B=4, S=1500,
   H=K=8, hd 64, non-causal) and its cross-attention (non-causal, Sq =
   448 and Sq = 1 against Skv = 1500).
6. llm: smollm-360m at full width (32 layers, d_model 960), random
   weights from a seed.  ``prefill_step`` on B=4 x S=2048 tokens in f32
   through attention backend "cuda" against "ref" (last-position
   logits and the kv cache, atol 1e-4, rtol 3e-3), exactly 32 flash
   launches per "cuda" prefill, none of them on the tensor cores, and
   none under "ref"; the same in bf16 (finite, max error printed), where
   all 32 are tensor-core launches.  One more prefill of each type gives
   a bound on its device time (the stream sleeps while the host queues
   the work); then ``launch.serve.run`` in bf16 (8
   requests, 4 slots, prompts of 3-11 tokens, 16 new tokens), which only
   decodes and so launches no flash kernel, as in JAX.

7. moe: the moe family at full width, random weights from a seed:
   deepseek-v2 (d_model 5120, 128 heads, MLA ranks 1536 / 512, 160
   experts of 1536, top-6, 2 shared) cut to 3 layers (1 dense-first + 2
   MoE), in f32 then bf16, and llama4-maverick (40 over 8 heads, hd 128,
   128 experts of 8192, top-1, 1 shared, dense d_ff 16384) cut to one
   super-block (2 layers), in bf16 only.  Each: ``prefill_step`` on 2 x
   2048 tokens through "cuda" against "ref" (logits and every cache
   entry: f32 atol 1e-4, rtol 3e-3; bf16 max error), exactly one flash
   launch a layer (all on the tensor cores in bf16), the capacity and
   the share of token-slots dropped by each MoE layer, the weights in
   GiB and the peak memory, the prefill's warm and first ms and its
   device-time bound, and one ``moe_block`` at the prefill shape split
   into routing and dispatch, expert FFN and combine; then
   ``launch.serve.run`` in bf16 (8 requests, 4 slots, 16 new tokens),
   with no flash launch, and its tokens/s.

8. ssm: the recurrent and encoder-decoder families at full width,
   random weights from a seed, in f32 then bf16.  mamba2-1.3b (48
   layers, d_model 2048, 64 SSM heads of 64, d_state 128, chunk 256):
   ``prefill_step`` on 4 x 2048 tokens through "cuda" bitwise "ref" (it
   has no attention: no kernel launch), then ``launch.serve.run`` in
   bf16 (8 requests, 4 slots, 16 new tokens).  zamba2-7b (81 layers = 13
   super-blocks of 6 + 3 tail, d_model 3584, 32 heads of hd 112, LoRA
   rank 128): 2 x 2048 tokens, "cuda" against "ref" (logits and every
   cache entry: f32 atol 1e-4, rtol 3e-3; bf16 max error), 13 flash
   launches a prefill (all on the tensor cores in bf16), then serving as
   mamba2's.  whisper-base (6 + 6 layers, d_model 512, 8 heads): 4 x 448
   decoder tokens over 1,500 frames, "cuda" against "ref" as zamba2's,
   18 flash launches a prefill, then 16 greedy ``decode_step``s from the
   prefill's cache, 6 flash launches each (the cross-attention), the
   first step's logits against "ref".  Each prints the weights and peak
   memory, the prefill's warm and first ms, "ref"'s ms and a bound on
   its device time, and the decode tokens/s.

9. train: smollm-360m at full width, random weights from a seed.  (a)
   One f32 step's two halves from the same params and batch (4 x 2048):
   ``train.step.loss_and_grads`` through attention backend "cuda" (the
   flash kernel in the forward and in each checkpointed layer's
   recompute: 2 launches a layer, the plain version's gradient) and
   "ref", the loss (atol 1e-4), every gradient element (atol 1e-5, rtol
   1e-3) and the grad norm held against "ref", then ``adamw_update``.
   (c) Those params and AdamW moments through ``save_checkpoint`` and
   ``restore_checkpoint`` (the JAX package's npz layout), bitwise.  (b)
   ``launch.train.run`` in bf16 for 20 steps of 8 x 2048: s a step,
   tokens/s, peak memory, 2 x 32 x 20 flash launches on the tensor
   cores, finite losses.  (d) One bf16 ``train_step`` of llava-next-34b
   at full width cut to 2 layers (2,880 patches + 1,216 text tokens, the
   CE over the ragged text span), 4 tensor-core launches.
10. vlm: llava-next-34b at full width (d_model 7168, 56 over 8 heads,
   hd 128, d_ff 20480, vocab 64000) cut to 8 layers: ``prefill_step``
   over 2,880 patch embeddings of 1,024 and 1,216 tokens in f32 and
   bf16, "cuda" against "ref" (f32 atol 1e-4, rtol 3e-3 on the logits
   and the cache), 8 flash launches a prefill (on the tensor cores in
   bf16), the weights and peak memory, the prefill's warm and first ms
   and its device-time bound.

The line before the last is a JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Needs the repo's
``src/`` beside this file and a CUDA card; exits non-zero without them.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
N_NODES_SCALE = 64               # ogbn-papers100M stand-in: 16384 * 64
FANOUT, D, HEADS, LAYERS = 8, 128, 4, 3
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}      # tests/test_kernels.py:19
FLASH_BF16_TOL = (8e-3, 1e-2)    # atol, rtol: the bf16 flash check
BF16_TC_FLOPS_PER_S = 989e12     # H100 SXM, bf16 tensor cores, dense
LLM_ARCH = "smollm-360m"         # the JAX serving entry points' default
LLM_B, LLM_S = 4, 2048           # prefill batch and length
HD128_ARCH, HD128_S = "qwen2.5-14b", 4096   # the bf16 kernel at hd 128
MLA_ARCH, MLA_B, MLA_S = "deepseek-v2-236b", 2, 2048  # hd 192, vd 128
MOE_B, MOE_S = 2, 2048           # the moe prefill: 4,096 tokens
HD112_ARCH, HD112_B, HD112_S = "zamba2-7b", 2, 2048   # flash at hd 112
SSM_MODELS = (("mamba2-1.3b", 4, 2048), ("zamba2-7b", 2, 2048))  # B, S
WHISPER_ARCH = "whisper-base"    # 30 s of audio: 1,500 encoder frames
WHISPER_B, WHISPER_TOKENS = 4, 448   # whisper's longest decoder sequence
WHISPER_DECODE_STEPS = 16
TRAIN_ARCH, TRAIN_S = "smollm-360m", 2048     # [train]: full width
TRAIN_F32_B, TRAIN_B, TRAIN_STEPS = 4, 8, 20   # f32 step; bf16 run
TRAIN_LOSS_ATOL = 1e-4           # f32 loss, "cuda" against "ref"
TRAIN_GRAD_TOL = (1e-5, 1e-3)    # atol, rtol: tests/test_torch_train.py's
VLM_ARCH, VLM_TEXT = "llava-next-34b", 1216    # 2,880 patches + 1,216 text
VLM_TRAIN_LAYERS, VLM_LAYERS = 2, 8            # depth cuts: train, prefill
MOE_MODELS = (("deepseek-v2-236b", 3, ("float32", "bfloat16")),
              ("llama4-maverick-400b-a17b", 2, ("bfloat16",)))
WIDE_FANOUT = 64                 # benchmarks/bench_accuracy.py's fanout
SERVE_QUERIES, SERVE_ROWS = 64, 256
SERVE_BATCH = {"edge_adds": 4096, "edge_removes": 1024,
               "feature_updates": 1024, "node_adds": 256}
CHUNK_ROWS, BUDGET_ROWS = 4096, 262144
EGO_SCALE = 8                    # the ego baseline's world: 131,072 nodes
EGO_BATCH_FRACTION = 0.06        # benchmarks/bench_e2e.py's batch cap
LAUNCH_TICKS, LAUNCH_BOUND = 6, 16   # the launcher's run: a refresh fires
DIST_MESH = (4, 2)               # examples/allnode_inference.py's mesh
DIST_HEADS_MESH = (2, 4)         # gat's 4 heads need HEADS | M
DIST_TRICKLE = {"edge_adds": 64, "feature_updates": 16, "node_adds": 8}
TUNE_TABLE = ROOT / "build" / "tuned_blocks_smoke.json"   # [tune]'s table
TUNE_REPEATS = 20                # CUDA-event timings a tiling, median
CLUSTER_SHARDS = 2
# [cluster]'s RPC and readiness limits (s): a commit's RPC covers the
# refresh, the WAL append and the compressed checkpoint of a 1,048,576-
# node world, which pass the defaults' 60 s (PERF.md, section 5)
CLUSTER_TIMEOUT_S = 900.0
DEVICE = "cuda"


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(bytes_, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and flops over the f32 peak."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, mod, err, ms, plain_ms, need_bytes, flops,
               library_ms=None):
    """One entry of the kernels JSON line (launches are added later)."""
    bms, by = bound(need_bytes, flops)
    return {"name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def ptxas_spills(text):
    """{mangled entry: (spill store bytes, spill load bytes)} from a
    ``-Xptxas=-v`` report."""
    out, entry = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "spill stores" in line:
            words = line.replace(",", "").split()
            out[entry] = (int(words[words.index("spill") - 2]),
                          int(words[words.index("loads") - 3]))
    return out


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def assert_close(torch, got, want, atol, rtol, what):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    bad = int((err > lim).sum())
    check(bad == 0 and bool(torch.isfinite(got.float()).all()),
          f"{what}: {bad} elements outside atol={atol} rtol={rtol} "
          f"(max err {float(err.max()):.3e})")
    return float(err.max())


# ----------------------------------------------------------------------
# phase 2: kernels
# ----------------------------------------------------------------------

def kernel_phase(torch, kops, lg):
    """Every kernel against its plain version at the main path's shapes;
    returns {name: row of the kernels JSON line, without launches}."""
    from repro_torch.kernels import ref as kref
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    nbr = torch.as_tensor(lg.nbr, device=dev)
    mask = torch.as_tensor(lg.mask, device=dev)
    R, F = nbr.shape
    N = R
    dh = D // HEADS
    live = mask.reshape(-1)
    nnz = int(live.sum())
    uniq = int(torch.unique(nbr.reshape(-1)[live]).numel())
    live_rows = int(mask.any(dim=1).sum())
    log(f"[kernels] R=N={N} F={F} D={D} heads={HEADS}: {nnz} unmasked "
        f"slots of {R * F}, {uniq} distinct source rows, {live_rows} rows "
        "with an unmasked slot")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def quant(*shape):
        return (torch.randint(-32, 32, shape, generator=gen, device=dev)
                * 2.0 ** -6).float()

    table = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    rows = {}

    # -- spmm and gather_spmm (one kernel) ------------------------------
    # GAT's attend: alpha (R, F, heads) as the unfused softmax leaves it, a
    # transposed view the kernel reads in place
    alpha = torch.rand((R, HEADS, F), generator=gen, device=dev).transpose(
        1, 2)
    for name in ("spmm", "gather_spmm"):
        fn, plain, mod = kops.KERNELS[name]
        tbl = (table,) if name == "gather_spmm" else ()
        heads_plain = (kref.gather_spmm_heads_ref if tbl
                       else kref.spmm_heads_ref)

        def call(h, w, use_plain=False, fn=fn, plain=plain, nbr=nbr,
                 mask=mask, **kw):
            if use_plain:
                return plain(h, *tbl, w, nbr, mask)
            return fn(h, *tbl, w, nbr, mask, **kw)

        hq, wq = quant(N, D), quant(R, F)
        e_q = max_err(torch, call(hq, wq), call(hq, wq, use_plain=True))
        check(e_q < 5e-7, f"{name} quantized f32: max err {e_q:.3e}")
        h, w = randn(N, D), randn(R, F)
        out = call(h, w)
        err = assert_close(torch, out, call(h, w, use_plain=True),
                           ATOL["float32"] * F, 3e-2, f"{name} f32")
        hb = h.to(torch.bfloat16)
        assert_close(torch, call(hb, w), call(hb, w, use_plain=True),
                     ATOL["bfloat16"] * F, 3e-2, f"{name} bf16")
        for tiling in ((2, 16), (8, 32)):
            check(torch.equal(out, call(h, w, block_rows=tiling[0],
                                        block_cols=tiling[1])),
                  f"{name}: tilings (default) and {tiling} differ")
        for sub in (torch.arange(0, R, 3, device=dev),
                    torch.arange(1000, 2000, device=dev)):
            check(torch.equal(call(h, w[sub], nbr=nbr[sub], mask=mask[sub]),
                              out[sub]),
                  f"{name}: a row subset differs from the full launch")
        check(bool((out[~mask.any(dim=1)] == 0).all()),
              f"{name}: a row with no live slot is not 0")
        # GAT's attend: all heads in one launch, bitwise the per-head ones
        out_h = call(h, alpha)
        per_head = [call(h[:, k * dh:(k + 1) * dh].contiguous(),
                         alpha[..., k].contiguous()) for k in range(HEADS)]
        check(torch.equal(out_h, torch.cat(per_head, dim=1)),
              f"{name}: heads-weighted launch differs from per-head ones")
        err_h = assert_close(torch, out_h, heads_plain(h, *tbl, alpha, nbr,
                                                       mask),
                             ATOL["float32"] * F, 3e-2, f"{name} heads")
        # per-head shape of GAT's attend before (D = dh), for continuity
        vh = randn(N, dh)
        assert_close(torch, call(vh, w), call(vh, w, use_plain=True),
                     ATOL["float32"] * F, 3e-2, f"{name} f32 D={dh}")
        ms = time_ms(torch, lambda: call(h, w))
        ms_heads = time_ms(torch, lambda: call(h, alpha))
        ms_heads_copies = time_ms(torch, lambda: torch.cat([
            call(h[:, k * dh:(k + 1) * dh].contiguous(),
                 alpha[..., k].contiguous()) for k in range(HEADS)], dim=1))
        plain_ms_heads = time_ms(
            torch, lambda: heads_plain(h, *tbl, alpha, nbr, mask), reps=5)
        ms_head = time_ms(torch, lambda: call(vh, w))
        plain_ms = time_ms(torch, lambda: call(h, w, use_plain=True))
        # the library yardstick: cuSPARSE through torch.sparse.mm
        cols = (table.long()[nbr.long()] if tbl else nbr.long()).reshape(-1)
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.arange(R, device=dev).repeat_interleave(F),
                         cols]), (w * mask).reshape(-1), (R, N),
            check_invariants=False)
        csr = coo.coalesce().to_sparse_csr()
        lib_err = max_err(torch, torch.sparse.mm(csr, h), out)
        lib_ms = time_ms(torch, lambda: torch.sparse.mm(csr, h))
        del coo, csr
        # every mask byte; nbr and w of the live slots; each distinct
        # gathered row once; the output
        need = R * F + nnz * 8 + uniq * D * 4 + R * D * 4
        if tbl:
            need += uniq * 4                             # table entries
        rows[name] = kernel_row(name, mod, err, ms, plain_ms, need,
                                2 * nnz * D, lib_ms)
        r = rows[name]
        # all heads in one launch: w is (R, F, heads)
        need_heads = need + nnz * (HEADS - 1) * 4
        r.update(ms_heads=ms_heads, plain_ms_heads=plain_ms_heads,
                 bound_ms_heads=bound(need_heads, 2 * nnz * D)[0],
                 max_abs_err_heads=err_h,
                 ms_heads_per_head_copies=ms_heads_copies)
        # GAT's attend ran it per head before, at D = dh
        need_h = need - (uniq + R) * (D - dh) * 4
        r["ms_per_head"] = ms_head
        r["bound_ms_per_head"] = bound(need_h, 2 * nnz * dh)[0]
        log(f"[kernels] {name}: quantized err {e_q:.1e} (< 5e-7), f32 err "
            f"{err:.3e} (atol {ATOL['float32'] * F:.1e}, rtol 3e-2), bf16 "
            f"within atol {ATOL['bfloat16'] * F:.2f}; tilings and row "
            f"subsets bitwise equal, rows with no live slot 0; "
            f"{ms:.4f} ms (D={dh}: {ms_head:.4f} ms), plain "
            f"{plain_ms:.4f} ms, torch.sparse.mm {lib_ms:.4f} ms (err "
            f"{lib_err:.1e}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; D={dh}: {r['bound_ms_per_head']:.4f} ms)")
        log(f"[kernels] {name} heads-weighted (D={D}, w (R, {F}, {HEADS}) "
            f"strided): bitwise the {HEADS} per-head launches, err vs plain "
            f"{err_h:.3e}; {ms_heads:.4f} ms (per-head launches on copied "
            f"slices + cat {ms_heads_copies:.4f} ms), plain "
            f"{plain_ms_heads:.4f} ms, bound {r['bound_ms_heads']:.4f} ms")
    del alpha

    # -- gat_attention ----------------------------------------------------
    fn, plain, mod = kops.KERNELS["gat_attention"]
    q, k = quant(N, D), quant(N, D)
    e_q = max_err(torch, fn(q, k, nbr, mask, heads=HEADS),
                  plain(q, k, nbr, mask, HEADS))
    check(e_q < 5e-7, f"gat_attention quantized f32: max err {e_q:.3e}")
    q, k = randn(N, D), randn(N, D)
    out = fn(q, k, nbr, mask, heads=HEADS)
    err = max_err(torch, out, plain(q, k, nbr, mask, HEADS))
    check(err < 5e-7, f"gat_attention random f32: max err {err:.3e}")
    check(bool((out[~mask] == 0).all()), "gat_attention: masked slot != 0")
    check(subset_equal(torch, fn, out, q, k, nbr, mask, heads=HEADS),
          "gat_attention: a row subset differs from the full launch")
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    assert_close(torch, fn(qb, kb, nbr, mask, heads=HEADS),
                 plain(qb, kb, nbr, mask, HEADS), ATOL["bfloat16"], 3e-2,
                 "gat_attention bf16")
    ms = time_ms(torch, lambda: fn(q, k, nbr, mask, heads=HEADS))
    plain_ms = time_ms(torch, lambda: plain(q, k, nbr, mask, HEADS))
    # what the time is made of: half the bytes (bf16), and the same
    # gathers without the softmax (sddmm at the full width)
    ms_bf16 = time_ms(torch, lambda: fn(qb, kb, nbr, mask, heads=HEADS))
    ms_gathers = time_ms(torch, lambda: kops.sddmm(q, k, nbr, mask))
    # q of rows with a live slot, k's distinct rows, every mask byte, nbr
    # of the live slots, alpha for every slot
    need = (live_rows * D * 4 + uniq * D * 4 + R * F + nnz * 4
            + R * F * HEADS * 4)
    rows["gat_attention"] = kernel_row("gat_attention", mod, err, ms,
                                       plain_ms, need, 2 * nnz * D)
    r = rows["gat_attention"]
    log(f"[kernels] gat_attention: quantized err {e_q:.1e} (< 5e-7), f32 "
        f"err {err:.3e} (< 5e-7), bf16 within atol {ATOL['bfloat16']}; "
        f"{ms:.4f} ms (bf16 {ms_bf16:.4f} ms; sddmm at D={D}, its gathers "
        f"without the softmax, {ms_gathers:.4f} ms), plain {plain_ms:.4f} "
        f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); row subsets "
        "bitwise equal")

    # -- sddmm: per-head column slices (N, dh), as CudaExecutor passes --
    fn, plain, mod = kops.KERNELS["sddmm"]
    q, k = quant(N, dh), quant(N, dh)
    e_q = max_err(torch, fn(q, k, nbr, mask), plain(q, k, nbr, mask))
    check(e_q < 5e-7, f"sddmm quantized f32: max err {e_q:.3e}")
    q, k = randn(N, dh), randn(N, dh)
    err = assert_close(torch, fn(q, k, nbr, mask), plain(q, k, nbr, mask),
                       ATOL["float32"] * dh ** 0.5, 3e-2, "sddmm f32")
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    assert_close(torch, fn(qb, kb, nbr, mask), plain(qb, kb, nbr, mask),
                 ATOL["bfloat16"] * dh ** 0.5, 3e-2, "sddmm bf16")
    check(subset_equal(torch, fn, fn(q, k, nbr, mask), q, k, nbr, mask),
          "sddmm: a row subset differs from the full launch")
    # each head's column slice of full-width q and k, read in place, as
    # CudaExecutor.attn_scores passes them: the bits of a contiguous copy
    qw, kw = randn(N, D), randn(N, D)
    for h in range(HEADS):
        qh, kh = qw[:, h * dh:(h + 1) * dh], kw[:, h * dh:(h + 1) * dh]
        check(torch.equal(fn(qh, kh, nbr, mask),
                          fn(qh.contiguous(), kh.contiguous(), nbr, mask)),
              f"sddmm: head {h}'s strided slice differs from its copy")
    ms_strided = time_ms(torch, lambda: fn(qw[:, :dh], kw[:, :dh], nbr, mask))
    del qw, kw
    ms = time_ms(torch, lambda: fn(q, k, nbr, mask))
    plain_ms = time_ms(torch, lambda: plain(q, k, nbr, mask))
    # the library yardstick: cuSPARSE SDDMM through sampled_addmm, over a
    # CSR of the distinct live (i, nbr[i, f]) pairs; `inv` maps each live
    # slot onto its pair (sorted keys are the CSR's order)
    keys = (torch.arange(R, device=dev).repeat_interleave(F) * N
            + nbr.reshape(-1).long())[live]
    pairs, inv = torch.unique(keys, return_inverse=True)
    crow = torch.zeros(R + 1, dtype=torch.long, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(pairs // N, minlength=R), 0)
    pattern = torch.sparse_csr_tensor(
        crow, pairs % N, torch.ones(pairs.numel(), device=dev), (R, N),
        check_invariants=False)
    kt = k.t()
    lib = torch.sparse.sampled_addmm(pattern, q, kt, beta=0.0)
    assert_close(torch, lib.values()[inv],
                 plain(q, k, nbr, mask).reshape(-1)[live],
                 ATOL["float32"] * dh ** 0.5, 3e-2, "sampled_addmm")
    lib_ms = time_ms(torch, lambda: torch.sparse.sampled_addmm(
        pattern, q, kt, beta=0.0))
    pairs_n = pairs.numel()
    del keys, pairs, inv, crow, pattern, lib
    need = live_rows * dh * 4 + uniq * dh * 4 + R * F + nnz * 4 + R * F * 4
    rows["sddmm"] = kernel_row("sddmm", mod, err, ms, plain_ms, need,
                               2 * nnz * dh, lib_ms)
    r = rows["sddmm"]
    log(f"[kernels] sddmm (D={dh}): quantized err {e_q:.1e} (< 5e-7), f32 "
        f"err {err:.3e} (atol {ATOL['float32'] * dh ** 0.5:.1e}, rtol "
        f"3e-2); {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.sparse.sampled_addmm {lib_ms:.4f} ms ({pairs_n} distinct "
        f"pairs), bound {r['bound_ms']:.4f} ms ({r['bound_by']}); row "
        f"subsets and {HEADS} strided head slices bitwise equal, a strided "
        f"slice {ms_strided:.4f} ms")
    for name, r in rows.items():        # recorded, not gated
        log(f"[kernels] {name}: {r['ms'] / r['bound_ms']:.2f}x its bound"
            + (f" ({r['ms_heads'] / r['bound_ms_heads']:.2f}x heads-"
               f"weighted, {r['ms_per_head'] / r['bound_ms_per_head']:.2f}x "
               f"at D={dh})" if "ms_per_head" in r else "")
            + (f", {r['ms'] / r['library_ms']:.2f}x its library call"
               if r["library_ms"] else ""))
    torch.cuda.synchronize()
    return rows


def subset_equal(torch, fn, full, q, k, nbr, mask, **kw):
    """Whether ``fn`` on a row subset (every third row, and rows 1000 to
    1999) gives the bits of the same rows of the full launch ``full``, as
    delta and chunked refresh need."""
    for rows in (torch.arange(0, q.shape[0], 3, device=q.device),
                 torch.arange(1000, 2000, device=q.device)):
        if not torch.equal(fn(q[rows], k, nbr[rows], mask[rows], **kw),
                           full[rows]):
            return False
    return True


def _plain_rows(torch, plain, q, nbr, mask, *args, block=131072, **kw):
    """``plain`` over row blocks, concatenated: the same rows (the plain
    versions compute a row from its own inputs) in bounded memory."""
    return torch.cat([plain(q[i:i + block], *args, nbr[i:i + block],
                            mask[i:i + block], **kw)
                      for i in range(0, q.shape[0], block)])


def gat_wide_phase(torch, kops, lg, lg64, rows):
    """The wide scoring kernel (csrc/gat_attention.cu ``wide_kernel``)
    against the plain versions: gat_attention at fanout 64 (D=128, 4
    heads) and at fanout 8 with D=96 and 3 heads, sddmm at fanout 64;
    adds its fields to the gat_attention and sddmm rows."""
    from repro_torch.kernels import gat_attention as kgat
    from repro_torch.kernels import ref as kref
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def quant(*shape):
        return (torch.randint(-32, 32, shape, generator=gen, device=dev)
                * 2.0 ** -6).float()

    def graph(layer):
        nbr = torch.as_tensor(layer.nbr, device=dev)
        mask = torch.as_tensor(layer.mask, device=dev)
        live = mask.reshape(-1)
        return (nbr, mask, int(live.sum()),
                int(torch.unique(nbr.reshape(-1)[live]).numel()),
                int(mask.any(dim=1).sum()))

    gat_plain = kref.gat_attention_ref
    cases = [("F=64", graph(lg64), D, HEADS), ("heads=3", graph(lg), 96, 3)]
    out = {}
    for tag, (nbr, mask, nnz, uniq, live_rows), width, heads in cases:
        R, F = nbr.shape
        check(kgat.kernel_for(F, width, heads, 4, True) == "wide",
              f"gat_attention {tag}: not the wide kernel's shape")
        fn = kops.gat_attention
        w0 = fn.launches_wide
        q, k = quant(R, width), quant(R, width)
        e_q = max_err(torch, fn(q, k, nbr, mask, heads=heads),
                      _plain_rows(torch, gat_plain, q, nbr, mask, k,
                                  heads=heads))
        check(e_q < 5e-7, f"gat_attention {tag} quantized f32: max err "
              f"{e_q:.3e}")
        q, k = randn(R, width), randn(R, width)
        got = fn(q, k, nbr, mask, heads=heads)
        err = assert_close(torch, got, _plain_rows(
            torch, gat_plain, q, nbr, mask, k, heads=heads),
            ATOL["float32"], 3e-2, f"gat_attention {tag} f32")
        check(bool((got[~mask] == 0).all()),
              f"gat_attention {tag}: masked slot != 0")
        check(subset_equal(torch, fn, got, q, k, nbr, mask, heads=heads),
              f"gat_attention {tag}: a row subset differs")
        qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
        assert_close(torch, fn(qb, kb, nbr, mask, heads=heads),
                     _plain_rows(torch, gat_plain, qb, nbr, mask, kb,
                                 heads=heads), ATOL["bfloat16"], 3e-2,
                     f"gat_attention {tag} bf16")
        check(fn.launches_wide > w0, f"gat_attention {tag}: no wide launch")
        ms = time_ms(torch, lambda: fn(q, k, nbr, mask, heads=heads))
        plain_ms = time_ms(torch, lambda: _plain_rows(
            torch, gat_plain, q, nbr, mask, k, heads=heads), reps=3)
        need = (live_rows * width * 4 + uniq * width * 4 + R * F + nnz * 4
                + R * F * heads * 4)
        bms = bound(need, 2 * nnz * width)[0]
        # the same with every live slot's k row read from memory once (the
        # gathers hit a 1,048,576-row table, far larger than L2)
        per_slot = bound(need + (nnz - uniq) * width * 4, 2 * nnz * width)[0]
        out[tag] = (err, ms, plain_ms, bms)
        log(f"[gat-wide] gat_attention {tag} (N={R} F={F} D={width} heads="
            f"{heads}, {nnz} live slots): quantized err {e_q:.1e} (< 5e-7), "
            f"f32 err {err:.3e} (atol {ATOL['float32']}, rtol 3e-2), bf16 "
            f"within atol {ATOL['bfloat16']}; row subsets bitwise; "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({ms / bms:.2f}x; {per_slot:.4f} ms with a k row read a live "
            "slot)")
        del q, k, qb, kb, got
    r = rows["gat_attention"]
    r.update(max_abs_err_wide=out["F=64"][0], ms_wide=out["F=64"][1],
             plain_ms_wide=out["F=64"][2], bound_ms_wide=out["F=64"][3],
             max_abs_err_wide_heads3=out["heads=3"][0],
             ms_wide_heads3=out["heads=3"][1],
             plain_ms_wide_heads3=out["heads=3"][2],
             bound_ms_wide_heads3=out["heads=3"][3])

    # sddmm at fanout 64, per-head width as CudaExecutor passes it
    nbr, mask, nnz, uniq, live_rows = cases[0][1]
    R, F = nbr.shape
    dh = D // HEADS
    fn, plain = kops.sddmm, kref.sddmm_ref
    w0 = fn.launches_wide
    q, k = quant(R, dh), quant(R, dh)
    e_q = max_err(torch, fn(q, k, nbr, mask),
                  _plain_rows(torch, plain, q, nbr, mask, k))
    check(e_q < 5e-7, f"sddmm F=64 quantized f32: max err {e_q:.3e}")
    q, k = randn(R, dh), randn(R, dh)
    got = fn(q, k, nbr, mask)
    err = assert_close(torch, got, _plain_rows(torch, plain, q, nbr, mask,
                                               k),
                       ATOL["float32"] * dh ** 0.5, 3e-2, "sddmm F=64 f32")
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    assert_close(torch, fn(qb, kb, nbr, mask),
                 _plain_rows(torch, plain, qb, nbr, mask, kb),
                 ATOL["bfloat16"] * dh ** 0.5, 3e-2, "sddmm F=64 bf16")
    check(subset_equal(torch, fn, got, q, k, nbr, mask),
          "sddmm F=64: a row subset differs")
    qw, kw = randn(R, D), randn(R, D)
    for h in range(HEADS):
        qh, kh = qw[:, h * dh:(h + 1) * dh], kw[:, h * dh:(h + 1) * dh]
        check(torch.equal(fn(qh, kh, nbr, mask),
                          fn(qh.contiguous(), kh.contiguous(), nbr, mask)),
              f"sddmm F=64: head {h}'s strided slice differs from its copy")
    del qw, kw
    check(fn.launches_wide > w0, "sddmm F=64: no wide launch")
    ms = time_ms(torch, lambda: fn(q, k, nbr, mask))
    plain_ms = time_ms(torch, lambda: _plain_rows(torch, plain, q, nbr,
                                                  mask, k), reps=3)
    need = live_rows * dh * 4 + uniq * dh * 4 + R * F + nnz * 4 + R * F * 4
    bms = bound(need, 2 * nnz * dh)[0]
    per_slot = bound(need + (nnz - uniq) * dh * 4, 2 * nnz * dh)[0]
    rows["sddmm"].update(max_abs_err_wide=err, ms_wide=ms,
                         plain_ms_wide=plain_ms, bound_ms_wide=bms)
    log(f"[gat-wide] sddmm F=64 (D={dh}): quantized err {e_q:.1e} (< 5e-7), "
        f"f32 err {err:.3e} (atol {ATOL['float32'] * dh ** 0.5:.1e}, rtol "
        f"3e-2), bf16 within tolerance; row subsets and {HEADS} strided "
        f"head slices bitwise; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({ms / bms:.2f}x; {per_slot:.4f} ms with a k row read "
        "a live slot)")
    torch.cuda.synchronize()


# ----------------------------------------------------------------------
# [tune]: the block-size autotuner over the spmm kernels' tilings
# ----------------------------------------------------------------------

def tune_phase(torch, kops, lg):
    """``tuning.ensure_tuned`` for spmm and gather_spmm at the main
    path's shapes into a fresh table (``TUNE_TABLE``), every candidate
    timed with CUDA events (median of ``TUNE_REPEATS``); each
    candidate's output bitwise the default tiling's.  The slice phase's
    gcn session then binds the table (``ExecutorSpec(name="cuda",
    block_table=TUNE_TABLE)``, ``tuned_gcn_check``).  Returns the
    winners."""
    from repro_torch import tuning
    from repro_torch.kernels.spmm import default_tiling
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    nbr = torch.as_tensor(lg.nbr, device=dev)
    mask = torch.as_tensor(lg.mask, device=dev)
    R, F = nbr.shape
    h = torch.randn((R, D), generator=gen, device=dev)
    w = torch.rand((R, F), generator=gen, device=dev)
    table = torch.randperm(R, generator=gen, device=dev).to(torch.int32)
    calls = {"spmm": lambda **kw: kops.spmm(h, w, nbr, mask, **kw),
             "gather_spmm": lambda **kw: kops.gather_spmm(
                 h, table, w, nbr, mask, **kw)}
    TUNE_TABLE.parent.mkdir(exist_ok=True)
    TUNE_TABLE.unlink(missing_ok=True)
    tb = tuning.BlockTable(path=TUNE_TABLE)
    winners = {}
    for name, call in calls.items():
        base = call()
        timed = []

        def make_call(blocks, call=call):
            def fn():
                call(**blocks)
            fn.blocks = blocks
            return fn

        def timer(fn, repeats, timed=timed):
            t = tuning.cuda_event_timer(fn, repeats)
            timed.append((fn.blocks, t))
            return t

        t0 = time.perf_counter()
        best = tuning.ensure_tuned(tb, name, make_call, N=R, D=D,
                                   timer=timer, repeats=TUNE_REPEATS,
                                   backend=dev.type)
        search_s = time.perf_counter() - t0
        for blocks, _ in timed:
            check(torch.equal(call(**blocks), base),
                  f"[tune] {name}: tiling {blocks} differs from the "
                  "default's bits")
        check(tuning.BlockTable.load(TUNE_TABLE).lookup(
            name, N=R, D=D, backend=dev.type) == best,
            f"[tune] {name}: the saved table does not hold {best}")
        default = dict(zip(("block_rows", "block_cols"),
                           default_tiling(D, 16 // h.element_size())))
        log(f"[tune] {name} R={R} F={F} D={D} f32: {len(timed)} tilings "
            f"searched in {search_s:.1f} s, ms (CUDA events, median of "
            f"{TUNE_REPEATS}) " + ", ".join(
                f"{b['block_rows']}x{b['block_cols']} {t * 1e3:.4f}"
                for b, t in timed)
            + f"; winner {best['block_rows']}x{best['block_cols']} "
            f"(default {default['block_rows']}x{default['block_cols']}); "
            "every tiling bitwise the default's")
        winners[name] = best
    return winners


def tuned_gcn_check(torch, kops, s, H, winners):
    """On the slice phase's gcn session, whose executor is
    ``ExecutorSpec(name="cuda", block_table=TUNE_TABLE)``: it picked
    [tune]'s winner, and its ``infer_all`` (``H``) is bitwise the same
    epoch through an untuned ``CudaExecutor`` on the same world (not
    counted: a comparison)."""
    from repro_torch.core.gnn_models import model_spec
    from repro_torch.core.ops import CudaExecutor, DenseIO, run_model
    picked = s.executor._pick_blocks("spmm", s.n_nodes, D, torch.float32)
    check(picked == winners["spmm"],
          f"[tune] the tuned session picked {picked}, not "
          f"{winners['spmm']}")
    ios = [DenseIO.from_layer_graph(lg, s.device) for lg in s.layer_graphs]
    untuned = run_model(CudaExecutor(DEVICE), model_spec("gcn", s.params),
                        ios, s.X)
    check(torch.equal(H, untuned),
          "[tune] the tuned gcn infer_all is not bitwise the untuned one")
    log(f"[tune] gcn Session.infer_all through ExecutorSpec(name=\"cuda\", "
        f"block_table={TUNE_TABLE.relative_to(ROOT)}) ran spmm at "
        f"{picked['block_rows']}x{picked['block_cols']}: bitwise the "
        "untuned executor's epoch")


# ----------------------------------------------------------------------
# phase 3: the slice through Session.infer_all
# ----------------------------------------------------------------------

EXPECTED = {
    "gcn": {"spmm": LAYERS},
    "sage": {"spmm": LAYERS},
    "gat": {"gat_attention": LAYERS, "spmm": LAYERS},
    "gat_unfused": {"sddmm": LAYERS * HEADS, "spmm": LAYERS},
}


def slice_phase(torch, kops, launches, wide, winners):
    """infer_all for each model (gcn's executor bound to [tune]'s table,
    checked by ``tuned_gcn_check``); the gcn and gat (fused) sessions
    then run the serving phase (``serve_session``)."""
    from repro_torch import obs
    from repro_torch.api import (DealConfig, ExecutorSpec, GraphSpec,
                                 ModelSpec, QoSSpec, Session, StoreSpec)
    from repro_torch.core.gnn_models import model_spec
    from repro_torch.core.ops import DenseIO, RefExecutor, run_model

    runs = [("gcn", "gcn", 1, True), ("sage", "sage", 1, True),
            ("gat", "gat", HEADS, True), ("gat_unfused", "gat", HEADS, False)]
    for label, model, heads, fused in runs:
        cfg = DealConfig(
            graph=GraphSpec(dataset="ogbn-papers100M", scale=N_NODES_SCALE,
                            fanout=FANOUT, seed=0),
            model=ModelSpec(name=model, n_layers=LAYERS, d_feature=D,
                            heads=heads),
            executor=ExecutorSpec(
                name="cuda", options={"fused_attention": fused},
                block_table=str(TUNE_TABLE) if label == "gcn" else None),
            store=StoreSpec(n_shards=4, onboarding="tail"),
            qos=QoSSpec(staleness_bound=1 << 30))
        t0 = time.perf_counter()
        with Session.build(cfg, device=DEVICE) as s:
            t_build = time.perf_counter() - t0
            kops.reset_launch_counts()
            H = s.infer_all()
            counts = kops.launch_counts()
            wide["gat_attention"] += kops.gat_attention.launches_wide
            wide["sddmm"] += kops.sddmm.launches_wide
            cold = s.timings["infer_s"]
            want = {k: EXPECTED[label].get(k, 0) for k in counts}
            check(counts == want, f"{label}: launches {counts}, expected "
                  f"{want}")
            for k, v in counts.items():
                launches[k] += v
            check(tuple(H.shape) == (s.n_nodes, D)
                  and H.device.type == DEVICE,
                  f"{label}: output {tuple(H.shape)} on {H.device}")
            check(bool(torch.isfinite(H).all()), f"{label}: non-finite")
            # the epoch again, warm, over infer_all's own scope, in three
            # synchronized parts: the DenseIO build (host-to-device copies,
            # and the host's mean weights where the model reads them),
            # ex.prepare(X) and run_model
            spec = model_spec(model, s.params)
            parts = {}

            def part(key, fn):
                torch.cuda.synchronize()
                t = time.perf_counter()
                value = fn()
                torch.cuda.synchronize()
                parts[key] = time.perf_counter() - t
                return value

            def build_ios():
                ios = [DenseIO.from_layer_graph(lg, s.device)
                       for lg in s.layer_graphs]
                if model != "gat":           # gat never reads them
                    _ = [io.mean_w for io in ios]
                return ios
            ios = part("dense_io", build_ios)
            X = part("prepare", lambda: s.executor.prepare(s.X))
            part("run_model", lambda: run_model(s.executor, spec, ios, X))
            warm = sum(parts.values())
            # once more under spans: run_layer synchronizes each op then
            tel = obs.Telemetry()
            prev = obs.install(tel)
            try:
                run_model(s.executor, spec, ios, X)
            finally:
                obs.install(prev)
            per_op = {}
            for span_name, _, dur, _, _ in tel.tracer.events_in_order():
                per_op[span_name] = per_op.get(span_name, 0) + dur / 1e6
            H_ref = run_model(RefExecutor(DEVICE), spec, ios, s.X)
            err = assert_close(torch, H, H_ref, 1e-4, 3e-3,
                               f"{label} cuda vs ref")
            log(f"[slice] {label}: N={s.n_nodes} E={s.graph.n_edges} "
                f"built in {t_build:.1f} s; infer_all {cold:.4f} s "
                f"(again, warm: {warm:.4f} s = DenseIO build "
                f"{parts['dense_io']:.4f} + prepare {parts['prepare']:.4f} + "
                f"run_model {parts['run_model']:.4f}); launches "
                f"{ {k: v for k, v in counts.items() if v} }; max err vs "
                f"ref {err:.3e}")
            log(f"[slice] {label} run_model under spans, ms per op kind "
                "(each op synchronized): " + ", ".join(
                    f"{k} {v:.3f}" for k, v in sorted(per_op.items())))
            if label == "gcn":
                tuned_gcn_check(torch, kops, s, H, winners)
            if label != "gat_unfused":
                layerwise_check(torch, kops, s, label, H, launches)
            lg0 = s.layer_graphs[0]
            del H, H_ref, ios, X
            torch.cuda.empty_cache()
            if label in ("gcn", "gat"):
                serve_session(torch, kops, s, label, launches, wide)
        torch.cuda.empty_cache()
    return lg0


# ----------------------------------------------------------------------
# phase 3, [layerwise]: the layer-wise engines and the ego baseline
# ----------------------------------------------------------------------

def layerwise_check(torch, kops, s, label, H, launches):
    """``local_<model>_infer`` over the open slice-phase session's layer
    graphs, X and params through "cuda": bitwise ``Session.infer_all``'s
    ``H``, within atol 1e-4, rtol 3e-3 of the same engine through
    "ref"; its launches go to ``launches``."""
    from repro_torch.core.layerwise import LOCAL_ENGINES
    engine = LOCAL_ENGINES[s.cfg.model.name]

    def run(executor):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine(s.layer_graphs, s.X, s.params, executor=executor,
                     device=DEVICE)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    kops.reset_launch_counts()
    got, ms = run("cuda")
    counts = kops.launch_counts()
    want = {k: EXPECTED[label].get(k, 0) for k in counts}
    check(counts == want, f"[layerwise] {label}: launches {counts}, "
          f"expected {want}")
    for k, v in counts.items():
        launches[k] += v
    check(torch.equal(got, H), f"[layerwise] local_{label}_infer is not "
          "bitwise Session.infer_all through the same executor")
    ref, ref_ms = run("ref")
    err = assert_close(torch, got, ref, 1e-4, 3e-3,
                       f"[layerwise] local_{label}_infer cuda vs ref")
    log(f"[layerwise] local_{label}_infer N={s.n_nodes} D={D}: "
        f"{ms:.1f} ms (\"ref\" {ref_ms:.1f} ms; DenseIO builds included), "
        f"launches { {k: v for k, v in counts.items() if v} }; bitwise "
        f"Session.infer_all; max err vs ref {err:.3e} (atol 1e-4, rtol "
        "3e-3)")


def ego_phase(torch, kops, launches):
    """``ego_batched_gcn_infer`` (the DGI/SALIENT++-style baseline of Fig
    14) against ``local_gcn_infer`` on the stand-in at ``EGO_SCALE``,
    batches of ``EGO_BATCH_FRACTION`` of the nodes: within atol 1e-4,
    rtol 1e-4, its work in GEMM rows beside DEAL's 3 N, both times."""
    from repro_torch.api import (DealConfig, ExecutorSpec, GraphSpec,
                                 ModelSpec, Session)
    from repro_torch.core.layerwise import (ego_batched_gcn_infer,
                                            local_gcn_infer)
    cfg = DealConfig(
        graph=GraphSpec(dataset="ogbn-papers100M", scale=EGO_SCALE,
                        fanout=FANOUT, seed=0),
        model=ModelSpec(name="gcn", n_layers=LAYERS, d_feature=D),
        executor=ExecutorSpec(name="cuda"))
    with Session.build(cfg, device=DEVICE) as s:
        N = s.n_nodes
        batch = int(N * EGO_BATCH_FRACTION)
        args = (s.layer_graphs, s.X, s.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deal = local_gcn_infer(*args, device=DEVICE)
        torch.cuda.synchronize()
        deal_s = time.perf_counter() - t0
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        H, work = ego_batched_gcn_infer(*args, batch, device=DEVICE)
        torch.cuda.synchronize()
        ego_s = time.perf_counter() - t0
        counts = kops.launch_counts()
    n_batches = -(-N // batch)
    want = {k: (LAYERS * n_batches if k == "spmm" else 0) for k in counts}
    check(counts == want, f"[ego] launches {counts}, expected {want}")
    launches["spmm"] += counts["spmm"]
    err = assert_close(torch, H, deal, 1e-4, 1e-4,
                       "[layerwise] ego baseline vs local_gcn_infer")
    log(f"[layerwise] ego_batched_gcn_infer N={N} (scale {EGO_SCALE}), "
        f"{n_batches} batches of {batch} targets: {work} GEMM rows against "
        f"DEAL's {LAYERS * N} ({work / (LAYERS * N):.2f}x), {ego_s:.2f} s "
        f"against local_gcn_infer's {deal_s:.2f} s; max err {err:.3e} "
        f"(atol 1e-4, rtol 1e-4), bitwise equal: {torch.equal(H, deal)}; "
        f"{counts['spmm']} spmm launches")


# ----------------------------------------------------------------------
# phase 4, [launcher]: the serving launcher under telemetry
# ----------------------------------------------------------------------

def launcher_phase(torch, kops, launches):
    """``repro_torch.launch.serve_embeddings``' own functions on gcn in
    the [serve] phase's world, telemetry on with the endpoint on a free
    port and a snapshot file: ``drive`` for a few ticks while a thread
    scrapes /metrics, /healthz and /stats; then the dumped trace through
    ``validate_trace`` (coverage >= 0.9) and ``check_trace``, its stage
    breakdown, and the endpoint stopped by ``close()``."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from repro_torch.launch import serve_embeddings as se
    from repro_torch.obs import report
    from repro_torch.obs.validate import DEFAULT_CATS, validate_trace
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    snap, trace = out / "launcher_snapshot.json", out / "launcher_trace.json"
    snap.unlink(missing_ok=True)
    args = se.build_parser().parse_args([
        "--dataset", "ogbn-papers100M", "--scale", str(N_NODES_SCALE),
        "--fanout", str(FANOUT), "--layers", str(LAYERS), "--d-feature",
        str(D), "--model", "gcn", "--n-shards", "4", "--executor", "cuda",
        "--staleness-bound", str(LAUNCH_BOUND)])
    cfg = se.config_from_args(args)
    t = cfg.telemetry
    t.enabled, t.http_port, t.snapshot_path = True, 0, str(snap)
    t.snapshot_every_s = 0.5
    cfg.validate()
    paths = ("/metrics", "/healthz", "/stats")
    scrapes = {p: [] for p in paths}
    failures = []
    stop = threading.Event()

    def get(url):
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()

    def scrape(base):
        while not stop.is_set():
            for p in paths:
                try:
                    scrapes[p].append(get(base + p))
                except Exception as exc:    # surfaced by the check below
                    failures.append(f"{p}: {exc!r}")
            stop.wait(0.2)

    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with se._serve_session(cfg, DEVICE) as s:
        t_up = time.perf_counter() - t0
        base = f"http://127.0.0.1:{s.endpoint.port}"
        th = threading.Thread(target=scrape, args=(base,), daemon=True)
        th.start()
        t1 = time.perf_counter()
        se.drive(s.engine, ticks=LAUNCH_TICKS, queries_per_tick=4,
                 mutations_per_tick=8)
        torch.cuda.synchronize()
        t_drive = time.perf_counter() - t1
        stop.set()
        th.join(timeout=60)
        check(not th.is_alive(), "[launcher] the scraper hung")
        counts = kops.launch_counts()
        for p in paths:                  # once more after the run
            scrapes[p].append(get(base + p))
        try:
            get(base + "/nope")
            check(False, "[launcher] an unknown path did not 404")
        except urllib.error.HTTPError as exc:
            check(exc.code == 404, f"[launcher] /nope gave {exc.code}")
        st, n = s.engine.stats(), s.n_nodes
        ep, n_snap = s.endpoint, s.endpoint.n_snapshots
        doc = s.dump_trace(trace)
        coverage = s.telemetry.tracer.coverage()
    check(not failures, f"[launcher] scrapes failed: {failures[:3]}")
    check(all(code == 200 for p in paths for code, _ in scrapes[p]),
          "[launcher] a scrape did not return 200")
    check(b"deal_" in scrapes["/metrics"][-1][1],
          "[launcher] /metrics holds no deal_ series")
    health = json.loads(scrapes["/healthz"][-1][1])
    stats = json.loads(scrapes["/stats"][-1][1])
    check(stats["n_served"] == st["n_served"] > 0,
          "[launcher] /stats disagrees with the engine")
    check(st["n_refreshes"] >= 1, "[launcher] no refresh fired")
    try:
        get(base + "/stats")
        check(False, "[launcher] the endpoint still serves after close()")
    except (urllib.error.URLError, ConnectionError, OSError):
        pass
    check(ep.n_snapshots >= 1 and "stats" in json.loads(snap.read_text()),
          "[launcher] no snapshot written")
    check(counts["gather_spmm"] > 0, f"[launcher] launches {counts}")
    for k, v in counts.items():
        launches[k] += v
    cats = tuple(DEFAULT_CATS.split(","))
    problems, summary = validate_trace(doc, 0.9, cats,
                                       ("serve.tick", "refresh.layer"))
    check(not problems, f"[launcher] trace: {problems}")
    problems = report.check_trace(doc)
    check(not problems, f"[launcher] check_trace: {problems}")
    agg = report.stage_breakdown(doc)
    top = sorted(agg.items(), key=lambda kv: -kv[1]["total_ms"])[:14]
    spans = sorted((e for e in doc["traceEvents"] if e.get("ph") == "X"),
                   key=lambda e: e["ts"])
    by_cat = {}                          # top-level spans only: no overlap
    for e in spans:
        if e["args"]["depth"] == 0 and e["name"] != "serve.query":
            cat = e["name"].split(".", 1)[0]
            by_cat[cat] = by_cat.get(cat, 0.0) + e["dur"] / 1e3
    gaps = []                 # stretches of the window no span covers
    hi, last = spans[0]["ts"] + spans[0]["dur"], spans[0]["name"]
    for e in spans[1:]:
        if e["ts"] > hi:
            gaps.append(((e["ts"] - hi) / 1e3, last, e["name"]))
        if e["ts"] + e["dur"] > hi:
            hi, last = e["ts"] + e["dur"], e["name"]
    tick0 = min(e["ts"] for e in spans if e["name"] == "serve.tick")
    ops_ms = sum(e["dur"] for e in spans if e["name"].startswith("ops.")
                 and e["ts"] >= tick0) / 1e3
    log(f"[launcher] serve_embeddings gcn N={n} on \"cuda\": session "
        f"build and full "
        f"epoch {t_up:.1f} s, {LAUNCH_TICKS} ticks and the drain "
        f"{t_drive:.2f} s, {st['n_served']} queries, {st['n_refreshes']} "
        f"refreshes (staleness bound {LAUNCH_BOUND}); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    log(f"[launcher] endpoint: {sum(len(v) for v in scrapes.values())} "
        f"scrapes of {', '.join(paths)}, all 200 (health "
        f"{health['status']}), /nope 404, stopped by close(); "
        f"{ep.n_snapshots} snapshots to {snap.relative_to(ROOT)} "
        f"({n_snap} while serving, one on close)")
    log(f"[launcher] trace {trace.relative_to(ROOT)}: {summary['n_spans']} "
        f"spans over {summary['window_ms'] / 1e3:.2f} s, coverage "
        f"{summary['coverage']:.4f} (tracer {coverage:.4f}; >= 0.9), "
        f"{summary['n_categories']} categories, validate_trace and "
        "check_trace pass")
    log("[launcher] ms per span category, top-level spans (queries "
        "apart): " + ", ".join(f"{c} {v:.1f}" for c, v in
                               sorted(by_cat.items(), key=lambda kv: -kv[1]))
        + "; uncovered: " + ", ".join(
            f"{ms:.1f} ms after {a} before {b}"
            for ms, a, b in sorted(gaps, reverse=True)[:3]))
    log("[launcher] the ticks: serve.refresh ms " + ", ".join(
        f"{e['dur'] / 1e3:.1f}" for e in spans
        if e["name"] == "serve.refresh") + "; refresh.frontier ms "
        + ", ".join(f"{e['dur'] / 1e3:.1f}" for e in spans
                    if e["name"] == "refresh.frontier")
        + "; refresh.layer ms (rows) " + ", ".join(
            f"{e['dur'] / 1e3:.1f} ({e['args']['rows']})" for e in spans
            if e["name"] == "refresh.layer")
        + f"; all ops.* spans in the ticks {ops_ms:.1f} ms")
    log("[launcher] stage breakdown, top spans (count, total ms): "
        + ", ".join(f"{n} {int(a['count'])} {a['total_ms']:.1f}"
                    for n, a in top))


# ----------------------------------------------------------------------
# phase 4: fused feature prep
# ----------------------------------------------------------------------

def featprep_phase(torch, kops, lg, launches):
    import numpy as np

    from repro_torch.core.feature_prep import (fused_load_spmm,
                                               write_feature_files)
    from repro_torch.core.ops import CudaExecutor, RefExecutor
    N = lg.n_nodes
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        files, _ = write_feature_files(tmp, N, D, n_files=8, seed=0)
        w = np.random.default_rng(1).standard_normal((D, D)).astype(
            np.float32) * D ** -0.5
        kops.reset_launch_counts()
        got, stats = fused_load_spmm(files, 4, N, D, w, lg,
                                     CudaExecutor(DEVICE))
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        want, _ = fused_load_spmm(files, 4, N, D, w, lg,
                                  RefExecutor(DEVICE))
    check(counts["gather_spmm"] >= 1 and counts["spmm"] == 0,
          f"fused feature prep: launches {counts}")
    for k, v in counts.items():
        launches[k] += v
    err = assert_close(torch, got, want, 1e-4, 3e-3, "fused_load_spmm")
    log(f"[featprep] fused_load_spmm N={N} D={D}: {stats['seconds']:.2f} s "
        f"host+device, launches {counts['gather_spmm']} gather_spmm, max "
        f"err vs ref {err:.3e}")


# ----------------------------------------------------------------------
# phase 3, [serve]: the serving tier through Session.serve
# ----------------------------------------------------------------------

def gemm_check(torch):
    """Whether a row of ``torch.matmul`` keeps its bits as the row count
    M of the call changes (against M = 1,048,576), and that the
    executors' ``gemm_rows`` does for any M; its time beside one
    matmul at 1,048,576 rows, with its row count a call and with 4096."""
    from repro_torch.core import ops as cops
    from repro_torch.core.ops import GEMM_ROWS, gemm_rows
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    M = 1 << 20
    X = torch.randn((M, D), generator=gen, device=dev)
    W = torch.randn((D, D), generator=gen, device=dev)
    full, blocked = X @ W, gemm_rows(X, W)
    agree = {}
    for m in (256, 3000, 4096, 16384, 65536, 524288):
        idx = torch.randperm(M, generator=gen, device=dev)[:m]
        agree[m] = bool(torch.equal(X[idx] @ W, full[idx]))
        check(torch.equal(gemm_rows(X[idx], W), blocked[idx]),
              f"gemm_rows: rows of an M={m} call differ from M={M}")
    ms = time_ms(torch, lambda: X @ W)
    ms_rows = {}
    try:
        for rows in (4096, GEMM_ROWS):
            cops.GEMM_ROWS = rows
            ms_rows[rows] = time_ms(torch, lambda: gemm_rows(X, W))
    finally:
        cops.GEMM_ROWS = GEMM_ROWS
    log(f"[serve] torch.matmul f32 ({D} x {D}): a row's bits equal "
        f"M={M}'s at M = " + ", ".join(f"{m}: {v}" for m, v in agree.items())
        + f"; gemm_rows ({GEMM_ROWS} rows a call) equal at every M; at "
        f"M={M} one matmul {ms:.4f} ms, gemm_rows " + ", ".join(
            f"{v:.4f} ms at {r} rows a call" for r, v in ms_rows.items()))
    del X, full, blocked


def _mutations(rng, graph, n):
    """One seeded mutation batch as log calls: edge adds (those wiring the
    new nodes included), removals of present edges, feature updates and
    node adds with features."""
    import numpy as np
    k = SERVE_BATCH["node_adds"]
    new = np.arange(n, n + k)
    wire_src = np.concatenate([rng.integers(0, n, 2 * k), new])
    wire_dst = np.concatenate([np.repeat(new, 2), rng.integers(0, n, k)])
    rest = SERVE_BATCH["edge_adds"] - wire_src.size
    e = rng.choice(graph.n_edges, SERVE_BATCH["edge_removes"], replace=False)
    rm_dst = np.searchsorted(graph.indptr, e, side="right") - 1
    rm_src = graph.indices[e]
    fid = rng.choice(n, SERVE_BATCH["feature_updates"], replace=False)
    return [("add_nodes", (k, rng.standard_normal((k, D), np.float32))),
            ("add_edges", (rng.integers(0, n, rest),
                           rng.integers(0, n, rest))),
            ("add_edges", (wire_src, wire_dst)),
            ("remove_edges", (rm_src, rm_dst)),
            ("update_features", (fid, rng.standard_normal(
                (fid.size, D), np.float32)))]


def _apply(log, batch):
    for name, args in batch:
        getattr(log, name)(*args)


def serve_session(torch, kops, s, label, launches, wide):
    """The serving tier through the open slice-phase Session ``s`` (its
    world as built: no second graph build); adds the phase's launches
    to ``launches`` and the wide scoring kernel's to ``wide``."""
    import copy

    import numpy as np

    from repro_torch import gnnserve as gs
    from repro_torch import obs
    from repro_torch.core.ops import DenseIO, RefExecutor
    from repro_torch.gnnserve import delta as gdelta

    tenant = gs.parse_tenants("t:1:1:0:1")     # due at one pending op

    class TimedIO(DenseIO):
        """DenseIO that adds its build time (host arrays, copies to the
        card, and the mean weights where the model reads them) to
        ``spent``."""
        spent, mean_w_too = 0.0, True

        def __init__(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            super().__init__(*a, **kw)
            if TimedIO.mean_w_too:
                _ = self.mean_w
            torch.cuda.synchronize()
            TimedIO.spent += time.perf_counter() - t

    model = s.cfg.model.name
    counts = {k: 0 for k in kops.KERNELS}

    def counted(fn):
        """Run one step of the serving path with the launch counts
        set to 0 just before it and added up just after."""
        kops.reset_launch_counts()
        value = fn()
        torch.cuda.synchronize()
        for k, v in kops.launch_counts().items():
            counts[k] += v
        wide["gat_attention"] += kops.gat_attention.launches_wide
        wide["sddmm"] += kops.sddmm.launches_wide
        return value

    def span_s(tel, prefix):
        """Seconds in the spans whose names start with ``prefix``.  An
        ops.* span synchronizes its op: it holds the op's work on the
        card and the host reads the op triggers (the mean weights where
        the DenseIO build did not make them, gat's target rows)."""
        return sum(ev[2] for ev in tel.tracer.events_in_order()
                   if ev[0].startswith(prefix)) / 1e9

    n = s.n_nodes
    rng = np.random.default_rng(0)
    tel = obs.Telemetry()
    with obs.use(tel):
        eng = counted(s.serve)
    epoch_s, epoch_ops = s.timings["epoch_s"], span_s(tel, "ops.")
    ids = [rng.integers(0, n, SERVE_ROWS)
           for _ in range(SERVE_QUERIES)]

    def ask(engine, tenant_name="default"):
        qs = [gs.Query(uid=i, node_ids=x, tenant=tenant_name)
              for i, x in enumerate(ids)]
        for q in qs:
            engine.submit(q)
        engine.run()
        check(all(q.done for q in qs), f"{label}: a query hung")
        return qs

    t0 = time.perf_counter()
    qs = counted(lambda: ask(eng))
    q_s = time.perf_counter() - t0
    for q in qs:
        check(np.array_equal(q.out, eng.store.lookup(q.node_ids,
                                                     -1)),
              f"{label}: a query's rows differ from the store's")
    batch = _mutations(rng, s.graph, n)
    _apply(s.apply_mutations(), batch)
    TimedIO.spent, TimedIO.mean_w_too = 0.0, model != "gat"
    gdelta.DenseIO = TimedIO
    tel = obs.Telemetry()
    try:
        with obs.use(tel):
            t0 = time.perf_counter()
            stats = counted(s.refresh)
            refresh_s = time.perf_counter() - t0
    finally:
        gdelta.DenseIO = DenseIO
    dense_s = TimedIO.spent
    split = {k: span_s(tel, k) for k in ("refresh.resample",
                                         "refresh.frontier",
                                         "refresh.layer", "ops.")}
    st = s.store
    all_ids = np.arange(st.n_nodes)
    got = [st.lookup(all_ids, lvl) for lvl in range(st.n_levels)]
    check(st.n_nodes == n + SERVE_BATCH["node_adds"]
          and st.n_tail_shards == 1,
          f"{label}: onboarding left {st.n_nodes} nodes")
    # 4. a fresh full epoch over the mutated world, same executor
    oracle = gs.DeltaReinference(
        copy.deepcopy(s.reinfer.layer_graphs), model, s.params,
        executor=s.executor).full_levels(got[0])
    for lvl in range(1, len(got)):
        check(np.array_equal(got[lvl], oracle[lvl]),
              f"{label}: level {lvl} of the refreshed store is not "
              "bitwise a fresh full epoch")
    del oracle

    def second(executor, **kw):
        """Another engine over this session's world as built."""
        ri = gs.DeltaReinference(copy.deepcopy(s.layer_graphs),
                                 model, s.params, executor=executor)
        store = gs.store_from_inference(
            s.X, ri.full_levels(s.X)[1:], n_shards=4,
            onboarding="tail",
            budget_rows=kw.pop("budget_rows", None))
        if store.budget_rows:
            gs.attach_recompute(store, ri)
        e = gs.EmbeddingServeEngine(store, ri, s.graph,
                                    staleness_bound=1 << 30, **kw)
        _apply(e.mutate(), batch)
        return e

    # 5. chunked, one chunk a step under QoS
    def chunked():
        e = second(s.executor, tenants=tenant,
                   refresh_chunk_rows=CHUNK_ROWS)
        t = time.perf_counter()
        ask(e, "t")
        return e, time.perf_counter() - t
    e2, chunk_s = counted(chunked)
    check(e2.n_refresh_chunks > LAYERS and e2.log.pending == 0,
          f"{label}: chunked refresh ran {e2.n_refresh_chunks} "
          "chunks")
    for lvl in range(len(got)):
        check(np.array_equal(e2.store.lookup(all_ids, lvl),
                             got[lvl]),
              f"{label}: chunked refresh differs at level {lvl}")
    n_chunks = e2.n_refresh_chunks
    del e2

    # 6. a store capped at BUDGET_ROWS rows a level
    def budgeted():
        e = second(s.executor, budget_rows=BUDGET_ROWS)
        e.refresh()
        return e, ask(e), ask(eng)
    e3, qb, qa = counted(budgeted)
    for a, b in zip(qa, qb):
        check(np.array_equal(a.out, b.out),
              f"{label}: the budgeted store served other bytes")
    probe = rng.choice(e3.store.n_nodes, min(16384, n), replace=False)
    for lvl in range(len(got)):
        check(np.array_equal(counted(lambda: e3.store.lookup(
            probe, lvl)), got[lvl][probe]),
            f"{label}: budgeted level {lvl} differs")
    bst = e3.store.stats()
    check(bst["n_recomputes"] > 0 and bst["n_evictions"] > 0,
          f"{label}: no recompute on the budgeted store")
    del e3

    # 7. the same steps through "ref" on the card
    e4 = second(RefExecutor(DEVICE))
    e4.refresh()
    err = 0.0
    for lvl in range(1, len(got)):
        ref_rows = e4.store.lookup(all_ids, lvl)
        err = max(err, assert_close(
            torch, torch.from_numpy(got[lvl]),
            torch.from_numpy(ref_rows), 1e-4, 3e-3,
            f"{label} serve level {lvl} cuda vs ref"))
    del e4, ref_rows

    # 8. fold the tail back in
    t0 = time.perf_counter()
    fold = counted(s.full_epoch)
    fold_s = time.perf_counter() - t0
    check(s.store.n_tail_shards == 0, f"{label}: tail not folded")
    for lvl in range(len(got)):
        check(np.array_equal(s.store.lookup(all_ids, lvl),
                             got[lvl]),
              f"{label}: full_epoch changed level {lvl}")
    del got
    check(counts["gather_spmm"] > 0, f"{label}: no gather_spmm launch")
    if model == "gat":
        check(counts["gat_attention"] > 0,
              f"{label}: no gat_attention launch")
    for k, v in counts.items():
        launches[k] += v
    layers = split["refresh.layer"]
    prologue = (refresh_s - layers - split["refresh.resample"]
                - split["refresh.frontier"])
    log(f"[serve] {label}: N={n}, full epoch {epoch_s:.3f} s (layer ops "
        f"{epoch_ops:.3f} s of it); {SERVE_QUERIES} queries x {SERVE_ROWS} "
        f"rows in {q_s:.3f} s; mutations {SERVE_BATCH}: frontier rows per "
        f"layer {stats['frontier_sizes']}; refresh {refresh_s:.3f} s = "
        f"resample {split['refresh.resample']:.3f} + frontier "
        f"{split['refresh.frontier']:.3f} + layers {layers:.3f} (DenseIO "
        f"build {dense_s:.3f}, layer ops {split['ops.']:.3f}, the rest "
        f"{layers - dense_s - split['ops.']:.3f}: store reads and writes, "
        f"copies) + the rest {prologue:.3f} (graph splice, onboarding, "
        "commit); fresh full epoch bitwise equal")
    log(f"[serve] {label}: chunked ({CHUNK_ROWS} rows, {n_chunks} chunks, "
        f"{chunk_s:.3f} s for the chunks and the queries) bitwise equal; "
        f"budget {BUDGET_ROWS} rows a level: {bst['n_recomputes']} "
        f"recomputes of {bst['rows_recomputed']} rows, "
        f"{bst['n_evictions']} evictions, same bytes; \"cuda\" vs \"ref\" "
        f"max err {err:.3e} (atol 1e-4, rtol 3e-3); full_epoch "
        f"{fold_s:.3f} s over {n + SERVE_BATCH['node_adds']} nodes "
        f"(version {fold['version']}); launches "
        f"{ {k: v for k, v in counts.items() if v} }")


# ----------------------------------------------------------------------
# phase 4, [dist]: the distributed executor on a P x M mesh of shards
# ----------------------------------------------------------------------

def _trickle(rng, n):
    """A trickle batch as log calls: DIST_TRICKLE's node adds (each wired
    by 2 in-edges and 1 out-edge), the rest of its edge adds at random,
    its feature updates."""
    import numpy as np
    k = DIST_TRICKLE["node_adds"]
    new = np.arange(n, n + k)
    wire_src = np.concatenate([rng.integers(0, n, 2 * k), new])
    wire_dst = np.concatenate([np.repeat(new, 2), rng.integers(0, n, k)])
    rest = DIST_TRICKLE["edge_adds"] - wire_src.size
    fid = rng.choice(n, DIST_TRICKLE["feature_updates"], replace=False)
    return [("add_nodes", (k, rng.standard_normal((k, D), np.float32))),
            ("add_edges", (rng.integers(0, n, rest),
                           rng.integers(0, n, rest))),
            ("add_edges", (wire_src, wire_dst)),
            ("update_features", (fid, rng.standard_normal(
                (fid.size, D), np.float32)))]


def dist_phase(torch, kops, launches):
    """``Session.build(cfg).infer_all()`` with executor "dist" on the
    DIST_MESH mesh for gcn, sage and gat (1 head), each within atol 1e-4,
    rtol 3e-3 of the single-card "cuda" executor on the same params;
    ``DistributedLayerwise`` for gat with 4 heads on DIST_HEADS_MESH
    against the 1-head result; then on gcn's layer 0: the primitives
    with the kernels against their plain versions, grouped against
    monolithic, the SPMM and GEMM baselines, and the bytes each DEAL
    SPMM layer copies against ``comm_volume``; then serving through the
    mesh (``serve()``, one trickle batch through ``refresh()``, every
    level bitwise a dist full epoch) and a second session whose local
    cutover routes part of the same refresh off the mesh."""
    from repro_torch import obs
    from repro_torch.api import (DealConfig, ExecutorSpec, GraphSpec,
                                 ModelSpec, PartitionSpec, QoSSpec,
                                 RefreshSpec, Session, StoreSpec)
    from repro_torch.core.gnn_models import model_spec
    from repro_torch.core.layerwise import DistributedLayerwise
    from repro_torch.core.ops import (CudaExecutor, DenseIO, DistExecutor,
                                      run_model)
    from repro_torch.launch.mesh import make_host_mesh

    P, M = DIST_MESH

    def cfg_for(model, cutover=0):
        return DealConfig(
            graph=GraphSpec(dataset="ogbn-papers100M", scale=N_NODES_SCALE,
                            fanout=FANOUT, seed=0),
            model=ModelSpec(name=model, n_layers=LAYERS, d_feature=D),
            partition=PartitionSpec(p=P, m=M),
            executor=ExecutorSpec(name="dist"),
            store=StoreSpec(n_shards=4, onboarding="tail"),
            qos=QoSSpec(staleness_bound=1 << 30),
            refresh=RefreshSpec(dist_local_cutover=cutover))

    def counted(fn, want_launched):
        """fn() with the launch counts set to 0 just before and added to
        ``launches`` just after; the kernels in ``want_launched`` must
        have launched."""
        kops.reset_launch_counts()
        value = fn()
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        for k in want_launched:
            check(counts[k] > 0, f"[dist] {k} never launched: {counts}")
        return value, {k: v for k, v in counts.items() if v}

    def single_card(s, params):
        spec = model_spec(s.cfg.model.name, params)
        ios = [DenseIO.from_layer_graph(lg, s.device)
               for lg in s.layer_graphs]
        return run_model(CudaExecutor(DEVICE), spec, ios, s.X)

    results = {}
    for model in ("gcn", "sage", "gat"):
        t0 = time.perf_counter()
        s = Session.build(cfg_for(model), device=DEVICE)
        t_build = time.perf_counter() - t0
        check(isinstance(s.executor, DistExecutor)
              and (s.executor.P, s.executor.M) == (P, M),
              f"[dist] {model}: executor {s.executor.name}")
        tel = obs.Telemetry()
        with obs.use(tel):
            H, counts = counted(s.infer_all, ["spmm"] + (
                ["sddmm"] if model == "gat" else []))
        per_op = {}
        for name, _, dur, _, _ in tel.tracer.events_in_order():
            if name == "dist.bind" or name.startswith("ops."):
                per_op[name] = per_op.get(name, 0) + dur / 1e9
        bind_s = per_op.pop("dist.bind")
        check(tuple(H.shape) == (s.n_nodes, D) and H.device.type == DEVICE
              and bool(torch.isfinite(H).all()),
              f"[dist] {model}: output {tuple(H.shape)} on {H.device}")
        want = single_card(s, s.params)
        err = assert_close(torch, H, want, 1e-4, 3e-3,
                           f"[dist] {model} {P}x{M} vs single-card cuda")
        ex = s.executor
        log(f"[dist] {model} {P}x{M}: N={s.n_nodes}, session built in "
            f"{t_build:.1f} s; infer_all {s.timings['infer_s']:.4f} s, of "
            f"which dist.bind (plan + layouts) {bind_s:.4f} s, s per op "
            "kind (each op synchronized): " + ", ".join(
                f"{k[4:]} {v:.4f}" for k, v in sorted(per_op.items()))
            + "; bytes "
            f"copied: spmm {ex.comm['spmm']}, sddmm {ex.comm['sddmm']}, "
            f"gemm {ex.comm['gemm']}; launches {counts}; max err vs "
            f"single-card cuda {err:.3e} (atol 1e-4, rtol 3e-3)")
        if model == "gat":
            hp, hm = DIST_HEADS_MESH
            mesh = make_host_mesh(hp, hm, DEVICE)

            def heads4():
                eng = DistributedLayerwise(mesh, s.layer_graphs, "gat",
                                           dict(s.params, heads=HEADS))
                return eng.infer(s.X)
            H4, counts = counted(heads4, ["spmm", "sddmm"])
            err4 = assert_close(torch, H4, H, 1e-4, 3e-3,
                                f"[dist] gat {HEADS} heads on {hp}x{hm} vs "
                                "1 head")
            log(f"[dist] gat {HEADS} heads on {hp}x{hm} "
                f"(DistributedLayerwise): max err vs 1 head on {P}x{M} "
                f"{err4:.3e} (heads=1 semantics); launches {counts}")
        if model == "gcn":
            dist_layer_checks(torch, s)
            results["serve"] = dist_serve(torch, s, counted, _trickle)
            s.close()
            torch.cuda.empty_cache()
            dist_cutover(torch, cfg_for, counted, results["serve"])
        s.close()
        del H, want
        torch.cuda.empty_cache()


def dist_layer_checks(torch, s):
    """On the open gcn session's layer 0 (not counted: comparisons):
    dist SPMM and SDDMM through the kernels against their plain versions
    (the tolerances of tests/test_kernels.py), grouped against
    monolithic, the graph-exchange and all-gather SPMMs and the
    deal_ring and cagnet GEMMs against DEAL's, and per layer the bytes
    the DEAL SPMM copies against ``comm_volume``."""
    from repro_torch.core import primitives as prim
    from repro_torch.core.ops import DistExecutor
    from repro_torch.core.partition import comm_volume
    ex = s.executor
    mesh = ex.mesh
    lgs = s.layer_graphs
    ios = ex.bind(lgs, need_sddmm=True)
    vol = comm_volume(ex.plan, D)
    H = ex.prepare(s.X)
    for l, io in enumerate(ios):
        ex.comm.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.spmm(H, io.mean_w, io)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        v = vol[f"layer{l}"]
        check(ex.comm["spmm"] == mesh.M * v["deal_feature_exchange_B"],
              f"[dist] layer {l}: spmm copied {ex.comm['spmm']} bytes, "
              f"M x comm_volume = {mesh.M * v['deal_feature_exchange_B']}")
        log(f"[dist] bytes layer {l}: DEAL SPMM copied {ex.comm['spmm']} "
            f"(= M x comm_volume's deal_feature_exchange_B "
            f"{v['deal_feature_exchange_B']}; {v['unique_rows']} unique "
            f"rows), padded as the JAX plan ships {ex.comm['spmm_padded']}; "
            f"graph exchange would copy M x {v['graph_exchange_B']} "
            f"({v['duplicated_edge_rows']} edge rows); {ms:.2f} ms host "
            "clock, grouped")
    io = ios[0]
    W = s.params["w"][0]

    def run(executor, what, *args):
        xch = prim.Exchange(mesh)
        out = what(executor, xch, *args)
        torch.cuda.synchronize()
        return out.to_global(DEVICE)

    def spmm_of(e, io_):
        return run(e, lambda e_, x: e_.spmm(H, io_.mean_w, io_))

    kern = spmm_of(ex, io)
    plain_ex = DistExecutor(mesh, kernels="ref")
    plain = spmm_of(plain_ex, io)
    e1 = assert_close(torch, kern, plain, ATOL["float32"] * FANOUT, 3e-2,
                      "[dist] spmm kernels vs plain")
    q = ex.gemm(H, s.params["w"][1])
    scores = run(ex, lambda e_, x: prim.sddmm_ring(
        q, H, io.deal, x, True, "cuda"))
    scores_plain = run(ex, lambda e_, x: prim.sddmm_ring(
        q, H, io.deal, x, True, "ref"))
    e2 = assert_close(torch, scores, scores_plain,
                      ATOL["float32"] * D ** 0.5, 3e-2,
                      "[dist] sddmm kernels vs plain")
    mono_ex = DistExecutor(mesh, grouped=False)
    mono = spmm_of(mono_ex, io)
    e3 = assert_close(torch, mono, kern, 1e-5, 1e-5,
                      "[dist] spmm monolithic vs grouped")
    # the two schedules of §3.5: CUDA events around a layer's SPMM
    # against the host's clock over the same calls (equal: the host's
    # launches set the pace, not the card)
    clocks = {}
    for mode, e in (("grouped", ex), ("monolithic", mono_ex)):
        def one():
            e.spmm(H, io.mean_w, io)
        dev_ms = time_ms(torch, one, reps=5, warmup=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            one()
        torch.cuda.synchronize()
        clocks[mode] = (dev_ms, (time.perf_counter() - t) / 5 * 1e3)
    errs = {}
    for variant in ("graph_exchange", "allgather"):
        e = DistExecutor(mesh, spmm_variant=variant)
        io_v = e.bind(lgs[:1])[0]
        errs[variant] = assert_close(torch, spmm_of(e, io_v), kern, 1e-5,
                                     1e-5, f"[dist] spmm {variant} vs deal")
        errs[variant + "_B"] = e.comm["spmm"]
    hw = ex.gemm(H, W).to_global(DEVICE)
    for variant in ("deal_ring", "cagnet"):
        e = DistExecutor(mesh, gemm_variant=variant)
        errs[variant] = assert_close(torch, e.gemm(H, W).to_global(DEVICE),
                                     hw, 1e-4, 1e-4,
                                     f"[dist] gemm {variant} vs deal")
    dup = run(ex, lambda e_, x: prim.sddmm_ring(q, H, io.deal, x, True,
                                                "cuda", "dup"))
    e4 = assert_close(torch, dup, scores, 2e-4, 1e-4,
                      "[dist] sddmm dup vs deal")
    log(f"[dist] layer 0 on {mesh}: spmm kernels vs plain {e1:.3e}, sddmm "
        f"kernels vs plain {e2:.3e} (tests/test_kernels.py tolerances); "
        f"monolithic vs grouped spmm {e3:.3e}; graph_exchange "
        f"{errs['graph_exchange']:.3e} ({errs['graph_exchange_B']} bytes), "
        f"allgather {errs['allgather']:.3e} ({errs['allgather_B']} bytes) "
        f"vs deal; gemm deal_ring {errs['deal_ring']:.3e}, cagnet "
        f"{errs['cagnet']:.3e} vs deal; sddmm dup vs deal {e4:.3e}")
    log("[dist] layer 0's SPMM, ms per call (CUDA events / host clock, "
        "median of 5 / mean of 5): " + ", ".join(
            f"{mode} {d:.3f} / {h:.3f}" for mode, (d, h) in clocks.items()))


def dist_serve(torch, s, counted, trickle):
    """``serve()`` and one trickle batch through ``refresh()`` on the
    open gcn dist session (no cutover): every level of the refreshed
    store is bitwise a dist full epoch over the mutated layer graphs
    and features (the routed executor of the refresh itself).  Returns
    the refreshed levels and the refresh's last frontier."""
    import numpy as np
    t = time.perf_counter()
    eng, counts = counted(s.serve, ["spmm"])
    epoch_s = time.perf_counter() - t
    n = s.n_nodes
    batch = trickle(np.random.default_rng(0), n)
    for name, args in batch:
        getattr(s.apply_mutations(), name)(*args)
    t = time.perf_counter()
    stats, rcounts = counted(s.refresh, ["spmm", "gather_spmm"])
    refresh_s = time.perf_counter() - t
    ri = s.reinfer
    st = s.stats()
    ids = np.arange(s.store.n_nodes, dtype=np.int64)
    levels = [s.store.lookup(ids, lvl) for lvl in range(LAYERS + 1)]
    t = time.perf_counter()
    oracle = ri.full_levels(levels[0])      # comparison: not counted
    oracle_s = time.perf_counter() - t
    for lvl in range(1, LAYERS + 1):
        check(np.array_equal(levels[lvl], oracle[lvl]),
              f"[dist] serve: level {lvl} is not bitwise a dist full epoch")
    log(f"[dist] serve gcn {s.executor.mesh}: full epoch {epoch_s:.3f} s "
        f"(launches {counts}); trickle of {DIST_TRICKLE} refreshed in "
        f"{refresh_s:.3f} s, frontier {stats['frontier_sizes']} rows, "
        f"launches {rcounts}; every level bitwise a dist full epoch "
        f"({oracle_s:.3f} s); refresh_cutover {st['refresh_cutover']}, "
        f"plan_cache {st['plan_cache']}")
    del oracle
    return levels, stats["frontier_sizes"]


def dist_cutover(torch, cfg_for, counted, served):
    """A second gcn dist session with ``dist_local_cutover`` at the first
    refresh's last frontier: the same trickle's first layer routes to
    the local executor ("cuda") and the last stays on the mesh; every
    level within atol 1e-4, rtol 3e-3 of the uncut refresh (routing
    changes which reduction produced the bits)."""
    import numpy as np

    from repro_torch.api import Session
    levels, frontier = served
    cutover = int(frontier[-1])
    with Session.build(cfg_for("gcn", cutover), device=DEVICE) as s:
        s.serve()
        ri = s.reinfer
        before = (ri.n_local_cutovers, ri.n_dist_layers)
        for name, args in _trickle(np.random.default_rng(0), s.n_nodes):
            getattr(s.apply_mutations(), name)(*args)
        t = time.perf_counter()
        _, counts = counted(s.refresh, ["gather_spmm", "spmm"])
        refresh_s = time.perf_counter() - t
        n_local = ri.n_local_cutovers - before[0]
        n_dist = ri.n_dist_layers - before[1]
        check(n_local > 0 and n_dist > 0,
              f"[dist] cutover {cutover}: {n_local} local and {n_dist} "
              "dist layers; both routes must run")
        ids = np.arange(s.store.n_nodes, dtype=np.int64)
        errs = [assert_close(torch, torch.from_numpy(s.store.lookup(ids,
                                                                    lvl)),
                             torch.from_numpy(levels[lvl]), 1e-4, 3e-3,
                             f"[dist] cutover level {lvl} vs uncut")
                for lvl in range(1, LAYERS + 1)]
        st = s.stats()
        log(f"[dist] cutover at {cutover} rows: refresh {refresh_s:.3f} s, "
            f"{n_local} layer(s) local, {n_dist} on the mesh, launches "
            f"{counts}; max err vs the uncut refresh {max(errs):.3e} (atol "
            f"1e-4, rtol 3e-3); refresh_cutover {st['refresh_cutover']}, "
            f"plan_cache {st['plan_cache']}")


# ----------------------------------------------------------------------
# phase 4, [cluster]: the multi-process cluster tier through Session.serve
# ----------------------------------------------------------------------

def _local_engine(s):
    """A single-process serving engine on the open session's own world
    (its graph, layer graphs, X, params and "cuda" executor), as
    ``Session.serve`` builds one for a config without shards."""
    import copy

    from repro_torch.gnnserve import (DeltaReinference, EmbeddingServeEngine,
                                      store_from_inference)
    cfg = s.cfg
    reinfer = DeltaReinference(
        [copy.deepcopy(lg) for lg in s.layer_graphs], cfg.model.name,
        s.params, sample_seed=cfg.refresh.sample_seed, executor=s.executor)
    levels = reinfer.full_levels(s.X)
    store = store_from_inference(s.X, levels[1:], n_shards=cfg.store.n_shards,
                                 onboarding=cfg.store.onboarding)
    q = cfg.qos
    return EmbeddingServeEngine(store, reinfer, s.graph,
                                batch_slots=q.batch_slots,
                                rows_per_step=q.rows_per_step,
                                staleness_bound=q.staleness_bound)


def _store_digests(store):
    """The worker's ``digest`` op over a store in this process: sha256 of
    every level's rows for all nodes, and of the shard bounds."""
    import hashlib

    import numpy as np
    ids = np.arange(store.n_nodes, dtype=np.int64)
    out = {f"level{lvl}": hashlib.sha256(store.lookup(ids, lvl).tobytes())
           .hexdigest() for lvl in range(store.n_levels)}
    out["bounds"] = hashlib.sha256(
        np.ascontiguousarray(store.bounds).tobytes()).hexdigest()
    return out


def cluster_phase(torch, kops, launches):
    """``Session.build(cfg).serve()`` with ``cluster.n_shards = 2`` on the
    stand-in at 1,048,576 nodes (gat, 4 heads, fused attention, tail
    onboarding): two worker processes on the card, each building the
    world, behind the router.  Against a single-process engine on the
    parent session's own world: 64 queries of 256 rows bitwise before
    and after one trickle commit (DIST_TRICKLE), and every shard's store
    digests equal to the single process's; the commit's refresh and
    checkpoint times split; shard 1 killed with SIGKILL and restarted
    (restore and replay times) while shard 0 runs the checkpoint op,
    digests equal again; the router's
    /healthz scraped once; the workers' gather_spmm and gat_attention
    launches added to the totals; every worker gone after ``close()``."""
    import json as _json
    import resource
    import urllib.request

    import numpy as np

    from repro_torch.api import (ClusterSpec, DealConfig, ExecutorSpec,
                                 GraphSpec, ModelSpec, QoSSpec, Session,
                                 StoreSpec)
    from repro_torch.gnnserve import Query
    from repro_torch.gnnserve.cluster import ClusterEngine

    cfg = DealConfig(
        graph=GraphSpec(dataset="ogbn-papers100M", scale=N_NODES_SCALE,
                        fanout=FANOUT, seed=0),
        model=ModelSpec(name="gat", n_layers=LAYERS, d_feature=D,
                        heads=HEADS),
        executor=ExecutorSpec(name="cuda"),
        store=StoreSpec(n_shards=4, onboarding="tail"),
        qos=QoSSpec(staleness_bound=1 << 30),
        cluster=ClusterSpec(n_shards=CLUSTER_SHARDS, http_port=0,
                            ready_timeout_s=CLUSTER_TIMEOUT_S,
                            hang_timeout_s=CLUSTER_TIMEOUT_S))
    torch.cuda.empty_cache()            # the workers share the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = Session.build(cfg, device=DEVICE)
    t_build = time.perf_counter() - t0
    procs = []
    try:
        eng = s.serve()
        dep = s.cluster
        procs = list(dep.procs)
        check(isinstance(eng, ClusterEngine) and dep.device == DEVICE,
              f"[cluster] serve() gave {type(eng).__name__} on "
              f"{dep.device}")
        sts = dep.router.statuses()
        log(f"[cluster] gat {HEADS} heads, N={s.n_nodes}: parent session "
            f"built in {t_build:.1f} s; {CLUSTER_SHARDS} workers ready in "
            f"{dep.ready_wait_s:.1f} s (" + "; ".join(
                f"shard {st['shard']}: build {st['timings']['build_s']:.1f}"
                f" s, full epoch {st['timings']['epoch_s']:.1f} s"
                for st in sts) + ")")
        n = s.n_nodes
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        local = _local_engine(s)
        local_epoch_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        for k, v in kops.launch_counts().items():
            launches[k] += v
        rng = np.random.default_rng(0)

        def queries(uid0):
            """The same 64 queries through both engines, bitwise."""
            ids = [rng.integers(0, local.store.n_nodes, SERVE_ROWS)
                   for _ in range(SERVE_QUERIES)]
            took = []
            for engine in (eng, local):
                qs = [Query(uid0 + i, x.copy()) for i, x in enumerate(ids)]
                t = time.perf_counter()
                for q in qs:
                    engine.submit(q)
                engine.run()
                took.append(time.perf_counter() - t)
                check(all(q.done for q in qs), "[cluster] a query hung")
                if engine is eng:
                    got = qs
            for a, b in zip(got, qs):
                check(a.served_version == b.served_version
                      and np.array_equal(a.out, b.out),
                      f"[cluster] query {a.uid}: the router's rows are not "
                      "bitwise the single process's")
            return took

        kops.reset_launch_counts()
        q_before = queries(0)
        batch = _trickle(np.random.default_rng(1), n)
        for engine in (eng, local):
            for name, args in batch:
                getattr(engine.mutate(), name)(*args)
        t = time.perf_counter()
        eng.refresh()
        cluster_refresh_s = time.perf_counter() - t
        t = time.perf_counter()
        stats = local.refresh()
        local_refresh_s = time.perf_counter() - t
        q_after = queries(100)
        torch.cuda.synchronize()
        for k, v in kops.launch_counts().items():
            launches[k] += v
        sts = dep.router.statuses()
        log(f"[cluster] {SERVE_QUERIES} queries x {SERVE_ROWS} rows: router "
            f"{q_before[0]:.3f} s, single process {q_before[1]:.3f} s; "
            f"trickle {DIST_TRICKLE} (frontier {stats['frontier_sizes']}): "
            f"the router's commit {cluster_refresh_s:.2f} s (" + "; ".join(
                f"shard {st['shard']}: apply + refresh "
                f"{st['timings']['commit_apply_s']:.2f} s, WAL "
                f"{st['timings']['commit_wal_s']:.3f} s, checkpoint "
                f"{st['timings']['commit_checkpoint_s']:.2f} s"
                for st in sts) + f"), single process {local_refresh_s:.2f} s;"
            f" {SERVE_QUERIES} queries after it: router {q_after[0]:.3f} s, "
            f"single process {q_after[1]:.3f} s; every row bitwise")
        want = _store_digests(local.store)
        ckpt = Path(dep.run_dir) / "shard1.ckpt.npz"
        log(f"[cluster] checkpoint {ckpt.name}: "
            f"{ckpt.stat().st_size / 2**30:.2f} GiB (np.savez_compressed)")
        for d in dep.router.digests():
            check(d["digests"] == want,
                  "[cluster] a shard's store is not bitwise the single "
                  "process's")
        # the workers' launches: each process counts from 0 at its start
        worker_launches = {k: 0 for k in kops.KERNELS}
        for st in sts:
            for k, v in st["kernel_launches"].items():
                worker_launches[k] += v
        mem = {st["shard"]: st["memory"] for st in sts}

        def checkpoint_op():
            """Shard 0's checkpoint op (the same save as a commit's),
            timed round trip, while shard 1 restarts."""
            t = time.perf_counter()
            dep.router.channels[0].request("checkpoint")
            return time.perf_counter() - t

        with ThreadPoolExecutor(1) as pool:
            ckpt_op = pool.submit(checkpoint_op)
            t = time.perf_counter()
            dep.kill_worker(1)
            dep.restart_worker(1)
            restart_s = time.perf_counter() - t
            ckpt_op_s = ckpt_op.result()
        st1 = dep.router.statuses()[1]
        for k, v in st1["kernel_launches"].items():
            worker_launches[k] += v
        check(st1["restored"], "[cluster] shard 1 did not restore its "
              "checkpoint")
        digs = dep.router.digests()
        check(all(d["digests"] == want for d in digs),
              "[cluster] shard 1 did not rejoin bitwise")
        log(f"[cluster] shard 1 killed (SIGKILL) and restarted in "
            f"{restart_s:.1f} s: build {st1['timings']['build_s']:.1f} s, "
            f"restore {st1['timings']['restore_s']:.1f} s, replay "
            f"{st1['timings']['replay_s']:.3f} s ({st1['replayed']} WAL "
            "entries); every shard's digests equal the single process's; "
            f"meanwhile shard 0's checkpoint op took {ckpt_op_s:.2f} s")
        url = f"http://127.0.0.1:{dep.endpoint.port}/healthz"
        with urllib.request.urlopen(url, timeout=60) as r:
            doc = _json.loads(r.read())
        check(doc["status"] in ("ok", "alerting")
              and [sh["shard"] for sh in doc["shards"]] == [0, 1],
              f"[cluster] /healthz: {doc}")
        for k in ("gather_spmm", "gat_attention"):
            check(worker_launches[k] > 0,
                  f"[cluster] the workers never launched {k}: "
                  f"{worker_launches}")
        for k, v in worker_launches.items():
            launches[k] += v
        parent_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        log(f"[cluster] /healthz {doc['status']}; the workers' launches "
            f"{ {k: v for k, v in worker_launches.items() if v} }; peak "
            f"memory: parent host {parent_rss / 2**20:.2f} GiB (the whole "
            f"run), card {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            "GiB (the phase); before the kill, " + "; ".join(
                f"shard {i} host {m['host_peak_rss_bytes'] / 2**30:.2f} GiB, "
                f"card {m['device_peak_bytes'] / 2**30:.2f} GiB"
                for i, m in sorted(mem.items())))
        procs = list(dep.procs)
    finally:
        s.close()
    check(all(p is None or p.poll() is not None for p in procs),
          "[cluster] a worker outlived close()")
    log("[cluster] close(): every worker process has exited")


# ----------------------------------------------------------------------
# phase 5: the flash attention kernel
# ----------------------------------------------------------------------

def flash_phase(torch, kops):
    """flash_attention against its plain version at the prefill shape and
    at hd 128, f32 on the register-blocked f32 kernel and bf16 on the
    tensor-core one; returns its row of the kernels JSON line, without
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref as kref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cfg = get_config(LLM_ARCH)
    B, S = LLM_B, LLM_S
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16

    def qkv(Sq, B=B, H=H, K=K, hd=hd):
        return [torch.randn((B, Sq, n, hd), generator=gen, device=dev)
                for n in (H, K, K)]

    gqa, plain = kflash.flash_attention_gqa, kref.gqa_attention_ref
    fn, plain3, mod = kops.KERNELS["flash_attention"]
    tc0 = kflash.flash_attention.launches_tc
    errs = {}

    def hold(what, got_fn, plain_fn, args, kw):
        """The kernel against its plain version, in f32 and in bf16 (the
        same inputs rounded), each at its own tolerance."""
        tol = {"f32": (ATOL["float32"], 3e-2), "bf16": FLASH_BF16_TOL}
        for tag, xs in (("f32", args),
                        ("bf16", [t.to(bf16) for t in args])):
            errs[f"{what} {tag}"] = assert_close(
                torch, got_fn(*xs, **kw), plain_fn(*xs, **kw), *tol[tag],
                f"flash_attention {what} {tag}")

    q, k, v = qkv(S)
    hold("prefill", gqa, plain, (q, k, v), dict(causal=True))
    hold("ragged S=1000", gqa, plain, qkv(1000), dict(causal=True))
    hold("window 256", gqa, plain, (q, k, v), dict(causal=True, window=256))
    hold("(BH, S, hd)", fn, plain3,
         [torch.randn((B * H, 1024, hd), generator=gen, device=dev)
          for _ in range(3)], dict(causal=True))
    n_tc = kflash.flash_attention.launches_tc - tc0
    check(n_tc == 4, f"flash_attention: {n_tc} of the 4 bf16 calls took "
          "the tensor-core kernel, and none of the f32 ones may")
    out = gqa(q, k, v, causal=True)
    # the library yardstick, (B, H, S, hd); transposes outside the timing
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    err_lib = max_err(torch, lib, out)
    ms = time_ms(torch, lambda: gqa(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: plain(q, k, v, causal=True), reps=5)
    lib_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                         enable_gqa=True))
    qb, kb, vb, qtb, ktb, vtb = (t.to(bf16) for t in (q, k, v, qt, kt, vt))
    ms_b = time_ms(torch, lambda: gqa(qb, kb, vb, causal=True))
    lib_ms_b = time_ms(torch, lambda: sdpa(qtb, ktb, vtb, is_causal=True,
                                           enable_gqa=True))
    need = (2 * B * S * H + 2 * B * S * K) * hd * 4     # q, out, k, v
    flops = 4 * hd * B * H * S * (S + 1) // 2          # live causal pairs
    row = kernel_row("flash_attention", mod, errs["prefill f32"], ms,
                     plain_ms, need, flops, lib_ms)
    tc_ms = max(need / 2 / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS_PER_S) * 1e3
    row.update(source_bf16=kflash.SOURCE_TC, ms_bf16=ms_b,
               library_ms_bf16=lib_ms_b, bound_ms_bf16=tc_ms,
               max_abs_err_bf16=errs["prefill bf16"])
    log(f"[flash] B={B} S={S} H={H} K={K} hd={hd} causal, max err against "
        "the plain version: " + ", ".join(f"{n} {e:.3e}"
                                          for n, e in errs.items())
        + f" (f32 atol {ATOL['float32']} rtol 3e-2; bf16 atol "
        f"{FLASH_BF16_TOL[0]} rtol {FLASH_BF16_TOL[1]}); SDPA vs kernel "
        f"{err_lib:.3e}; {n_tc} bf16 calls on the tensor-core kernel")
    log(f"[flash] f32: {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}, {flops / 1e9:.1f} GFLOP); bf16 (tensor "
        f"cores): {ms_b:.4f} ms, SDPA {lib_ms_b:.4f} ms, tensor-core bound "
        f"{tc_ms:.4f} ms ({ms_b / lib_ms_b:.2f}x SDPA, {ms_b / tc_ms:.2f}x "
        "the bound)")
    del q, k, v, qt, kt, vt, qb, kb, vb, qtb, ktb, vtb, out, lib
    # hd 128: qwen2.5-14b's heads, one 4096-token sequence, f32 then bf16
    qc = get_config(HD128_ARCH)
    H2, K2, hd2, S2 = (qc.n_heads, qc.n_kv_heads, qc.resolved_head_dim,
                       HD128_S)
    flops2 = 4 * hd2 * H2 * S2 * (S2 + 1) // 2
    q, k, v = qkv(S2, B=1, H=H2, K=K2, hd=hd2)
    tc0 = kflash.flash_attention.launches_tc
    err32 = assert_close(torch, gqa(q, k, v, causal=True),
                         plain(q, k, v, causal=True), ATOL["float32"], 3e-2,
                         "flash_attention f32 hd 128")
    check(kflash.flash_attention.launches_tc == tc0,
          "flash_attention f32 hd 128: took the tensor-core kernel")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms32 = time_ms(torch, lambda: gqa(q, k, v, causal=True))
    lib32 = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True))
    bnd32 = bound((2 * S2 * H2 + 2 * S2 * K2) * hd2 * 4, flops2)[0]
    row.update(max_abs_err_f32_hd128=err32, ms_f32_hd128=ms32,
               library_ms_f32_hd128=lib32, bound_ms_f32_hd128=bnd32)
    log(f"[flash] f32 hd {hd2} ({HD128_ARCH} heads: B=1 S={S2} H={H2} "
        f"K={K2} causal): err {err32:.3e} (atol {ATOL['float32']}, rtol "
        f"3e-2); {ms32:.4f} ms, SDPA {lib32:.4f} ms, bound {bnd32:.4f} ms "
        f"(operations, {flops2 / 1e9:.1f} GFLOP; {ms32 / bnd32:.2f}x the "
        f"bound, {ms32 / lib32:.2f}x SDPA)")
    q, k, v = (t.to(bf16) for t in (q, k, v))
    tc0 = kflash.flash_attention.launches_tc
    err2 = assert_close(torch, gqa(q, k, v, causal=True),
                        plain(q, k, v, causal=True), *FLASH_BF16_TOL,
                        "flash_attention bf16 hd 128")
    check(kflash.flash_attention.launches_tc == tc0 + 1,
          "flash_attention bf16 hd 128: not on the tensor-core kernel")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms2 = time_ms(torch, lambda: gqa(q, k, v, causal=True))
    lib2 = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                       enable_gqa=True))
    need2 = (2 * S2 * H2 + 2 * S2 * K2) * hd2 * 2
    tc2 = max(need2 / HBM_BYTES_PER_S, flops2 / BF16_TC_FLOPS_PER_S) * 1e3
    log(f"[flash] bf16 hd {hd2} ({HD128_ARCH} heads: B=1 S={S2} H={H2} "
        f"K={K2} causal): err {err2:.3e}; {ms2:.4f} ms, SDPA {lib2:.4f} ms, "
        f"tensor-core bound {tc2:.4f} ms ({ms2 / lib2:.2f}x SDPA)")
    del q, k, v, qt, kt, vt
    # llava-next-34b's heads (a GQA group of 7) at its prefill's length,
    # as the [vlm] prefill and the [train] vlm step run them
    vc = get_config(VLM_ARCH)
    H3, K3, hd3 = vc.n_heads, vc.n_kv_heads, vc.resolved_head_dim
    S3 = vc.n_frontend_tokens + VLM_TEXT
    tc0 = kflash.flash_attention.launches_tc
    hold(f"{VLM_ARCH} heads", gqa, plain, qkv(S3, B=1, H=H3, K=K3, hd=hd3),
         dict(causal=True))
    check(kflash.flash_attention.launches_tc == tc0 + 1,
          f"flash_attention {VLM_ARCH} heads: the bf16 call was not on the "
          "tensor-core kernel")
    log(f"[flash] {VLM_ARCH} heads (B=1 S={S3} H={H3} K={K3} hd {hd3} "
        f"causal): f32 err {errs[f'{VLM_ARCH} heads f32']:.3e} (atol "
        f"{ATOL['float32']} rtol 3e-2), bf16 err "
        f"{errs[f'{VLM_ARCH} heads bf16']:.3e} (atol {FLASH_BF16_TOL[0]} "
        f"rtol {FLASH_BF16_TOL[1]}, on the tensor cores)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flash_mla(torch, kflash, row)
    torch.cuda.synchronize()
    log(f"[flash] MLA took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flash_ssm_shapes(torch, kflash, row)
    torch.cuda.synchronize()
    log(f"[flash] zamba2 and whisper shapes took "
        f"{time.perf_counter() - t0:.1f} s")
    return row


def _sdpa_ms(torch, q, k, v, causal=True):
    """SDPA's time on (B, S, H, d) views, transposed outside the timing;
    (None, reason) where it refuses these shapes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    try:
        sdpa(qt, kt, vt, is_causal=causal)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:160]
    return time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal)), None


def flash_mla(torch, kflash, row):
    """Both kernels at deepseek-v2's MLA prefill shape: q and k at hd 192
    (nope 128 + rope 64), v a (B, S, H, 128) view of the kv projection
    (the columns after nope), H = K = 128, causal, against the plain
    version in f32 and bf16; times beside SDPA and the bounds.  Then a
    ragged Sq = Skv = 1000 in both types, and a v view one element off a
    16-byte boundary: the f32 kernel bitwise an aligned v, the bf16 one
    refused (TMA)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as kref
    a = get_config(MLA_ARCH).mla
    H = get_config(MLA_ARCH).n_heads
    nd, rd, vd = a.nope_head_dim, a.rope_head_dim, a.v_head_dim
    hd = nd + rd
    B, S = MLA_B, MLA_S
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    gqa, plain = kflash.flash_attention_gqa, kref.gqa_attention_ref
    scale = 1.0 / hd ** 0.5
    kw = dict(causal=True, scale=scale)

    def mla_qkv(Sq, dtype):
        q = torch.randn((B, Sq, H, hd), generator=gen, device=dev)
        kv = torch.randn((B, Sq, H, nd + vd), generator=gen, device=dev)
        k_rope = torch.randn((B, Sq, 1, rd), generator=gen, device=dev)
        k = torch.cat([kv[..., :nd], k_rope.expand(B, Sq, H, rd)], dim=-1)
        kv = kv.to(dtype)
        return q.to(dtype), k.to(dtype), kv[..., nd:]

    live = S * (S + 1) // 2
    flops = B * H * live * 2 * (hd + vd)
    tol = {torch.float32: (ATOL["float32"], 3e-2),
           torch.bfloat16: FLASH_BF16_TOL}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = mla_qkv(S, dtype)
        assert v.stride(-1) == 1 and v.stride(-2) == nd + vd
        tc0 = kflash.flash_attention.launches_tc
        got = gqa(q, k, v, **kw)
        n_tc = kflash.flash_attention.launches_tc - tc0
        check(tuple(got.shape) == (B, S, H, vd) and n_tc == int(
            tag == "bf16"), f"flash MLA {tag}: shape {tuple(got.shape)}, "
              f"{n_tc} tensor-core launches")
        err = assert_close(torch, got, plain(q, k, v, **kw), *tol[dtype],
                           f"flash_attention MLA {tag}")
        del got
        ms = time_ms(torch, lambda: gqa(q, k, v, **kw))
        plain_ms = (time_ms(torch, lambda: plain(q, k, v, **kw), reps=3)
                    if tag == "f32" else None)
        sdpa_ms, why = _sdpa_ms(torch, q, k, v)
        size = 4 if tag == "f32" else 2
        need = B * S * H * (2 * hd + 2 * vd) * size     # q, k, v, out
        rate = F32_FLOPS_PER_S if tag == "f32" else BF16_TC_FLOPS_PER_S
        bnd = max(need / HBM_BYTES_PER_S, flops / rate) * 1e3
        row.update({f"mla_ms_{tag}": ms, f"mla_bound_ms_{tag}": bnd,
                    f"mla_sdpa_ms_{tag}": sdpa_ms,
                    f"mla_max_abs_err_{tag}": err})
        if plain_ms is not None:
            row["mla_plain_ms_f32"] = plain_ms
        log(f"[flash] MLA {tag} ({MLA_ARCH}: B={B} S={S} H=K={H} hd {hd} "
            f"vd {vd} causal, v a view of kv): err {err:.3e} (atol "
            f"{tol[dtype][0]} rtol {tol[dtype][1]}); {ms:.4f} ms, "
            + (f"plain {plain_ms:.4f} ms, " if plain_ms else "")
            + (f"SDPA {sdpa_ms:.4f} ms" if sdpa_ms is not None
               else f"SDPA null ({why})")
            + f", bound {bnd:.4f} ms (operations, {flops / 1e9:.1f} GFLOP; "
            f"{ms / bnd:.2f}x the bound)")
        del q, k, v
        torch.cuda.empty_cache()
    # ragged: Sq = Skv = 1000 (a partial row tile and key tile) in both
    ragged = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = mla_qkv(1000, dtype)
        ragged[tag] = assert_close(
            torch, gqa(q, k, v, **kw), plain(q, k, v, **kw), *tol[dtype],
            f"flash_attention MLA ragged S=1000 {tag}")
    # misaligned v: the f32 kernel's 4-byte copies, bitwise the aligned
    q, k, v = mla_qkv(1000, torch.float32)
    flat = torch.empty(v.numel() + 1, device=dev)
    vm = flat[1:].view(v.shape)
    vm.copy_(v)
    check(vm.data_ptr() % 16 != 0, "misaligned v: aligned after all")
    check(torch.equal(gqa(q, k, vm, **kw), gqa(q, k, v, **kw)),
          "flash_attention MLA f32: a misaligned v view changed the bits")
    qb, kb, vmb = q.to(torch.bfloat16), k.to(torch.bfloat16), torch.empty(
        v.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(v.shape)
    try:
        gqa(qb, kb, vmb, **kw)
        refused = False
    except ValueError:
        refused = True
    check(refused, "flash_attention MLA bf16: a misaligned v view was not "
          "refused")
    log(f"[flash] MLA ragged S=1000: f32 err {ragged['f32']:.3e}, bf16 "
        f"err {ragged['bf16']:.3e}; misaligned v: f32 bitwise the "
        "aligned view, bf16 refused (TMA needs 16-byte bases)")


def flash_ssm_shapes(torch, kflash, row):
    """Both kernels at the [ssm] phase's attention shapes: zamba2's shared
    attention (hd 112: the 128-column tiles zero-fill columns 112-127 and
    clip the store; causal), whisper's encoder (non-causal over 1,500
    frames, ragged against the 128-key tiles) and its cross-attention
    (non-causal, Sq = 448 decoder tokens and Sq = 1 in decode against Skv
    = 1,500), each against the plain version in f32 and bf16 at the
    tolerances above, timed beside SDPA and the bound (bytes over the
    memory rate or the live pairs' 4 hd flops over the type's peak)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as kref
    gqa, plain = kflash.flash_attention_gqa, kref.gqa_attention_ref
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    z, w = get_config(HD112_ARCH), get_config(WHISPER_ARCH)
    frames = w.n_frontend_tokens
    wh = (w.n_heads, w.n_kv_heads, w.resolved_head_dim)
    shapes = (   # tag, what, B, Sq, Skv, (H, K, hd), causal
        ("hd112", f"{HD112_ARCH} shared attention", HD112_B, HD112_S,
         HD112_S, (z.n_heads, z.n_kv_heads, z.resolved_head_dim), True),
        ("encoder", f"{WHISPER_ARCH} encoder", WHISPER_B, frames, frames,
         wh, False),
        ("cross", f"{WHISPER_ARCH} cross-attention", WHISPER_B,
         WHISPER_TOKENS, frames, wh, False),
        ("cross1", f"{WHISPER_ARCH} cross-attention in decode", WHISPER_B,
         1, frames, wh, False))
    tol = {"f32": (ATOL["float32"], 3e-2), "bf16": FLASH_BF16_TOL}
    for tag, what, B, Sq, Skv, (H, K, hd), causal in shapes:
        q = torch.randn((B, Sq, H, hd), generator=gen, device=dev)
        k, v = (torch.randn((B, Skv, K, hd), generator=gen, device=dev)
                for _ in range(2))
        live = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        flops = 4 * hd * B * H * live
        parts = []
        for dt, dtype, size, rate in (
                ("f32", torch.float32, 4, F32_FLOPS_PER_S),
                ("bf16", torch.bfloat16, 2, BF16_TC_FLOPS_PER_S)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            tc0 = kflash.flash_attention.launches_tc
            got = gqa(qd, kd, vd, causal=causal)
            n_tc = kflash.flash_attention.launches_tc - tc0
            check(tuple(got.shape) == (B, Sq, H, hd)
                  and n_tc == int(dt == "bf16"),
                  f"flash {tag} {dt}: shape {tuple(got.shape)}, {n_tc} "
                  "tensor-core launches")
            err = assert_close(torch, got, plain(qd, kd, vd, causal=causal),
                               *tol[dt], f"flash_attention {tag} {dt}")
            del got
            ms = time_ms(torch, lambda: gqa(qd, kd, vd, causal=causal))
            sdpa_ms, why = _sdpa_ms(torch, qd, kd, vd, causal=causal)
            need = (2 * B * Sq * H + 2 * B * Skv * K) * hd * size
            t_bytes, t_ops = need / HBM_BYTES_PER_S, flops / rate
            bnd = max(t_bytes, t_ops) * 1e3
            by = "bytes" if t_bytes >= t_ops else "operations"
            row.update({f"{tag}_ms_{dt}": ms, f"{tag}_bound_ms_{dt}": bnd,
                        f"{tag}_sdpa_ms_{dt}": sdpa_ms,
                        f"{tag}_max_abs_err_{dt}": err})
            parts.append(
                f"{dt} err {err:.3e} (atol {tol[dt][0]} rtol {tol[dt][1]}), "
                f"{ms:.4f} ms, SDPA "
                + (f"{sdpa_ms:.4f} ms" if sdpa_ms is not None
                   else f"null ({why})")
                + f", bound {bnd:.4f} ms ({by}; {ms / bnd:.2f}x)")
            del qd, kd, vd
        log(f"[flash] {what} (B={B} Sq={Sq} Skv={Skv} H={H} K={K} hd={hd} "
            f"{'causal' if causal else 'non-causal'}; {flops / 1e9:.2f} "
            "GFLOP): " + "; ".join(parts))
        del q, k, v
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 6: the dense-transformer serving path
# ----------------------------------------------------------------------

def _prefill(torch, kops, prefill_step, cfg, params, tokens, backend):
    """One prefill of ``tokens`` (or of a batch dict: whisper's frames and
    tokens) on ``backend``; returns (logits, cache, launches, ms,
    launches of the tensor-core flash kernel)."""
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(cfg, params, batch, attn_backend=backend)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (logits, cache, kops.launch_counts(), ms,
            kops.flash_attention.launches_tc)


def _device_ms(torch, fn):
    """An upper bound on the device time of ``fn``'s work: the stream first
    sleeps for about half a second, so the host queues the work ahead of
    the device, and events time it from the end of the sleep.  Where the
    host fills the launch queue and then falls behind, idle gaps remain
    inside the bound; a wall time above it is the host's."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000_000)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def llm_phase(torch, kops, launches, card):
    """Returns the tensor-core flash launches of the prefills."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    from repro_torch.serve.step import prefill_step
    base = get_config(LLM_ARCH)
    L = base.n_layers
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.vocab_size, (LLM_B, LLM_S)), device=DEVICE)
    want = {name: (L if name == "flash_attention" else 0)
            for name in kops.KERNELS}
    none = {name: 0 for name in kops.KERNELS}
    times, n_tc = {}, 0
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = transformer.init_params(cfg, 0, device=DEVICE)
        want_tc = L if dtype == "bfloat16" else 0     # bf16: tensor cores
        got = _prefill(torch, kops, prefill_step, cfg, params, tokens, "cuda")
        check(got[2] == want and got[4] == want_tc, f"prefill {dtype}: "
              f"launches {got[2]}, {got[4]} on the tensor-core kernel; "
              f"expected {want}, {want_tc}")
        launches["flash_attention"] += got[2]["flash_attention"]
        ref = _prefill(torch, kops, prefill_step, cfg, params, tokens, "ref")
        check(ref[2] == none and ref[4] == 0,
              f"prefill {dtype} ref: launches {ref[2]}, {ref[4]}")
        check(tuple(got[0].shape) == (LLM_B, 1, cfg.vocab_size)
              and bool(torch.isfinite(got[0]).all()),
              f"prefill {dtype}: logits {tuple(got[0].shape)}, finite "
              f"{bool(torch.isfinite(got[0]).all())}")
        if dtype == "float32":
            errs = [assert_close(torch, got[0], ref[0], 1e-4, 3e-3,
                                 "prefill f32 logits cuda vs ref")]
            errs += [assert_close(torch, got[1][n], ref[1][n], 1e-4, 3e-3,
                                  f"prefill f32 cache {n} cuda vs ref")
                     for n in ("k", "v")]
        else:
            errs = [max_err(torch, got[0], ref[0])] + [
                max_err(torch, got[1][n], ref[1][n]) for n in ("k", "v")]
        again = _prefill(torch, kops, prefill_step, cfg, params, tokens,
                         "cuda")
        check(again[2] == want and again[4] == want_tc, f"prefill {dtype} "
              f"again: launches {again[2]}, {again[4]} tensor-core")
        launches["flash_attention"] += again[2]["flash_attention"]
        n_tc += got[4] + again[4]
        times[dtype] = again[3]
        kops.reset_launch_counts()
        dev_ms = _device_ms(torch, lambda: prefill_step(
            cfg, params, {"tokens": tokens}, attn_backend="cuda"))
        launches["flash_attention"] += kops.flash_attention.launches
        n_tc += kops.flash_attention.launches_tc
        log(f"[llm] {LLM_ARCH} {L} layers d_model {cfg.d_model} {dtype}: "
            f"prefill {LLM_B}x{LLM_S} tokens {again[3]:.1f} ms warm "
            f"({got[3]:.1f} ms first; \"ref\" {ref[3]:.1f} ms; device "
            f"at most {dev_ms:.1f} ms, queued ahead), "
            f"{got[2]['flash_attention']} flash launches, {got[4]} of them "
            f"on the tensor cores (\"ref\": 0); max "
            f"err cuda vs ref: logits {errs[0]:.3e}, cache k {errs[1]:.3e}, "
            f"v {errs[2]:.3e}" + (" (atol 1e-4, rtol 3e-3)"
                                  if dtype == "float32" else ""))
        del got, ref, again
        if dtype == "float32":
            del params
        torch.cuda.empty_cache()
    kops.reset_launch_counts()
    reqs, stats = launch_serve.run(LLM_ARCH, n_requests=8, max_new=16,
                                   batch_slots=4, max_seq=128, seed=0,
                                   params=params, cfg=base, device=DEVICE)
    counts = kops.launch_counts()
    check(counts == none, f"serve: launches {counts}, expected none")
    check(all(r.done and r.out_tokens for r in reqs),
          "serve: a request did not finish")
    log(f"[llm] serve {LLM_ARCH} bf16 ({L} layers, d_model "
        f"{base.d_model}) on {card}: "
        f"{len(reqs)} requests, 4 slots, {stats['tokens']} tokens in "
        f"{stats['decode_steps']} decode steps, {stats['seconds']:.2f} s "
        f"({stats['tokens'] / stats['seconds']:.1f} tok/s, "
        f"{stats['seconds'] / stats['decode_steps'] * 1e3:.1f} ms per "
        f"step); prefill {LLM_B}x{LLM_S}: f32 {times['float32']:.1f} ms, "
        f"bf16 {times['bfloat16']:.1f} ms; 0 flash launches")
    return n_tc


# ----------------------------------------------------------------------
# phase 7: the moe family (llama4-maverick, deepseek-v2 with MLA)
# ----------------------------------------------------------------------

def _moe_inputs(transformer, fn):
    """Run ``fn`` with ``transformer.moe_block`` recording each MoE
    layer's (input, params); returns (fn's result, the records)."""
    seen, inner = [], transformer.moe_block

    def recording(x, p, cfg):
        seen.append((x, p))
        return inner(x, p, cfg)

    transformer.moe_block = recording
    try:
        return fn(), seen
    finally:
        transformer.moe_block = inner


def _moe_block_ms(torch, moe, x, p, cfg):
    """One moe_block at ``x``'s shape, split: routing and dispatch (the
    sort, the buffer), the expert FFN (three bmm over E), the combine
    and the shared experts; and the whole block.  CUDA events, median."""
    m = cfg.moe
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    C = moe._capacity(T, m.n_experts, m.top_k, m.capacity_factor)
    flat = x.reshape(T, D)
    r = moe.route(flat, p.router, m.n_experts, m.top_k, C)
    buf = moe.dispatch(flat, r, m.n_experts, C)
    ob = moe.moe_ffn(buf, p.w_gate, p.w_up, p.w_down)
    return {
        "dispatch": time_ms(torch, lambda: moe.dispatch(flat, moe.route(
            flat, p.router, m.n_experts, m.top_k, C), m.n_experts, C),
            reps=10),
        "ffn": time_ms(torch, lambda: moe.moe_ffn(buf, p.w_gate, p.w_up,
                                                  p.w_down), reps=10),
        "combine": time_ms(torch, lambda: moe.combine(ob, r), reps=10),
        "block": time_ms(torch, lambda: moe.moe_block(x, p, cfg), reps=10),
    }


def moe_model(torch, kops, launches, arch, n_layers, dtypes, card):
    """One moe config at full width, cut to ``n_layers``: per dtype the
    prefill through "cuda" against "ref" (logits and every cache entry;
    f32 atol 1e-4 rtol 3e-3, bf16 max error), flash launches (one a
    layer, all on the tensor cores in bf16), capacity and dropped share,
    one moe_block split, memory; then the serving run in the last dtype.
    Returns the tensor-core flash launches of the counted prefills."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import moe, transformer
    from repro_torch.serve.step import prefill_step
    base = dataclasses.replace(get_config(arch), n_layers=n_layers)
    m = base.moe
    T = MOE_B * MOE_S
    C = moe._capacity(T, m.n_experts, m.top_k, m.capacity_factor)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.vocab_size, (MOE_B, MOE_S)), device=DEVICE)
    want = {name: (n_layers if name == "flash_attention" else 0)
            for name in kops.KERNELS}
    none = {name: 0 for name in kops.KERNELS}
    n_tc = 0
    for dtype in dtypes:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        params = transformer.init_params(cfg, 0, device=DEVICE)
        torch.cuda.synchronize()
        gib = sum(p.numel() * p.element_size()
                  for p in params.parameters()) / 2 ** 30
        init_s = time.perf_counter() - t0
        want_tc = n_layers if dtype == "bfloat16" else 0
        got, seen = _moe_inputs(transformer, lambda: _prefill(
            torch, kops, prefill_step, cfg, params, tokens, "cuda"))
        check(got[2] == want and got[4] == want_tc, f"{arch} prefill "
              f"{dtype}: launches {got[2]}, {got[4]} on the tensor-core "
              f"kernel; expected {want}, {want_tc}")
        launches["flash_attention"] += got[2]["flash_attention"]
        n_tc += got[4]
        ref, seen_ref = _moe_inputs(transformer, lambda: _prefill(
            torch, kops, prefill_step, cfg, params, tokens, "ref"))
        check(ref[2] == none and ref[4] == 0,
              f"{arch} prefill {dtype} ref: launches {ref[2]}, {ref[4]}")
        check(tuple(got[0].shape) == (MOE_B, 1, cfg.vocab_size)
              and bool(torch.isfinite(got[0]).all()),
              f"{arch} prefill {dtype}: logits {tuple(got[0].shape)}")
        check(set(got[1]) == set(ref[1]) and all(
            bool(torch.isfinite(c.float()).all()) for c in got[1].values()),
            f"{arch} prefill {dtype}: cache entries")
        names = ["logits", *sorted(got[1])]
        pairs = [(got[0], ref[0])] + [(got[1][n], ref[1][n])
                                      for n in sorted(got[1])]
        if dtype == "float32":
            errs = [assert_close(torch, a, b, 1e-4, 3e-3,
                                 f"{arch} prefill f32 {n} cuda vs ref")
                    for n, (a, b) in zip(names, pairs)]
        else:
            errs = [max_err(torch, a, b) for a, b in pairs]
        drops, flips = [], []
        for (x, p), (xr, _) in zip(seen, seen_ref):
            r, rr = (moe.route(t.reshape(T, -1), p.router, m.n_experts,
                               m.top_k, C) for t in (x, xr))
            drops.append(1.0 - float(r.keep.float().mean()))
            same = (r.expert.sort(dim=1).values
                    == rr.expert.sort(dim=1).values).all(dim=1)
            flips.append(int((~same).sum()))
        split = _moe_block_ms(torch, moe, *seen[0], cfg)
        first_ms, ref_ms = got[3], ref[3]
        del got, ref, seen, seen_ref
        again = _prefill(torch, kops, prefill_step, cfg, params, tokens,
                         "cuda")
        check(again[2] == want and again[4] == want_tc,
              f"{arch} prefill {dtype} again: launches {again[2]}")
        launches["flash_attention"] += again[2]["flash_attention"]
        n_tc += again[4]
        kops.reset_launch_counts()
        dev_ms = _device_ms(torch, lambda: prefill_step(
            cfg, params, {"tokens": tokens}, attn_backend="cuda"))
        launches["flash_attention"] += kops.flash_attention.launches
        n_tc += kops.flash_attention.launches_tc
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[moe] {arch} {n_layers} layers d_model {cfg.d_model} "
            f"{dtype}: {gib:.2f} GiB of weights (drawn in {init_s:.1f} s), "
            f"peak {peak:.2f} GiB; prefill {MOE_B}x{MOE_S} tokens "
            f"{again[3]:.1f} ms warm ({first_ms:.1f} ms first; \"ref\" "
            f"{ref_ms:.1f} ms; device at most {dev_ms:.1f} ms, queued "
            "ahead), "
            f"{want['flash_attention']} flash launches, {want_tc} on the "
            f"tensor cores (\"ref\": 0); capacity C={C} for {T} tokens x "
            f"top-{m.top_k} over {m.n_experts} experts, dropped "
            + ", ".join(f"{d:.4f}" for d in drops) + " of the token-slots "
            "by MoE layer; tokens routed to other experts under \"ref\": "
            + ", ".join(f"{f} of {T}" for f in flips) + "; max err cuda vs "
            "ref: "
            + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
            + (" (atol 1e-4, rtol 3e-3)" if dtype == "float32" else ""))
        log(f"[moe] {arch} {dtype} one moe_block at {MOE_B}x{MOE_S}: "
            f"{split['block']:.3f} ms = routing and dispatch "
            f"{split['dispatch']:.3f} ms + expert FFN {split['ffn']:.3f} "
            f"ms + combine {split['combine']:.3f} ms + shared experts")
        if dtype != dtypes[-1]:
            del params
            torch.cuda.empty_cache()
    kops.reset_launch_counts()
    reqs, stats = launch_serve.run(arch, n_requests=8, max_new=16,
                                   batch_slots=4, max_seq=128, seed=0,
                                   params=params, cfg=cfg, device=DEVICE)
    counts = kops.launch_counts()
    check(counts == none, f"{arch} serve: launches {counts}, expected none")
    check(all(r.done and r.out_tokens for r in reqs),
          f"{arch} serve: a request did not finish")
    log(f"[moe] serve {arch} {cfg.dtype} ({n_layers} layers) on {card}: "
        f"{len(reqs)} requests, 4 slots, {stats['tokens']} tokens in "
        f"{stats['decode_steps']} decode steps, {stats['seconds']:.2f} s "
        f"({stats['tokens'] / stats['seconds']:.1f} tok/s, "
        f"{stats['seconds'] / stats['decode_steps'] * 1e3:.1f} ms per "
        "step); 0 flash launches")
    del params
    torch.cuda.empty_cache()
    return n_tc


def moe_phase(torch, kops, launches, card):
    """deepseek-v2 (1 dense-first + 2 MoE layers; f32, then bf16 and its
    serving run) and llama4-maverick (one super-block; bf16 only: its
    f32 weights, about 69 GiB, do not fit beside their activations)."""
    n_tc = 0
    for arch, n_layers, dtypes in MOE_MODELS:
        t0 = time.perf_counter()
        n_tc += moe_model(torch, kops, launches, arch, n_layers, dtypes,
                          card)
        log(f"[moe] {arch} took {time.perf_counter() - t0:.1f} s")
    return n_tc


# ----------------------------------------------------------------------
# phase 8: the recurrent and encoder-decoder families (mamba2, zamba2,
# whisper)
# ----------------------------------------------------------------------

def _cache_leaves(cache):
    """(name, tensor) of every cache entry, the SSMCache fields named."""
    for name, v in cache.items():
        if isinstance(v, tuple):
            yield from ((f"{name}.{f}", getattr(v, f)) for f in v._fields)
        else:
            yield name, v


def _hold(torch, arch, dtype, got, ref, rule):
    """The "cuda" prefill's logits and cache against the "ref" one:
    ``rule`` "bitwise", "close" (atol 1e-4, rtol 3e-3) or "print" (the
    max error only).  Returns [(name, max error)]."""
    pairs = [("logits", got[0], ref[0])] + [
        (n, t, dict(_cache_leaves(ref[1]))[n])
        for n, t in _cache_leaves(got[1])]
    check([n for n, _, _ in pairs[1:]] == [n for n, _ in _cache_leaves(
        ref[1])], f"{arch} {dtype}: cache entries differ between backends")
    for n, a, _ in pairs:
        check(bool(torch.isfinite(a.float()).all()),
              f"{arch} prefill {dtype}: {n} not finite")
    out = []
    for n, a, b in pairs:
        if rule == "bitwise":
            check(torch.equal(a, b), f"{arch} prefill {dtype}: {n} cuda vs "
                  f"ref not bitwise (max err {max_err(torch, a, b):.3e})")
            out.append((n, 0.0))
        elif rule == "close":
            out.append((n, assert_close(torch, a, b, 1e-4, 3e-3,
                                        f"{arch} prefill {dtype} {n} cuda "
                                        "vs ref")))
        else:
            out.append((n, max_err(torch, a, b)))
    return out


def _prefill_cell(torch, kops, launches, cfg, params, batch, want_flash,
                  rule):
    """A model's prefill through "cuda" (first and warm) and "ref", the
    launches (``want_flash`` flash a prefill, all on the tensor cores in
    bf16; none under "ref"), the comparison by ``rule`` and a device-time
    bound.  Adds the counted launches to ``launches``; returns (the
    "cuda" prefill's result, errors, first ms, warm ms, "ref" ms, device
    ms, tensor-core launches)."""
    from repro_torch.serve.step import prefill_step
    want = {name: (want_flash if name == "flash_attention" else 0)
            for name in kops.KERNELS}
    none = {name: 0 for name in kops.KERNELS}
    want_tc = want_flash if cfg.dtype == "bfloat16" else 0
    B = (batch["tokens"] if isinstance(batch, dict) else batch).shape[0]
    got = _prefill(torch, kops, prefill_step, cfg, params, batch, "cuda")
    check(got[2] == want and got[4] == want_tc, f"{cfg.arch_id} prefill "
          f"{cfg.dtype}: launches {got[2]}, {got[4]} on the tensor-core "
          f"kernel; expected {want}, {want_tc}")
    ref = _prefill(torch, kops, prefill_step, cfg, params, batch, "ref")
    check(ref[2] == none and ref[4] == 0,
          f"{cfg.arch_id} prefill {cfg.dtype} ref: launches {ref[2]}")
    check(tuple(got[0].shape) == (B, 1, cfg.vocab_size),
          f"{cfg.arch_id} prefill {cfg.dtype}: logits {tuple(got[0].shape)}")
    errs = _hold(torch, cfg.arch_id, cfg.dtype, got, ref, rule)
    ref_ms = ref[3]
    del ref
    again = _prefill(torch, kops, prefill_step, cfg, params, batch, "cuda")
    check(again[2] == want and again[4] == want_tc,
          f"{cfg.arch_id} prefill {cfg.dtype} again: launches {again[2]}")
    kops.reset_launch_counts()
    dev_ms = _device_ms(torch, lambda: prefill_step(
        cfg, params, batch if isinstance(batch, dict)
        else {"tokens": batch}, attn_backend="cuda"))
    n_flash = got[2]["flash_attention"] + again[2]["flash_attention"] + \
        kops.flash_attention.launches
    n_tc = got[4] + again[4] + kops.flash_attention.launches_tc
    launches["flash_attention"] += n_flash
    return got, errs, got[3], again[3], ref_ms, dev_ms, n_tc


def _gib(params):
    return sum(p.numel() * p.element_size()
               for p in params.parameters()) / 2 ** 30


def _mamba_split(torch, cfg, block, B, S):
    """One Mamba-2 block at the prefill's shape and its ``ssd_chunked``
    scan alone, on random inputs (CUDA events, median of 5): where the
    layer's time goes."""
    from repro_torch.models import ssm
    s, dtype = cfg.ssm, block.pre_norm.dtype
    gen = torch.Generator(device=DEVICE).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    x = randn(B, S, cfg.d_model)
    xs = randn(B, S, s.n_heads, s.head_dim)
    Bm, Cm = randn(B, S, s.n_groups, s.d_state), randn(B, S, s.n_groups,
                                                       s.d_state)
    dt = torch.rand((B, S, s.n_heads), generator=gen, device=DEVICE) + 0.1
    A = -torch.exp(block.ssm.A_log.float())
    blk = time_ms(torch, lambda: ssm.mamba2_block(x, block.ssm, cfg),
                  reps=5, warmup=1)
    scan = time_ms(torch, lambda: ssm.ssd_chunked(xs, dt, A, Bm, Cm,
                                                  s.chunk_size),
                   reps=5, warmup=1)
    return blk, scan


def _mamba_hold(torch, cfg, block, B, S, heads=4):
    """The SSD path at full width against references independent of the
    "cuda"/"ref" switch, in f32: ``ssd_chunked`` at the prefill's shape
    (B x S, the config's heads, state and chunk; random inputs) on the
    card, its first ``heads`` heads of sequence 0 against the
    token-by-token recurrence in f64 on the CPU; and one Mamba-2 block
    (``block``'s weights, random input) at 1 x S on the card against the
    same block on the CPU.  Both at atol 1e-4, rtol 3e-3.  Returns (y
    err, final-state err, block err)."""
    import copy

    from repro_torch.models import ssm
    s = cfg.ssm
    H, P, G, N = s.n_heads, s.head_dim, s.n_groups, s.d_state
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((B, S, H, P), generator=gen)
    dt = torch.rand((B, S, H), generator=gen) * 0.5 + 0.1
    A = -(torch.rand(H, generator=gen) + 0.5)
    Bm, Cm = (torch.randn((B, S, G, N), generator=gen) for _ in range(2))
    y, state = ssm.ssd_chunked(*(t.to(DEVICE) for t in (x, dt, A, Bm, Cm)),
                               s.chunk_size)
    grp = torch.arange(heads) // (H // G)
    xd, dtd, Ad = x[0, :, :heads].double(), dt[0, :, :heads].double(), \
        A[:heads].double()
    Bd, Cd = Bm[0][:, grp].double(), Cm[0][:, grp].double()   # (S, h, N)
    st = torch.zeros((heads, N, P), dtype=torch.float64)
    yd = torch.empty((S, heads, P), dtype=torch.float64)
    for t in range(S):
        st = (st * torch.exp(dtd[t] * Ad)[:, None, None]
              + (Bd[t] * dtd[t][:, None])[:, :, None] * xd[t][:, None, :])
        yd[t] = torch.einsum("hn,hnp->hp", Cd[t], st)
    y_err = assert_close(torch, y[0, :, :heads].cpu(), yd, 1e-4, 3e-3,
                         f"{cfg.arch_id} ssd_chunked vs the recurrence: y")
    st_err = assert_close(torch, state[0, :heads].cpu(), st, 1e-4, 3e-3,
                          f"{cfg.arch_id} ssd_chunked vs the recurrence: "
                          "state")
    del y, state
    x1 = torch.randn((1, S, cfg.d_model), generator=gen).to(
        block.ssm.w_xz.dtype)
    got = ssm.mamba2_block(x1.to(DEVICE), block.ssm, cfg)
    want = ssm.mamba2_block(x1, copy.deepcopy(block.ssm).cpu(), cfg)
    blk_err = assert_close(torch, got.cpu(), want, 1e-4, 3e-3,
                           f"{cfg.arch_id} Mamba-2 block card vs CPU")
    return y_err, st_err, blk_err


def ssm_text_model(torch, kops, launches, arch, B, S, card):
    """mamba2 or zamba2 at full width: per dtype the prefill through
    "cuda" against "ref" (zamba2's f32 within atol 1e-4, rtol 3e-3, bf16
    max error; mamba2 has no attention, so both routes run the same code
    and its bitwise line checks the launches, not the numbers: those are
    held by ``_mamba_hold`` in f32), its flash launches (one a
    super-block), times, memory and one block's split; then
    ``launch.serve.run`` in bf16.  Returns the tensor-core flash
    launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    base = get_config(arch)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.vocab_size, (B, S)), device=DEVICE)
    n_tc = 0
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, dtype=dtype)
        n_attn = (transformer._hybrid_layout(cfg)[0]
                  if cfg.family == "hybrid" else 0)
        torch.cuda.reset_peak_memory_stats()
        params = transformer.init_params(cfg, 0, device=DEVICE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rule = ("bitwise" if cfg.family == "ssm" else
                "close" if dtype == "float32" else "print")
        got, errs, first, warm, ref_ms, dev_ms, tc = _prefill_cell(
            torch, kops, launches, cfg, params, tokens, n_attn, rule)
        n_tc += tc
        del got
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[ssm] {arch} {cfg.n_layers} layers d_model "
            f"{cfg.d_model} {dtype}: {_gib(params):.2f} GiB of weights "
            f"(drawn in {init_s:.1f} s), peak {peak:.2f} GiB; prefill "
            f"{B}x{S} tokens {warm:.1f} ms warm ({first:.1f} ms first; "
            f"\"ref\" {ref_ms:.1f} ms; device at most {dev_ms:.1f} ms, "
            f"queued ahead), {n_attn} flash launches, "
            f"{n_attn if dtype == 'bfloat16' else 0} on the tensor cores "
            "(\"ref\": 0); cuda vs ref "
            + ("bitwise (no attention: the same code on both routes, a "
               "launch check): " if rule == "bitwise" else "max err: ")
            + ", ".join(f"{n} {e:.3e}" for n, e in errs)
            + (" (atol 1e-4, rtol 3e-3)" if rule == "close" else ""))
        block = (params.blocks[0] if cfg.family == "ssm"
                 else params.mamba_blocks[0][0])
        blk, scan = _mamba_split(torch, cfg, block, B, S)
        log(f"[ssm] {arch} {dtype} one Mamba-2 block at {B}x{S}: {blk:.2f} "
            f"ms, of which the ssd_chunked scan (f32) {scan:.2f} ms "
            f"({scan / blk:.0%})")
        if dtype == "float32":
            t1 = time.perf_counter()
            y_err, st_err, blk_err = _mamba_hold(torch, cfg, block, B, S)
            log(f"[ssm] {arch} f32 against references of its own: "
                f"ssd_chunked at {B}x{S} ({cfg.ssm.n_heads} heads x "
                f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk "
                f"{cfg.ssm.chunk_size}) on the card, heads 0-3 of "
                f"sequence 0 against the f64 recurrence on the CPU: y err "
                f"{y_err:.3e}, state err {st_err:.3e}; one Mamba-2 block "
                f"at 1x{S} card vs CPU: err {blk_err:.3e} (atol 1e-4, rtol "
                f"3e-3; {time.perf_counter() - t1:.1f} s)")
        if dtype == "float32":
            del params
            torch.cuda.empty_cache()
    kops.reset_launch_counts()
    reqs, stats = launch_serve.run(arch, n_requests=8, max_new=16,
                                   batch_slots=4, max_seq=128, seed=0,
                                   params=params, cfg=cfg, device=DEVICE)
    counts = kops.launch_counts()
    check(set(counts.values()) == {0}, f"{arch} serve: launches {counts}")
    check(all(r.done and r.out_tokens for r in reqs),
          f"{arch} serve: a request did not finish")
    log(f"[ssm] serve {arch} bf16 ({cfg.n_layers} layers) on {card}: "
        f"{len(reqs)} requests, 4 slots, {stats['tokens']} tokens in "
        f"{stats['decode_steps']} decode steps, {stats['seconds']:.2f} s "
        f"({stats['tokens'] / stats['seconds']:.1f} tok/s, "
        f"{stats['seconds'] / stats['decode_steps'] * 1e3:.1f} ms per "
        "step); 0 flash launches")
    del params
    torch.cuda.empty_cache()
    return n_tc


def whisper_model(torch, kops, launches, card):
    """whisper-base at full width (6 + 6 layers, d_model 512, 8 heads):
    per dtype the prefill of WHISPER_B x WHISPER_TOKENS decoder tokens
    over 1,500 frames through "cuda" against "ref" (f32 within atol 1e-4,
    rtol 3e-3; bf16 max error), 18 flash launches a prefill (6 encoder,
    6 decoder self-attention, 6 cross-attention), then greedy
    ``decode_step``s from the prefill's cache, 6 flash launches each (the
    cross-attention), the first step's logits "cuda" against "ref".
    Returns the tensor-core flash launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    base = get_config(WHISPER_ARCH)
    B, S, n = WHISPER_B, WHISPER_TOKENS, WHISPER_DECODE_STEPS
    L, frames = base.n_layers, base.n_frontend_tokens
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, base.vocab_size, (B, S)),
                             device=DEVICE)
    feats = torch.as_tensor(rng.standard_normal(
        (B, frames, base.frontend_dim)).astype(np.float32), device=DEVICE)
    n_tc = 0
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        params = transformer.init_params(cfg, 0, device=DEVICE)
        batch = {"frames": feats.to(params.projector.dtype),
                 "tokens": tokens}
        rule = "close" if dtype == "float32" else "print"
        got, errs, first, warm, ref_ms, dev_ms, tc = _prefill_cell(
            torch, kops, launches, cfg, params, batch,
            L + L + cfg.n_encoder_layers, rule)
        n_tc += tc
        cache = transformer.init_cache(cfg, B, S + n, frames, device=DEVICE)
        for name in ("k", "v"):
            cache[name][:, :, :S] = got[1][name]
        for name in ("cross_k", "cross_v"):
            cache[name].copy_(got[1][name])
        tok = got[0][:, -1].argmax(-1, keepdim=True)
        del got
        # the first step through "ref" (on a copy of the cache): no launch
        kops.reset_launch_counts()
        ref_lg, _ = transformer.decode_step(
            cfg, params, {k: v.clone() for k, v in cache.items()},
            {"token": tok, "pos": S}, attn_backend="ref")
        check(set(kops.launch_counts().values()) == {0},
              f"{WHISPER_ARCH} decode {dtype} ref: {kops.launch_counts()}")
        want_tc = L if dtype == "bfloat16" else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n):
            kops.reset_launch_counts()
            lg, cache = transformer.decode_step(
                cfg, params, cache, {"token": tok, "pos": S + t},
                attn_backend="cuda")
            check(kops.flash_attention.launches == L
                  and kops.flash_attention.launches_tc == want_tc,
                  f"{WHISPER_ARCH} decode {dtype}: "
                  f"{kops.flash_attention.launches} flash launches, "
                  f"{kops.flash_attention.launches_tc} tensor-core")
            launches["flash_attention"] += kops.flash_attention.launches
            n_tc += kops.flash_attention.launches_tc
            if t == 0:
                first_lg = lg
            tok = lg[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        check(bool(torch.isfinite(lg).all()), f"{WHISPER_ARCH} decode "
              f"{dtype}: logits not finite")
        dec_err = (assert_close(torch, first_lg, ref_lg, 1e-4, 3e-3,
                                f"{WHISPER_ARCH} decode f32 cuda vs ref")
                   if rule == "close" else max_err(torch, first_lg, ref_lg))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[ssm] {WHISPER_ARCH} {cfg.n_encoder_layers} + {L} layers "
            f"d_model {cfg.d_model} {dtype}: {_gib(params):.2f} GiB of "
            f"weights, peak {peak:.2f} GiB; prefill {B}x{S} tokens over "
            f"{frames} frames {warm:.1f} ms warm ({first:.1f} ms first; "
            f"\"ref\" {ref_ms:.1f} ms; device at most {dev_ms:.1f} ms), "
            f"{2 * L + cfg.n_encoder_layers} flash launches"
            f"{' all on the tensor cores' if dtype == 'bfloat16' else ''}; "
            "cuda vs ref max err: "
            + ", ".join(f"{nm} {e:.3e}" for nm, e in errs)
            + (" (atol 1e-4, rtol 3e-3)" if rule == "close" else "")
            + f"; {n} greedy decode steps in {dec_s:.3f} s "
            f"({B * n / dec_s:.1f} tok/s, {dec_s / n * 1e3:.1f} ms a step), "
            f"{L} flash launches a step, the first step's logits cuda vs "
            f"ref {dec_err:.3e}, on {card}")
        del params, cache, lg, first_lg, ref_lg
        torch.cuda.empty_cache()
    return n_tc


def ssm_phase(torch, kops, launches, card):
    """mamba2-1.3b, zamba2-7b and whisper-base at full width.  Returns
    the tensor-core flash launches."""
    n_tc = 0
    for arch, B, S in SSM_MODELS:
        t0 = time.perf_counter()
        n_tc += ssm_text_model(torch, kops, launches, arch, B, S, card)
        log(f"[ssm] {arch} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n_tc += whisper_model(torch, kops, launches, card)
    log(f"[ssm] {WHISPER_ARCH} took {time.perf_counter() - t0:.1f} s")
    return n_tc


# ----------------------------------------------------------------------
# phase 9: training (smollm-360m; llava-next's vlm step)
# ----------------------------------------------------------------------

def _loss_grads(torch, kops, step, cfg, params, batch, backend):
    """``step.loss_and_grads`` on ``backend``; returns (ce, grads, flash
    launches, tensor-core launches, s)."""
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    (_, (ce, _)), grads = step.loss_and_grads(cfg, params, batch,
                                              attn_backend=backend)
    torch.cuda.synchronize()
    return (ce, grads, kops.launch_counts()["flash_attention"],
            kops.flash_attention.launches_tc, time.perf_counter() - t0)


def _grad_err(torch, got, want, atol, rtol):
    """(the largest |got - want| over every gradient, the elements
    outside atol + rtol |want|)."""
    err, bad = 0.0, 0
    for n, g in got.items():
        d = (g.float() - want[n].float()).abs()
        err = max(err, float(d.max()))
        bad += int((d > atol + rtol * want[n].float().abs()).sum())
    return err, bad


def _train_split(torch, cfg, params, step, optimizer):
    """One bf16 step of the launcher's shape on the synthetic stream,
    timed in parts: (loss_and_grads s, the s of its attention backward
    calls, ``FlashAttentionFn.backward`` each synchronized, adamw_update
    s)."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.train.data import DataConfig, synthetic_batches
    host = next(synthetic_batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_S, batch_size=TRAIN_B,
        seed=5)))
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in host.items()}
    spent = []
    backward = kflash.FlashAttentionFn.backward

    def timed(ctx, g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = backward(ctx, g)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    kflash.FlashAttentionFn.backward = staticmethod(timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = step.loss_and_grads(cfg, params, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        kflash.FlashAttentionFn.backward = backward
    opt_cfg = optimizer.AdamWConfig()
    opt = optimizer.init_opt_state(params, opt_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    optimizer.adamw_update(params, grads, opt, opt_cfg,
                           decay=step.decay_mask(cfg, params))
    torch.cuda.synchronize()
    return total, sum(spent), time.perf_counter() - t0


def train_phase(torch, kops, launches, card):
    """smollm-360m at full width: (a) one f32 step's two halves,
    ``loss_and_grads`` through "cuda" and "ref" from the same params and
    batch (loss, every gradient and grad_norm held against "ref") and
    ``adamw_update``; (c) that step's params and AdamW state through
    ``save_checkpoint`` / ``restore_checkpoint``, bitwise; (b)
    ``launch.train.run`` in bf16 at full width, its step times, memory,
    launches and losses; (d) one bf16 vlm ``train_step`` of llava-next-34b
    at full width cut to VLM_TRAIN_LAYERS layers, its CE over a ragged
    text span.  Returns the tensor-core flash launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.train import checkpoint, optimizer, step
    base = get_config(TRAIN_ARCH)
    L = base.n_layers
    cfg = dataclasses.replace(base, dtype="float32")
    rng = np.random.default_rng(1)
    batch = {n: torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        TRAIN_F32_B, TRAIN_S)), device=DEVICE) for n in ("tokens", "labels")}
    params = transformer.init_params(cfg, 0, device=DEVICE)
    params.requires_grad_(True)
    got = _loss_grads(torch, kops, step, cfg, params, batch, "cuda")
    ref = _loss_grads(torch, kops, step, cfg, params, batch, "ref")
    check(got[2] == 2 * L and got[3] == 0 and ref[2] == 0,
          f"train f32: flash launches {got[2]} ({got[3]} tensor-core), ref "
          f"{ref[2]}; expected {2 * L} (forward and recompute), 0")
    launches["flash_attention"] += got[2]
    loss_err = abs(float(got[0]) - float(ref[0]))
    check(loss_err <= TRAIN_LOSS_ATOL and bool(torch.isfinite(got[0])),
          f"train f32: loss cuda {float(got[0])} ref {float(ref[0])}")
    g_err, bad = _grad_err(torch, got[1], ref[1], *TRAIN_GRAD_TOL)
    check(bad == 0, f"train f32: {bad} gradient elements outside atol "
          f"{TRAIN_GRAD_TOL[0]} rtol {TRAIN_GRAD_TOL[1]} (max err "
          f"{g_err:.3e})")
    wq = float(got[1]["blocks.0.attn.wq"].abs().max())
    check(wq > 0, "train f32: the attention's gradients are zero")
    opt_cfg = optimizer.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    opt = optimizer.init_opt_state(params, opt_cfg)
    _, opt, metrics = optimizer.adamw_update(
        params, got[1], opt, opt_cfg, decay=step.decay_mask(cfg, params))
    gnorm_ref = float(optimizer.global_norm(ref[1].values()))
    gnorm = float(metrics["grad_norm"])
    check(abs(gnorm - gnorm_ref) <= TRAIN_GRAD_TOL[1] * gnorm_ref,
          f"train f32: grad_norm {gnorm} ref {gnorm_ref}")
    log(f"[train] {TRAIN_ARCH} {L} layers d_model {cfg.d_model} f32 on "
        f"{card}: one step at {TRAIN_F32_B}x{TRAIN_S}, loss_and_grads "
        f"\"cuda\" {got[4]:.2f} s (the process's first backward, its "
        f"warm-up included; {got[2]} flash launches: forward and "
        f"checkpointed recompute), \"ref\" {ref[4]:.2f} s; loss "
        f"{float(got[0]):.6f} vs {float(ref[0]):.6f} (err {loss_err:.3e}, "
        f"atol {TRAIN_LOSS_ATOL}); grad_norm {gnorm:.6f} vs "
        f"{gnorm_ref:.6f} (rtol {TRAIN_GRAD_TOL[1]}); largest gradient "
        f"difference {g_err:.3e} (atol {TRAIN_GRAD_TOL[0]}, rtol "
        f"{TRAIN_GRAD_TOL[1]}, every element); attention wq grad max "
        f"{wq:.3e}")
    del got, ref
    # (c) the checkpoint round trip
    path = ROOT / "build" / "train_smoke.npz"
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, params, opt, step=1, cfg=cfg,
                               metadata={"arch": TRAIN_ARCH})
    save_s = time.perf_counter() - t0
    fresh = transformer.init_params(cfg, 1, device=DEVICE)
    fresh_opt = optimizer.init_opt_state(fresh, opt_cfg)
    t0 = time.perf_counter()
    _, fresh_opt, ck_step = checkpoint.restore_checkpoint(
        path, fresh, fresh_opt, cfg=cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = (ck_step == 1 and int(fresh_opt.step) == 1 and all(
        torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                          params.parameters()))
        and all(torch.equal(fresh_opt.m[n], opt.m[n])
                and torch.equal(fresh_opt.v[n], opt.v[n]) for n in opt.m))
    check(same, "train: the checkpoint did not restore bitwise")
    log(f"[train] checkpoint of the f32 step (params, AdamW m and v: "
        f"{path.stat().st_size / 2 ** 30:.2f} GiB npz) saved in "
        f"{save_s:.1f} s, restored bitwise in {load_s:.1f} s")
    path.unlink()
    del params, opt, fresh, fresh_opt
    torch.cuda.empty_cache()

    # (b) the launcher in bf16 at full width
    times = []
    timed_step = launch_train.train_step

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = timed_step(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    launch_train.train_step = timed
    try:
        t0 = time.perf_counter()
        params, losses = launch_train.run(
            TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
            reduced=False, lr=3e-4, log_every=5, seed=0, device=DEVICE)
        run_s = time.perf_counter() - t0
    finally:
        launch_train.train_step = timed_step
    n_flash = kops.launch_counts()["flash_attention"]
    n_tc = kops.flash_attention.launches_tc
    want = 2 * L * TRAIN_STEPS
    check(n_flash == want and n_tc == want,
          f"train bf16: {n_flash} flash launches ({n_tc} tensor-core), "
          f"expected {want}")
    launches["flash_attention"] += n_flash
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train bf16: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s_step = statistics.median(times[1:])
    log(f"[train] launch.train.run {TRAIN_ARCH} bf16 full width on {card}: "
        f"{TRAIN_STEPS} steps of {TRAIN_B}x{TRAIN_S} in {run_s:.1f} s, "
        f"{s_step:.3f} s a step (median of steps 2-{TRAIN_STEPS}; first "
        f"{times[0]:.2f} s), {TRAIN_B * TRAIN_S / s_step:.0f} tokens/s, "
        f"peak {peak:.2f} GiB; {n_flash} flash launches ({n_tc} on the "
        f"tensor cores; expected 2 x {L} layers x {TRAIN_STEPS} steps); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    # one forward launch at the launcher's shape, timed alone
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    hd = base.resolved_head_dim
    q, k, v = (torch.randn((TRAIN_B, TRAIN_S, n, hd), generator=gen,
                           device=DEVICE, dtype=torch.bfloat16)
               for n in (base.n_heads, base.n_kv_heads, base.n_kv_heads))
    flash_ms = time_ms(torch, lambda: flash_attention_gqa(q, k, v,
                                                          causal=True))
    del q, k, v
    log(f"[train] one bf16 flash launch at {TRAIN_B}x{TRAIN_S} "
        f"({base.n_heads} over {base.n_kv_heads} heads, hd {hd}, causal): "
        f"{flash_ms:.4f} ms; {2 * L} a step: {2 * L * flash_ms:.1f} ms")
    split = _train_split(torch, base, params, step, optimizer)
    log(f"[train] one more bf16 step of {TRAIN_B}x{TRAIN_S}, split (each "
        f"part synchronized): loss_and_grads {split[0]:.3f} s, of which "
        f"the attention backward (the plain version recomputed in chunks "
        f"of 512 query rows, {L} layers) {split[1]:.3f} s "
        f"({split[1] / split[0]:.0%}); adamw_update {split[2]:.3f} s")
    del params
    torch.cuda.empty_cache()

    # (d) one vlm step of llava-next-34b at full width, 2 layers
    vcfg = dataclasses.replace(get_config(VLM_ARCH),
                               n_layers=VLM_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    vparams = transformer.init_params(vcfg, 0, device=DEVICE)
    vparams.requires_grad_(True)
    vbatch = _vlm_batch(torch, vcfg, np.random.default_rng(2))
    vbatch["labels"] = torch.as_tensor(np.random.default_rng(3).integers(
        0, vcfg.vocab_size, (1, VLM_TEXT)), device=DEVICE)
    vopt_cfg = optimizer.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=2)
    vopt = optimizer.init_opt_state(vparams, vopt_cfg)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    _, vopt, vm = step.train_step(vcfg, vopt_cfg, vparams, vopt, vbatch)
    torch.cuda.synchronize()
    v_s = time.perf_counter() - t0
    n_v = kops.launch_counts()["flash_attention"]
    n_vtc = kops.flash_attention.launches_tc
    check(n_v == n_vtc == 2 * VLM_TRAIN_LAYERS,
          f"vlm train: flash launches {n_v} ({n_vtc} tensor-core), "
          f"expected {2 * VLM_TRAIN_LAYERS}")
    launches["flash_attention"] += n_v
    check(all(bool(torch.isfinite(vm[k])) for k in ("loss", "grad_norm"))
          and float(vm["grad_norm"]) > 0,
          f"vlm train: loss {float(vm['loss'])}, grad_norm "
          f"{float(vm['grad_norm'])}")
    n_params = sum(p.numel() for p in vparams.parameters())
    log(f"[train] {VLM_ARCH} bf16 cut to {VLM_TRAIN_LAYERS} layers (d_model "
        f"{vcfg.d_model}, {vcfg.n_heads} over {vcfg.n_kv_heads} heads, hd "
        f"{vcfg.resolved_head_dim}, {n_params / 1e9:.2f} B params, f32 "
        f"AdamW state) on {card}: one train_step of {vcfg.n_frontend_tokens}"
        f" patches + {VLM_TEXT} text tokens (the CE over the text span, "
        f"padded to chunks of 512) in {v_s:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; loss "
        f"{float(vm['loss']):.4f}, grad_norm {float(vm['grad_norm']):.4f}; "
        f"{n_v} flash launches, all on the tensor cores")
    del vparams, vopt
    torch.cuda.empty_cache()
    return n_tc + n_vtc


# ----------------------------------------------------------------------
# phase 10: the vlm family (llava-next-34b)
# ----------------------------------------------------------------------

def _vlm_batch(torch, cfg, rng):
    """The stub vision encoder's patch embeddings (1, 2,880, 1,024) in the
    model's dtype and VLM_TEXT text tokens, from ``rng``."""
    from repro_torch.models import transformer
    return {"patches": torch.as_tensor(rng.standard_normal(
                (1, cfg.n_frontend_tokens, cfg.frontend_dim)),
                dtype=transformer.torch_dtype(cfg), device=DEVICE),
            "tokens": torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (1, VLM_TEXT)), device=DEVICE)}


def vlm_phase(torch, kops, launches, card):
    """llava-next-34b at full width cut to VLM_LAYERS layers: per dtype
    ``prefill_step`` over 2,880 patches and VLM_TEXT tokens through "cuda"
    against "ref" (f32 atol 1e-4, rtol 3e-3 on the logits and the cache;
    bf16 max error), one flash launch a layer (on the tensor cores in
    bf16).  Returns the tensor-core flash launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    base = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    n_tc = 0
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, 0, device=DEVICE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = _vlm_batch(torch, cfg, np.random.default_rng(4))
        rule = "close" if dtype == "float32" else "print"
        got, errs, first, warm, ref_ms, dev_ms, tc = _prefill_cell(
            torch, kops, launches, cfg, params, batch, VLM_LAYERS, rule)
        n_tc += tc
        S = cfg.n_frontend_tokens + VLM_TEXT
        check(tuple(got[1]["k"].shape) == (VLM_LAYERS, 1, S, cfg.n_kv_heads,
                                           cfg.resolved_head_dim),
              f"vlm {dtype}: cache {tuple(got[1]['k'].shape)}")
        del got
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[vlm] {VLM_ARCH} cut to {VLM_LAYERS} layers (d_model "
            f"{cfg.d_model}, {cfg.n_heads} over {cfg.n_kv_heads} heads, hd "
            f"{cfg.resolved_head_dim}) {dtype} on {card}: {_gib(params):.2f}"
            f" GiB of weights (drawn in {init_s:.1f} s), peak {peak:.2f} "
            f"GiB; prefill of {cfg.n_frontend_tokens} patches + {VLM_TEXT} "
            f"tokens ({S} positions) {warm:.1f} ms warm ({first:.1f} ms "
            f"first; \"ref\" {ref_ms:.1f} ms; device at most {dev_ms:.1f} "
            f"ms, queued ahead), {VLM_LAYERS} flash launches, "
            f"{VLM_LAYERS if dtype == 'bfloat16' else 0} on the tensor "
            "cores (\"ref\": 0); cuda vs ref max err: "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs)
            + (" (atol 1e-4, rtol 3e-3)" if rule == "close" else ""))
        del params
        torch.cuda.empty_cache()
    return n_tc


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.core.graph import csr_from_edges_distributed, \
        make_dataset
    from repro_torch.core.ops import resolve_device
    from repro_torch.core.sampler import sample_layer_graphs
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops

    t_start = time.perf_counter()
    resolve_device(DEVICE)               # TF32 off for the f32 GEMMs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    log(f"[build] {len(logs)} nvcc builds in {time.perf_counter() - t0:.1f}"
        " s (sm_90a)")
    if "flash_attention" in logs:        # the f32 tiles for hd <= 128
        spilled = [e for e, st in ptxas_spills(logs["flash_attention"])
                   .items() if ("TileILi64E" in e or "TileILi128E" in e)
                   and st != (0, 0)]
        check(not spilled, f"flash_attention: f32 tiles for hd <= 128 "
              f"spill: {spilled}")
        log("[build] flash_attention: the f32 tiles for hd <= 64 and "
            "<= 128 spill nothing")
    for name, text in logs.items():      # ptxas: registers, any spills
        regs = [int(line.split("Used ")[1].split()[0])
                for line in text.splitlines() if "registers" in line]
        smem = [int(line.split(" bytes smem")[0].split()[-1])
                for line in text.splitlines() if " bytes smem" in line]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and not line.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, 0 bytes")]
        slow = [line.split("Potential Performance Loss: ")[1].split(
            " in the function")[0] for line in text.splitlines()
            if "Potential Performance Loss" in line]
        log(f"[build] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)}"
            f" registers, at most {max(smem, default=0)} bytes of static "
            f"shared memory; spills: {spills or 'none'}; ptxas performance "
            f"warnings: {slow or 'none'}")
    # the tensor-core flash kernel really is on the tensor cores
    sass = subprocess.run(
        [str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
         str(build.library_path("flash_attention_sm90"))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    check(n_hgmma > 0, "flash_attention_sm90: no HGMMA in its SASS")
    log(f"[build] flash_attention_sm90: {n_hgmma} HGMMA instructions in "
        "its SASS (cuobjdump -sass)")

    t0 = time.perf_counter()
    src_e, dst_e, n = make_dataset("ogbn-papers100M", seed=0,
                                   scale=N_NODES_SCALE)
    g, _ = csr_from_edges_distributed(src_e, dst_e, n)
    lg = sample_layer_graphs(g, FANOUT, 1, seed=0)[0]
    lg64 = sample_layer_graphs(g, WIDE_FANOUT, 1, seed=0)[0]
    log(f"[kernels] layer graph of {n} nodes, {g.n_edges} edges in "
        f"{time.perf_counter() - t0:.1f} s")
    rows = kernel_phase(torch, kops, lg)
    torch.cuda.empty_cache()
    winners = tune_phase(torch, kops, lg)
    torch.cuda.empty_cache()
    gat_wide_phase(torch, kops, lg, lg64, rows)
    del src_e, dst_e, g, lg64
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows["flash_attention"] = flash_phase(torch, kops)
    log(f"[flash] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    launches = {name: 0 for name in kops.KERNELS}
    wide = {"gat_attention": 0, "sddmm": 0}
    gemm_check(torch)
    lg0 = slice_phase(torch, kops, launches, wide, winners)
    featprep_phase(torch, kops, lg0, launches)
    del lg0
    torch.cuda.empty_cache()
    ego_phase(torch, kops, launches)
    torch.cuda.empty_cache()
    launcher_phase(torch, kops, launches)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_phase(torch, kops, launches)
    log(f"[dist] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cluster_phase(torch, kops, launches)
    log(f"[cluster] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    n_tc = llm_phase(torch, kops, launches, smi)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_tc += moe_phase(torch, kops, launches, smi)
    log(f"[moe] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_tc += ssm_phase(torch, kops, launches, smi)
    log(f"[ssm] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_tc += train_phase(torch, kops, launches, smi)
    log(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_tc += vlm_phase(torch, kops, launches, smi)
    log(f"[vlm] phase took {time.perf_counter() - t0:.1f} s")
    for name, v in launches.items():
        check(v > 0, f"{name}: never launched on the main path")
        rows[name]["launches"] = v
    check(n_tc > 0, "flash_attention_sm90: never launched on the main path")
    rows["flash_attention"]["launches_bf16"] = n_tc
    for name, v in wide.items():     # the main path's shapes are narrow
        rows[name]["launches_wide"] = v
    log(f"[done] launches on the main path: {launches} ({n_tc} flash on "
        "the tensor cores); "
        f"{time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": [rows[n] for n in kops.KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
