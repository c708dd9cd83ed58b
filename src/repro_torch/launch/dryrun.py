"""The dry-run: trace every (arch x shape x mesh) step on the meta device
— the twin of ``repro.launch.dryrun``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \
      --shape train_4k --mesh card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
      [--force] [--tuning moe_ep,cp_decode]

``--mesh``: ``card`` (1 x 1: the one H100), ``single`` (16 x 16),
``multi`` (2 x 16 x 16) or ``both`` (single and multi).  JAX lowers and
compiles the step for 256 or 512 placeholder devices; here "lower" is
one run of the step (``launch.inputs.step_arguments``) on meta tensors,
which hold shapes and no storage, inside ``sharding_context(mesh)``.
The attention is the flash kernel's path (``attn_backend="cuda"``): on
a meta tensor its wrapper is one op, ``torch.ops.repro_torch.
flash_attention``, that allocates the kernel's output and whose FLOPs
are the (query, key) pairs its mask keeps (``kernels.flash_attention``).
A train step's backward is ``FlashAttentionFn``'s, the plain version
recomputed under autograd, as the port runs it: its (S, S) scores a
layer show in a train record's temp.

On ``card`` the step runs on the unplaced arguments, on one device.  On
``single`` and ``multi`` it is the step the port's launchers run on a
mesh: the arguments are placed by their specs (``sharding.placement``,
outside the counted window: JAX's step has no ``device_put``) on a
meta mesh with the production mesh's axes (``launch.mesh.
make_meta_mesh``: every shard the meta device), the batch of a train
step too (as ``launch.train.run`` places it) and the inputs of prefill
and decode on the home (decode's position a host int, ``DECODE_POS``),
then ``train.step._placed_train_step`` (``train_step`` on placed params),
or prefill and ``decode_step`` on placed params and caches, with the
mesh paths that ``--tuning`` turns on (``moe_ep``, ``cp_decode``,
``serve_tp``, ``gqa_cache_seq``, ``mla_cache_seq``).  Nothing is
compiled, so the record has no ``compile_s``; ``place_s`` is the
placement's time, ``lower_s`` the step's.  A combo the placed path
cannot run is recorded with ``status: "error"`` and the reason.  Each
combo writes ``results/dryrun_torch/<arch>__<shape>__<mesh>[__<flags>]
.json`` with JAX's keys:

- ``memory_analysis``, a chip's share: ``argument_size_in_bytes`` from
  ``sharding.per_chip_bytes`` of the arguments and their specs (exact),
  ``output_size_in_bytes`` likewise of the outputs,
  ``alias_size_in_bytes`` that of the donated arguments the step writes
  in place, and ``temp_size_in_bytes``: the peak of the bytes the step
  allocates and holds at once (outputs included, arguments not), over
  the trace, divided by the chips (exact on ``card``);
- ``cost_analysis``: ``flops`` and ``bytes_accessed`` a chip, the
  global counts divided over the chips; ``flops_global`` is
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the step
  (matmuls and the flash op: no elementwise op is counted),
  ``bytes_accessed_global`` the bytes every non-view aten op reads and
  writes (its tensor inputs and outputs), the eager port's unfused
  traffic (a message between shards copies nothing on the meta mesh
  and is not in it);
- ``collectives``: JAX's keys, each the bytes that the busiest
  receiving shard receives in the step (JAX's are one device's
  payload), from the step's messages (``Mesh.links``), mapped from the
  port's kinds (``COLLECTIVE_KIND``) as below; ``count`` the rounds of
  messages (one ``Exchange`` each), ``total`` the sum of the five
  kinds; besides them ``by_kind`` (the port's kinds, the busiest
  receiving shard's bytes of each), ``by_kind_global`` (``Mesh.sent``:
  every shard's) and ``home`` (the bytes shard 0 receives).  0 on
  ``card``: one device, nothing to exchange;
- ``roofline`` (``roofline.analysis.roofline_terms`` on the H100's
  table, the collective term from ``collectives["total"]``),
  ``model_flops_global`` and ``model_flops_ratio``.

  JAX kind              the port's kinds
  all-gather            params, replicas, cache, experts, scalars
  reduce-scatter        grads, partials
  all-reduce            softmax, aux, loss, norm
  all-to-all            tokens, batch
  collective-permute    entries

"cache" (a placed cache gathered whole to the home's attention) and
"experts" (expert blocks gathered over ``data``) are all-gathers like
"params"; "scalars" (AdamW's step constants sent out from the home)
is a broadcast, as "replicas" is; "aux", "loss" and "norm" are scalar
sums to the home, as JAX all-reduces them; "batch" moves a data shard's
rows to its card.  "place" and "gather" are placement and checkpoints,
never in a step.

On the production meshes the placed step's work is not spread evenly:
the port gathers each layer whole to the card that computes with it
(the home, or data shard p's (p, 0) in training), so that card holds
and computes more than ``temp_size_in_bytes`` and ``flops``, a chip's
even share; ``collectives["home"]`` gives the bytes it receives.
Records never go to ``results/dryrun/``, which holds the JAX package's.
"""
from __future__ import annotations

import argparse
import collections
import functools
import gc
import json
import os
import pathlib
import time
import traceback
import weakref
from typing import Dict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config, \
    get_shape
from torch import nn

from repro_torch.launch.inputs import ATTN_BACKEND, step_arguments
from repro_torch.launch.mesh import (AbstractMesh, make_meta_mesh,
                                     make_production_mesh)
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.sharding.context import sharding_context
from repro_torch.sharding.placement import Placed, place_module, place_tree
from repro_torch.sharding.specs import per_chip_bytes

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")
MESHES = {
    "card": lambda: AbstractMesh({"data": 1, "model": 1}),
    "single": make_production_mesh,
    "multi": functools.partial(make_production_mesh, multi_pod=True),
}
JAX_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")
COLLECTIVE_KIND = {
    "params": "all-gather", "replicas": "all-gather", "cache": "all-gather",
    "experts": "all-gather", "scalars": "all-gather",
    "grads": "reduce-scatter", "partials": "reduce-scatter",
    "softmax": "all-reduce", "aux": "all-reduce", "loss": "all-reduce",
    "norm": "all-reduce",
    "tokens": "all-to-all", "batch": "all-to-all",
    "entries": "collective-permute",
}
NOT_IN_A_STEP = ("place", "gather")


def decode_pos(shape) -> int:
    """The position a placed decode step writes: the cache's last."""
    return shape.seq_len - 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Counts, for every aten op under it: the bytes a non-view op reads
    and writes (its tensor inputs and outputs), and the live bytes of
    the storages the ops create (views and in-place ops create none),
    with their peak.  A storage stops counting when it is freed."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._live = set()

    def _free(self, key, n):
        self._live.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(map(_nbytes, ins + outs))
        if not any(r.alias_info is not None for r in func._schema.returns):
            for t in outs:           # a new storage for each new output
                st = t.untyped_storage()
                key = st._cdata
                if key in self._live:
                    continue
                n = st.nbytes()
                self._live.add(key)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key, n)
        return out


def trace(fn, args, mesh):
    """Run ``fn(*args)`` once inside ``sharding_context(mesh)``.  Returns
    (its output, FLOPs, bytes accessed, peak live bytes)."""
    with sharding_context(mesh), FlopCounterMode(display=False) as fc, \
            TraceCounter() as tc:
        out = fn(*args)
    return out, fc.get_total_flops(), tc.bytes_accessed, tc.peak


def place_arguments(shape, args, specs, mesh, pos=None):
    """``step_arguments``' ``args`` placed by ``specs`` on ``mesh`` as
    the port's launchers place them: params, AdamW state and caches by
    their specs, a train batch too (``launch.train.run``); the inputs of
    prefill and decode stay on the home, decode's position a host int
    (``pos``, default ``decode_pos(shape)``)."""
    params = place_module(args[0], specs[0], mesh)
    if shape.kind == "train":
        return (params, place_tree(args[1], specs[1], mesh),
                place_tree(args[2], specs[2], mesh))
    if shape.kind == "prefill":
        return params, args[1]
    batch = dict(args[2], pos=decode_pos(shape) if pos is None else pos)
    return params, place_tree(args[1], specs[1], mesh), batch


def _unplaced(tree):
    """``tree`` with each placed leaf a meta tensor of its shape, a
    params module a {name: leaf} dict (for ``per_chip_bytes``)."""
    if isinstance(tree, Placed):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, nn.Module):
        return {n: _unplaced(x) for n, x in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _unplaced(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*map(_unplaced, tree)) if hasattr(
            tree, "_fields") else tuple(map(_unplaced, tree))
    return tree


def _step_messages(mesh) -> Dict[str, Dict[int, int]]:
    """{kind: {receiving shard: bytes}} of the messages ``mesh`` counted,
    placement's and checkpoints' left out: a step's."""
    return {k: v for k, v in mesh.received().items()
            if k not in NOT_IN_A_STEP}


def collectives(mesh) -> dict:
    """JAX's ``collectives`` record of the step's messages on ``mesh``:
    per JAX kind the bytes the busiest receiving shard receives
    (``COLLECTIVE_KIND``), ``count``, ``total``, and ``by_kind``,
    ``by_kind_global`` and ``home`` (module docstring)."""
    recv = _step_messages(mesh)
    per = {k: collections.Counter() for k in JAX_KINDS}
    for kind, shards in recv.items():
        per[COLLECTIVE_KIND[kind]].update(shards)
    out = {k: max(per[k].values(), default=0) for k in JAX_KINDS}
    out["count"] = sum(n for k, n in mesh.rounds.items()
                       if k not in NOT_IN_A_STEP)
    out["total"] = sum(out[k] for k in JAX_KINDS)
    out["by_kind"] = {k: max(v.values()) for k, v in sorted(recv.items())}
    out["by_kind_global"] = {k: sum(v.values())
                             for k, v in sorted(recv.items())}
    out["home"] = sum(v.get(0, 0) for v in recv.values())
    return out


def placed_counts(cfg, shape, mesh, pos=None) -> Dict[str, Dict[int, int]]:
    """{kind: {receiving shard: bytes}} of one placed step of (``cfg``,
    ``shape``) on a meta mesh of ``mesh``'s axes (an ``AbstractMesh``,
    a ``Mesh`` or a {axis: size} dict), run as ``dry_run`` runs it,
    under the ``tuning`` flags set now: what a mesh of cards counts in
    ``Mesh.links`` for the same step (``Mesh.received``)."""
    meta = make_meta_mesh(mesh)
    fn, args, specs, _, _ = step_arguments(cfg, shape, meta)
    run = place_arguments(shape, args, specs, meta, pos)
    with sharding_context(meta):
        fn(*run)
    return _step_messages(meta)


def dry_run(cfg, shape, mesh_kind: str, variant: str = "baseline") -> dict:
    """The record of one (config, ``InputShape``, mesh) combo; custom
    configs and shapes (dataclasses) are taken as they are."""
    abstract = MESHES[mesh_kind]()
    n_chips = abstract.size
    rec = {"arch": cfg.arch_id, "shape": shape.name, "mesh": mesh_kind,
           "n_chips": n_chips, "variant": variant, "status": "ok",
           "attn_backend": ATTN_BACKEND, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len, "kind": shape.kind}
    t0 = time.time()
    fn, args, specs, out_specs, donate = step_arguments(cfg, shape,
                                                        abstract)
    mesh, run = abstract, args
    if mesh_kind != "card":
        mesh = make_meta_mesh(abstract)
        run = place_arguments(shape, args, specs, mesh)
    rec["place_s"] = round(time.time() - t0, 2)
    t1 = time.time()
    out, flops, bytes_, peak = trace(fn, run, mesh)
    rec["lower_s"] = round(time.time() - t1, 2)
    rec["memory_analysis"] = {
        "argument_size_in_bytes": per_chip_bytes(args, specs, abstract),
        "output_size_in_bytes": per_chip_bytes(_unplaced(out), out_specs,
                                               abstract),
        "alias_size_in_bytes": per_chip_bytes(
            [args[i] for i in donate], [specs[i] for i in donate],
            abstract),
        "temp_size_in_bytes": peak // n_chips,
    }
    rec["cost_analysis"] = {
        "flops": flops / n_chips, "bytes_accessed": bytes_ / n_chips,
        "flops_global": flops, "bytes_accessed_global": bytes_}
    if mesh_kind == "card":
        rec["collectives"] = {**{k: 0 for k in JAX_KINDS}, "count": 0,
                              "total": 0, "by_kind": {},
                              "by_kind_global": {}, "home": 0}
    else:
        rec["collectives"] = collectives(mesh)
    terms = roofline_terms(
        total_flops=flops, total_bytes=bytes_,
        collective_bytes_per_chip=rec["collectives"]["total"],
        n_chips=n_chips, flops_are_global=True)
    rec["roofline"] = terms.as_dict()
    mf = model_flops(cfg, shape)
    rec["model_flops_global"] = mf
    rec["model_flops_ratio"] = mf / flops if flops else None
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def run_combo(arch: str, shape_name: str, mesh_kind: str,
              variant: str = "baseline") -> dict:
    return dry_run(get_config(arch), get_shape(shape_name), mesh_kind,
                   variant)


def combo_path(arch, shape_name, mesh_kind, variant="baseline"):
    suffix = "" if variant == "baseline" else f"__{variant}"
    return RESULTS / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"


def _record(arch, shape_name, mesh_kind, variant):
    """Run one combo and write its record (an error's too).  Returns
    (ok, the lines to print)."""
    lines = [f"=== dryrun {arch} {shape_name} {mesh_kind} [{variant}] ==="]
    try:
        rec = run_combo(arch, shape_name, mesh_kind, variant)
        ok = True
        ma, ca = rec["memory_analysis"], rec["cost_analysis"]
        lines.append(
            f"  args/chip {ma['argument_size_in_bytes'] / 1e9:.2f} GB, "
            f"temp/chip {ma['temp_size_in_bytes'] / 1e9:.2f} GB, flops "
            f"{ca['flops_global']:.4g} (model "
            f"{rec['model_flops_global']:.4g}), collectives/chip "
            f"{rec['collectives']['total'] / 1e9:.3f} GB, place "
            f"{rec['place_s']} s, step {rec['lower_s']} s")
    except Exception as e:  # record the failure, keep going
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        lines.append(f"FAILED: {e}")
        ok = False
    combo_path(arch, shape_name, mesh_kind, variant).write_text(
        json.dumps(rec, indent=1))
    gc.collect()
    return ok, lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["card", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tuning", default="",
                    help="comma flags (see repro_torch/tuning.py); records "
                         "are written under a variant suffix")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combos traced at once, each in a process of its "
                         "own (a placed train step on the 2 x 16 x 16 mesh "
                         "takes minutes and GBs of host memory)")
    args = ap.parse_args(argv)
    variant = "baseline"
    if args.tuning:
        os.environ["REPRO_TUNING"] = args.tuning
        variant = args.tuning.replace(",", "+")

    RESULTS.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    combos = []
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([get_shape(args.shape)] if args.shape
                  else applicable_shapes(cfg))
        for sh in shapes:
            for mk in meshes:
                combos.append((arch, sh.name, mk))

    todo = [c for c in combos
            if args.force or not combo_path(*c, variant).exists()]
    n_skip = len(combos) - len(todo)
    n_ok = n_fail = 0
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing
                                 .get_context("spawn")) as pool:
            results = pool.map(_record, *zip(*todo),
                               [variant] * len(todo)) if todo else []
            for ok, lines in results:
                print("\n".join(lines), flush=True)
                n_ok, n_fail = n_ok + ok, n_fail + (not ok)
    else:
        for c in todo:
            print(f"=== dryrun {c[0]} {c[1]} {c[2]} [{variant}] ===",
                  flush=True)
            ok, lines = _record(*c, variant)
            print("\n".join(lines[1:]), flush=True)
            n_ok, n_fail = n_ok + ok, n_fail + (not ok)
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")


if __name__ == "__main__":
    main()
