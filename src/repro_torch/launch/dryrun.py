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
which hold shapes and no storage, inside ``sharding_context(mesh)``,
with the attention's plain version (``attn_backend="ref"``: the
kernels' wrappers raise on a meta tensor).  Nothing is compiled, so the
record has no ``compile_s``.  Each combo writes
``results/dryrun_torch/<arch>__<shape>__<mesh>[__<flags>].json`` with
JAX's keys:

- ``memory_analysis``, a chip's share: ``argument_size_in_bytes`` from
  ``sharding.per_chip_bytes`` of the arguments and their specs (exact),
  ``output_size_in_bytes`` likewise of the outputs,
  ``alias_size_in_bytes`` that of the donated arguments the step writes
  in place, and ``temp_size_in_bytes``: the peak of the bytes the step
  allocates and holds at once (outputs included, arguments not), over
  the trace, divided by the chips (exact on ``card``; on the production
  meshes it assumes activations split evenly);
- ``cost_analysis``: ``flops`` and ``bytes_accessed`` a chip, the
  global counts divided over the chips; ``flops_global`` is
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the step
  (matmuls only: no elementwise op is counted), ``bytes_accessed_global``
  the bytes every non-view aten op reads and writes (its tensor inputs
  and outputs), the eager port's unfused traffic;
- ``collectives``: 0 on ``card`` (one device, nothing to exchange),
  None with the reason on the production meshes (JAX parses them out
  of XLA's partitioned HLO; the port has none);
- ``roofline`` (``roofline.analysis.roofline_terms`` on the H100's
  table), ``model_flops_global`` and ``model_flops_ratio``.

The "ref" attention computes every (query, key) score, the masked half
of a causal attention too, and holds the (B, K, G, Sq, Skv) scores: the
flash kernel does neither, so the FLOPs and the temp bytes of a long
prefill are the plain version's.  Records never go to
``results/dryrun/``, which holds the JAX package's.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config, \
    get_shape
from repro_torch.launch.inputs import ATTN_BACKEND, step_arguments
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.sharding.context import sharding_context
from repro_torch.sharding.specs import per_chip_bytes

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")
MESHES = {
    "card": lambda: AbstractMesh({"data": 1, "model": 1}),
    "single": make_production_mesh,
    "multi": functools.partial(make_production_mesh, multi_pod=True),
}
NO_HLO = ("not measured: JAX parses collective bytes out of XLA's "
          "partitioned HLO; the port traces one device's program and has "
          "no partitioner")


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


def dry_run(cfg, shape, mesh_kind: str, variant: str = "baseline") -> dict:
    """The record of one (config, ``InputShape``, mesh) combo; custom
    configs and shapes (dataclasses) are taken as they are."""
    mesh = MESHES[mesh_kind]()
    n_chips = mesh.size
    rec = {"arch": cfg.arch_id, "shape": shape.name, "mesh": mesh_kind,
           "n_chips": n_chips, "variant": variant, "status": "ok",
           "attn_backend": ATTN_BACKEND, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len, "kind": shape.kind}
    t0 = time.time()
    fn, args, specs, out_specs, donate = step_arguments(cfg, shape, mesh)
    out, flops, bytes_, peak = trace(fn, args, mesh)
    rec["lower_s"] = round(time.time() - t0, 2)
    rec["memory_analysis"] = {
        "argument_size_in_bytes": per_chip_bytes(args, specs, mesh),
        "output_size_in_bytes": per_chip_bytes(out, out_specs, mesh),
        "alias_size_in_bytes": per_chip_bytes(
            [args[i] for i in donate], [specs[i] for i in donate], mesh),
        "temp_size_in_bytes": peak // n_chips,
    }
    rec["cost_analysis"] = {
        "flops": flops / n_chips, "bytes_accessed": bytes_ / n_chips,
        "flops_global": flops, "bytes_accessed_global": bytes_}
    if mesh_kind == "card":
        rec["collectives"] = {"total": 0, "count": 0}
    else:
        rec["collectives"] = {"total": None, "count": None,
                              "reason": NO_HLO}
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

    n_ok = n_fail = n_skip = 0
    for arch, shape_name, mesh_kind in combos:
        out = combo_path(arch, shape_name, mesh_kind, variant)
        if out.exists() and not args.force:
            n_skip += 1
            continue
        print(f"=== dryrun {arch} {shape_name} {mesh_kind} "
              f"[{variant}] ===", flush=True)
        try:
            rec = run_combo(arch, shape_name, mesh_kind, variant)
            n_ok += 1
            ma, ca = rec["memory_analysis"], rec["cost_analysis"]
            print(f"  args/chip {ma['argument_size_in_bytes'] / 1e9:.2f} GB"
                  f", temp/chip {ma['temp_size_in_bytes'] / 1e9:.2f} GB, "
                  f"flops {ca['flops_global']:.4g} "
                  f"(model {rec['model_flops_global']:.4g}), "
                  f"{rec['lower_s']} s", flush=True)
        except Exception as e:  # record the failure, keep going
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"FAILED: {e}", flush=True)
            n_fail += 1
        out.write_text(json.dumps(rec, indent=1))
        gc.collect()
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")


if __name__ == "__main__":
    main()
