"""One run of one cell: set-up, the measured window, the traced reading,
the check against the plain reference, and the result line.

Set-up follows ``Session.build``'s order: the benchmark makes the edges,
the features and the params from the seed (``inputs``); the port builds
the CSR (``core.graph.csr_from_edges_distributed``), samples the layer
graphs (``core.sampler.sample_layer_graphs``, one call a run of equal
per-layer fanouts), builds its executor
(``api.config.ExecutorSpec(...).build``, which compiles the kernels
into ``build/kernels/`` the first time) and takes the params
(``core.gnn_models.params_from_numpy``); one warm epoch follows.

The window runs back-to-back all-node epochs, each one call of
``core.layerwise.LOCAL_ENGINES[model]`` from the host-resident layer
graphs and features, ended by a device synchronize, until ``seconds``
have passed; the last epoch runs to its end.  Nothing of one epoch is
kept on the card for the next.

With ``trace`` the same window is followed by epochs under the port's
``obs`` spans and epochs under ``torch.profiler``, which the per-layer
metrics' readers (``metrics/<name>.py``) read.  Then the program's
state is freed and the last window epoch's embeddings are compared with
the plain reference (``reference``), run on the same inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import inspect
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gnnbench import devtrace, inputs, reference, yardstick

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
TRACE_DIR = ROOT / "build" / "gnnbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPAN_SECONDS = 1.0        # epochs under spans: at least this long, 3 or more
PROFILE_SECONDS = 1.0     # epochs under the profiler, after one to warm it


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, a
    forbidden import): the caller exits non-zero and prints nothing."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not
    load: JAX, its libraries and the JAX package, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def check_modules() -> None:
    bad = forbidden_modules()
    if bad:
        raise BenchError("forbidden modules loaded: " + ", ".join(bad))


@dataclasses.dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` names it, with its files read."""
    name: str
    chips: int
    cfg: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(bench: Dict, workload: str) -> Cell:
    """The cell ``workload``: its configuration's file, its traffic's
    ``traffic/<name>.json``, its limits from ``cells/<name>.json``, and
    the metrics that it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r}; the cells are "
                         + ", ".join(sorted(cells)))
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    if traffic.get("loop") != "closed":
        raise BenchError(f"traffic {w['traffic']!r}: only the closed loop "
                         "of back-to-back epochs is generated")
    if len(traffic["fanouts"]) != int(cfg["n_layers"]):
        raise BenchError(f"traffic {w['traffic']!r} has "
                         f"{len(traffic['fanouts'])} fanouts for "
                         f"{conf['name']}'s {cfg['n_layers']} layers")
    limits = load_json(HERE / "cells" / f"{workload}.json")["limits"]

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    return Cell(workload, int(w["chips"]), cfg, traffic, limits,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def require_cards(chips: int) -> str:
    """The card's name, or BenchError when fewer than ``chips`` cards are
    visible: the benchmark never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise BenchError("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible")
    return torch.cuda.get_device_name(0)


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def host_state() -> Dict[str, float]:
    """This process's CPU seconds so far, in user and system mode."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": ru.ru_utime, "sys_s": ru.ru_stime}


def host_delta(a: Dict[str, float], b: Dict[str, float],
               window_s: float) -> Dict:
    """The window as this process saw it, to tell a run that waited for
    the host's cores from one whose host did the same work slower: its
    CPU seconds over the window's, the share of them in the kernel
    (page faults, copies' staging), the cores it may run on."""
    user, sys_ = b["user_s"] - a["user_s"], b["sys_s"] - a["sys_s"]
    return {"cpu_per_wall": (user + sys_) / window_s,
            "sys_share": sys_ / max(user + sys_, 1e-9),
            "cpus": sorted(os.sched_getaffinity(0))}


@dataclasses.dataclass
class Context:
    """What the metrics' readers read (``metrics/<name>.py``'s
    ``read(ctx)``; None where there is nothing to read)."""
    cell: Cell
    n_nodes: int
    timings: Dict[str, float]
    epochs_s: List[float]
    window_s: float
    peak_bytes: int
    span_epochs: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)
    trace: Dict = dataclasses.field(default_factory=dict)
    layer_stats: List[Dict[str, int]] = dataclasses.field(
        default_factory=list)


def reader(name: str) -> Callable[[Context], Optional[float]]:
    return importlib.import_module(f"gnnbench.metrics.{name}").read


def read_metrics(metrics: List[Dict], ctx: Context) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Program:
    """The system under test after set-up: the benchmark's inputs and
    the port's layer graphs, executor, params and engine."""
    model: str
    fanouts: List[int]
    src: np.ndarray
    dst: np.ndarray
    X: np.ndarray
    tree: Dict
    draws: List
    device: torch.device
    lgs: List = None
    ex: object = None
    params: Dict = None
    run: Callable = None
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def epoch(self):
        """One all-node epoch through the port's engine, synchronized."""
        H = self.run(self.lgs, self.X, self.params, executor=self.ex)
        sync(self.device)
        return H

    def free(self) -> None:
        """Drop the port's state, so that the reference runs beside the
        program's outputs alone."""
        self.lgs = self.ex = self.params = self.run = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32") -> torch.Tensor:
        return reference.embed_all(self.model, self.src, self.dst, self.X,
                                   self.tree, self.draws, self.device,
                                   precision)


def set_up(cell: Cell, seed: int, dev: torch.device,
           engine: Optional[Callable] = None) -> Program:
    """``Session.build``'s order: the inputs from the seed, the port's
    CSR and layer graphs (each timed), its executor and params; no
    epoch yet.  ``engine`` (tests) takes the port's engine's place."""
    from repro_torch.api.config import ExecutorSpec
    from repro_torch.core.gnn_models import params_from_numpy
    from repro_torch.core.graph import csr_from_edges_distributed
    from repro_torch.core.layerwise import LOCAL_ENGINES
    from repro_torch.core.sampler import sample_layer_graphs

    cfg = cell.cfg
    t = time.perf_counter()
    fanouts = [int(f) for f in cell.traffic["fanouts"]]
    p = Program(cfg["model"], fanouts,
                *inputs.make(cfg, fanouts, seed, dev), device=dev)
    p.timings["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    graph, _ = csr_from_edges_distributed(p.src, p.dst, p.X.shape[0])
    p.timings["construct_s"] = time.perf_counter() - t
    t = time.perf_counter()
    p.lgs = [lg for fanout, n, s in p.draws
             for lg in sample_layer_graphs(graph, fanout, n, s)]
    p.timings["sample_s"] = time.perf_counter() - t
    del graph
    t = time.perf_counter()
    p.ex = ExecutorSpec(**cfg["executor"]).build(device=dev)
    p.params = params_from_numpy(p.model, p.tree, dev)
    p.run = engine or LOCAL_ENGINES[p.model]
    p.timings["executor_s"] = time.perf_counter() - t
    return p


def run_cell(bench: Dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device="cuda", t_start: float,
             cfg_overrides: Optional[Dict] = None,
             engine: Optional[Callable] = None) -> Dict:
    """One run; returns the result line's object.  ``cfg_overrides`` and
    ``engine`` are for tests: a smaller configuration on the CPU, and an
    engine put in the port's place."""
    cell = load_cell(bench, workload)
    cell.cfg.update(cfg_overrides or {})
    dev = torch.device(device)
    kind = require_cards(cell.chips) if dev.type == "cuda" else "cpu"

    # -- set-up --------------------------------------------------------
    prog = set_up(cell, seed, dev, engine)
    t = time.perf_counter()
    H = prog.epoch()                              # warms every shape
    prog.timings["warm_epoch_s"] = time.perf_counter() - t
    del H
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timings = dict(prog.timings, setup_s=time.perf_counter() - t_start)

    # -- the window ----------------------------------------------------
    host = host_state()
    epochs: List[float] = []
    H = None
    t0 = time.perf_counter()
    while True:
        H = None                      # nothing of the last epoch is kept
        a = time.perf_counter()
        H = prog.epoch()
        b = time.perf_counter()
        epochs.append(b - a)
        if b - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    host = host_delta(host, host_state(), window_s)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    check_modules()
    N = prog.X.shape[0]
    ctx = Context(cell, N, timings, epochs, window_s, int(peak))

    result_device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "kind": kind, "count": cell.chips,
                     "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        ctx.span_epochs = span_epochs(prog.epoch, epochs, dev)
        ctx.trace = profile_epochs(prog.epoch, epochs, dev, workload)
        ctx.layer_stats = [yardstick.layer_stats(
            torch.as_tensor(lg.nbr, device=dev),
            torch.as_tensor(lg.mask, device=dev)) for lg in prog.lgs]
        result_device["busy_s"] = ctx.trace.get("busy_s", 0.0)
        result_device["window_s"] = ctx.trace.get("window_s", 0.0)
        breakdown = {"device_ops": [list(x) for x in
                                    ctx.trace.get("device_ops", [])],
                     "idle_gaps": [list(x) for x in
                                   ctx.trace.get("idle_gaps", [])]}
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           ctx)

    # -- the check: the program's state freed, the reference run -------
    prog.free()
    correct, checks = yardstick.judge(
        yardstick.errors(H, prog.reference()), cell.limits)
    del H
    check_modules()

    out = {"correct": correct, "attempted": len(epochs),
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["info"] = {
        "epochs_s": epochs, "setup_parts_s": timings,
        "n_nodes": N, "n_edges": int(prog.src.shape[0]),
        "fanouts": prog.fanouts, "seed": seed, "host": host,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "power_limit": power_limit() if dev.type == "cuda" else None,
        "torch": torch.__version__}
    if ctx.layer_stats:
        out["info"]["layer_graphs"] = ctx.layer_stats
    out["checks"] = checks
    return out


# The binding's calls, which the port has no span of its own around yet:
# (module, class, attribute, label).  In the traced epochs the harness
# wraps each in an ``obs`` span and a ``record_function`` range of that
# label, so that ``DenseIO.mean_w``, built lazily inside the first
# ``ops.spmm`` span of a layer, is taken out of the ops' time, and so
# that the profiler's idle gaps carry the binding's names.  The per-layer
# metrics' definitions rest on every probe: one whose attribute the port
# no longer has is a BenchError, not a probe skipped.
PROBES = (("repro_torch.core.ops", "DenseIO", "__init__", "bind.DenseIO"),
          ("repro_torch.core.ops", "DenseIO", "mean_w", "bind.mean_w"),
          ("repro_torch.core.ops", "CudaExecutor", "prepare",
           "bind.prepare"))


def _probe(fn, label, dev, sync_each):
    from repro_torch import obs
    from torch.profiler import record_function

    @functools.wraps(fn)
    def probe(*args, **kwargs):
        with obs.span(label), record_function(label):
            if sync_each:
                sync(dev)
            out = fn(*args, **kwargs)
            if sync_each:
                sync(dev)
        return out
    return probe


@contextlib.contextmanager
def probes(dev: torch.device, sync_each: bool):
    """``PROBES`` installed for the ``with`` body, then removed.
    ``sync_each`` synchronizes the device at each probe's ends (the
    span epochs), so that a span holds its own device work."""
    patched = []
    try:
        for mod, cls, attr, label in PROBES:
            owner = getattr(importlib.import_module(mod), cls, None)
            if owner is None or not hasattr(owner, attr):
                raise BenchError(f"probe {label}: {mod}.{cls}.{attr} is "
                                 "gone; ops_ms and bind_prepare_ms rest "
                                 "on it")
            orig = inspect.getattr_static(owner, attr)
            patched.append((owner, attr, orig, attr in owner.__dict__))
            if isinstance(orig, property):
                setattr(owner, attr, property(_probe(orig.fget, label, dev,
                                                     sync_each)))
            else:
                setattr(owner, attr, _probe(orig, label, dev, sync_each))
        yield
    finally:
        for owner, attr, orig, own in reversed(patched):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)


def span_epochs(epoch, window_epochs, dev) -> List[Dict[str, float]]:
    """Epochs under the port's ``obs`` spans (each op's span
    synchronizes) and the binding's probes: for each, its wall time, the
    time of its ``ops.*`` spans and of the ``bind.*`` probes inside
    them."""
    from repro_torch import obs
    k = max(3, math.ceil(SPAN_SECONDS / statistics.median(window_epochs)))
    tel = obs.Telemetry(enabled=True)
    prev = obs.install(tel)
    out = []
    try:
        with probes(dev, sync_each=True):
            for _ in range(k):
                tel.clear()
                a = time.perf_counter()
                H = epoch()
                wall = time.perf_counter() - a
                del H
                spans = tel.tracer.events_in_order()
                ops = sum(dur for name, _, dur, _, _ in spans
                          if name.startswith("ops."))
                nested = sum(dur for name, _, dur, depth, _ in spans
                             if name.startswith("bind.") and depth > 0)
                out.append({"wall_s": wall, "ops_s": ops * 1e-9,
                            "bind_in_ops_s": nested * 1e-9})
    finally:
        obs.install(prev)
    return out


def profile_epochs(epoch, window_epochs, dev: torch.device,
                   workload: str) -> Dict:
    """Epochs under ``torch.profiler`` (the first warms the profiler and
    is left out), each in a ``gnnbench.epoch`` range; the trace goes to
    ``build/gnnbench/<cell>.trace.json`` and is read by ``devtrace``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    k = 1 + max(3, math.ceil(PROFILE_SECONDS
                             / statistics.median(window_epochs)))
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with probes(dev, sync_each=False), profile(activities=acts) as prof:
        for _ in range(k):
            with record_function(devtrace.EPOCH_RANGE):
                H = epoch()
            del H
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{workload}.trace.json"
    prof.export_chrome_trace(str(path))
    return devtrace.summarize(devtrace.load(path))
