"""``DealConfig`` — the port's copy of ``repro.api.config``'s config tree.

The same sections and fields, the same strict ``from_dict`` and exact
JSON round-trip, so a config written for the JAX package (for example
``configs/examples/smoke.json``) loads here unchanged and dumps back to
the same bytes.  ``validate()`` checks names against the port's own
registries (``api.registry``).

The port runs the offline pipeline (graph, model, executor sections).
The serving sections (store, qos, refresh, cluster) are carried for the
round-trip and type-checked; the slices that port serving validate
their values.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.api import registry as _reg

# executors of the JAX package that the port does not have yet
_NOT_PORTED = {"pallas": "its kernels are the port's \"cuda\" executor",
               "dist": "the distributed executor is not ported yet"}


class ConfigError(ValueError):
    """Raised by ``DealConfig.validate`` with every bad field listed."""


def _load_builtin_plugins() -> None:
    """Importing the defining modules registers the built-in executors
    (``core.ops``) and models (``core.gnn_models``)."""
    import repro_torch.core.gnn_models   # noqa: F401
    import repro_torch.core.ops          # noqa: F401


# ----------------------------------------------------------------------
# the spec tree
# ----------------------------------------------------------------------

@dataclasses.dataclass
class GraphSpec:
    """Stage 1+2: dataset -> distributed CSR -> layer-wise sampling."""
    dataset: str = "ogbn-products"  # named dataset, or "rmat" (explicit)
    scale: float = 1.0              # node-count multiplier
    n_nodes: int = 0                # dataset == "rmat" only
    avg_degree: int = 0             # dataset == "rmat": E = n * avg_degree
    fanout: int = 8                 # fixed fanout of the layer graphs
    seed: int = 0                   # dataset + sampling + features seed
    n_construct_workers: int = 4    # distributed CSR construction width


@dataclasses.dataclass
class ModelSpec:
    """Which registered GNN model, its depth and widths."""
    name: str = "gcn"
    n_layers: int = 3
    d_feature: int = 64
    heads: int = 1                  # attention heads (gat)


@dataclasses.dataclass
class PartitionSpec:
    """The 1-D collaborative partition geometry (``p`` graph x ``m``
    feature partitions); the port's single-card executors ignore it."""
    p: int = 2
    m: int = 1


@dataclasses.dataclass
class ExecutorSpec:
    """Backend selection.  ``fused_gather`` is the cuda executor's fused
    gather+spmm switch; ``block_table`` (a tuned block-size table in the
    JAX package) has no counterpart in the port yet and must stay None."""
    name: str = "ref"               # a registered executor
    fallback_to_ref: bool = True    # dist on a trivial mesh (JAX package)
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fused_gather: Optional[bool] = None
    block_table: Optional[str] = None

    def _options(self) -> Dict[str, Any]:
        opts = dict(self.options)
        if self.fused_gather is not None:
            opts.setdefault("fused_gather", self.fused_gather)
        return opts

    def build(self, partition: Optional[PartitionSpec] = None, *,
              n_nodes: Optional[int] = None, device="cuda"):
        """Resolve this spec into an executor instance on ``device``.
        Raises ``ConfigError`` naming the field and what the port has."""
        _load_builtin_plugins()
        has = ", ".join(_reg.EXECUTORS.names())
        if self.name in _NOT_PORTED and self.name not in _reg.EXECUTORS:
            raise ConfigError(
                f"executor.name: {self.name!r} is not in the port "
                f"({_NOT_PORTED[self.name]}); the port has: {has}")
        if self.name not in _reg.EXECUTORS:
            raise ConfigError(
                f"executor.name: unknown executor {self.name!r}; "
                f"registered: {has}")
        if self.block_table is not None:
            raise ConfigError(
                "executor.block_table: the port has no tuned block table "
                "yet; leave it null (the port has executors: " + has + ")")
        factory = _reg.EXECUTORS.get(self.name)
        return factory(device=device, **self._options())


@dataclasses.dataclass
class StoreSpec:
    """The versioned embedding store (serving; carried, not run)."""
    n_shards: int = 4
    budget_rows: int = 0
    evict_policy: str = "heat"
    admission: str = "probation"
    onboarding: str = "none"


@dataclasses.dataclass
class QoSSpec:
    """Serving batching geometry and tenants (carried, not run)."""
    staleness_bound: int = 64
    batch_slots: int = 4
    rows_per_step: int = 256
    refresh_charge: float = 1.0
    tenants: Tuple[Dict[str, Any], ...] = ()


@dataclasses.dataclass
class RefreshSpec:
    """Delta re-inference knobs (carried, not run)."""
    sample_seed: int = 0
    dist_local_cutover: int = 0
    chunk_rows: int = 0


@dataclasses.dataclass
class TelemetrySpec:
    """The port's ``obs`` spans and counters, off by default.  The
    exporter, endpoint and health fields of the JAX package are carried
    for the round-trip; only ``enabled`` and ``clock`` act here."""
    enabled: bool = False
    capacity: int = 65536
    clock: str = "monotonic"        # "monotonic" | "fake"
    http_port: int = -1
    snapshot_path: str = ""
    snapshot_every_s: float = 1.0
    health_window: int = 128
    slo_error_budget: float = 0.01
    burn_threshold: float = 4.0
    wait_slo_ms: float = 0.0

    def build(self):
        """The runtime ``obs.Telemetry`` (None when disabled)."""
        if not self.enabled:
            return None
        from repro_torch import obs
        clock = obs.FakeClock() if self.clock == "fake" else None
        return obs.Telemetry(enabled=True, clock=clock)


@dataclasses.dataclass
class ClusterSpec:
    """Multi-process serving tier (carried, not run)."""
    n_shards: int = 0
    host: str = "127.0.0.1"
    ports: Tuple[int, ...] = ()
    http_port: int = -1
    run_dir: str = ""
    ready_timeout_s: float = 120.0
    hang_timeout_s: float = 60.0
    overrides: Tuple[Dict[str, Any], ...] = ()


# ----------------------------------------------------------------------
# the root
# ----------------------------------------------------------------------

_SECTIONS = {"graph": GraphSpec, "model": ModelSpec,
             "partition": PartitionSpec, "executor": ExecutorSpec,
             "store": StoreSpec, "qos": QoSSpec, "refresh": RefreshSpec,
             "telemetry": TelemetrySpec, "cluster": ClusterSpec}


@dataclasses.dataclass
class DealConfig:
    graph: GraphSpec = dataclasses.field(default_factory=GraphSpec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    partition: PartitionSpec = dataclasses.field(
        default_factory=PartitionSpec)
    executor: ExecutorSpec = dataclasses.field(
        default_factory=ExecutorSpec)
    store: StoreSpec = dataclasses.field(default_factory=StoreSpec)
    qos: QoSSpec = dataclasses.field(default_factory=QoSSpec)
    refresh: RefreshSpec = dataclasses.field(default_factory=RefreshSpec)
    telemetry: TelemetrySpec = dataclasses.field(
        default_factory=TelemetrySpec)
    cluster: ClusterSpec = dataclasses.field(default_factory=ClusterSpec)

    # -- serialization --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # JSON has no tuples; normalize so to_dict output and a
        # json.loads round-trip are the same object shapes
        d["qos"]["tenants"] = [dict(t) for t in d["qos"]["tenants"]]
        d["cluster"]["ports"] = list(d["cluster"]["ports"])
        d["cluster"]["overrides"] = [dict(o)
                                     for o in d["cluster"]["overrides"]]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DealConfig":
        """Strict: an unknown section or field is an error that names
        it — a typo must not silently fall back to a default."""
        if not isinstance(d, dict):
            raise ConfigError(f"config root must be a dict, got {type(d)}")
        errors: List[str] = []
        kw = {}
        for key, sub in d.items():
            if key not in _SECTIONS:
                errors.append(f"{key}: unknown config section; valid: "
                              + ", ".join(_SECTIONS))
                continue
            if not isinstance(sub, dict):
                errors.append(f"{key}: must be a dict of fields, got "
                              f"{type(sub).__name__}")
                continue
            spec_cls = _SECTIONS[key]
            known = {f.name for f in dataclasses.fields(spec_cls)}
            bad = [f"{key}.{k}: unknown field; valid: " + ", ".join(known)
                   for k in sub if k not in known]
            if bad:
                errors.extend(bad)
                continue
            kw[key] = spec_cls(**sub)
        if errors:
            raise ConfigError("invalid DealConfig:\n  - "
                              + "\n  - ".join(errors))
        cfg = cls(**kw)
        if isinstance(cfg.qos.tenants, (list, tuple)):
            cfg.qos.tenants = tuple(dict(t) if isinstance(t, dict) else t
                                    for t in cfg.qos.tenants)
        if isinstance(cfg.cluster.ports, (list, tuple)):
            cfg.cluster.ports = tuple(cfg.cluster.ports)
        if isinstance(cfg.cluster.overrides, (list, tuple)):
            cfg.cluster.overrides = tuple(
                dict(o) if isinstance(o, dict) else o
                for o in cfg.cluster.overrides)
        return cfg

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "DealConfig":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path) -> "DealConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def dump(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    # -- validation -----------------------------------------------------
    def _type_errors(self) -> List[str]:
        """Per-field type check against each spec's defaults.  bool is
        not an int here; int is an acceptable float."""
        errs = []
        for sec in _SECTIONS:
            spec = getattr(self, sec)
            if not isinstance(spec, _SECTIONS[sec]):
                errs.append(f"{sec}: must be a {_SECTIONS[sec].__name__}")
                continue
            defaults = _SECTIONS[sec]()
            for f in dataclasses.fields(spec):
                v = getattr(spec, f.name)
                d = getattr(defaults, f.name)
                if isinstance(d, bool):
                    ok = isinstance(v, bool)
                elif isinstance(d, int):
                    ok = isinstance(v, int) and not isinstance(v, bool)
                elif isinstance(d, float):
                    ok = (isinstance(v, (int, float))
                          and not isinstance(v, bool))
                elif isinstance(d, str):
                    ok = isinstance(v, str)
                elif isinstance(d, dict):
                    ok = isinstance(v, dict)
                elif isinstance(d, tuple):
                    ok = isinstance(v, (list, tuple))
                else:
                    ok = True
                if not ok:
                    errs.append(f"{sec}.{f.name}: expected "
                                f"{type(d).__name__}, got "
                                f"{type(v).__name__} ({v!r})")
        return errs

    def validate(self) -> "DealConfig":
        """Check every field the port runs; raise one ``ConfigError``
        listing every bad field by dotted path.  Returns self."""
        _load_builtin_plugins()
        from repro_torch.core.graph import dataset_names
        type_errors = self._type_errors()
        if type_errors:
            raise ConfigError("invalid DealConfig:\n  - "
                              + "\n  - ".join(type_errors))
        e: List[str] = []
        g, m, pt, ex = self.graph, self.model, self.partition, self.executor

        known = dataset_names() + ["rmat"]
        if g.dataset not in known:
            e.append(f"graph.dataset: unknown dataset {g.dataset!r}; "
                     f"valid: {', '.join(known)}")
        if g.dataset == "rmat":
            if g.n_nodes <= 0:
                e.append("graph.n_nodes: must be > 0 for dataset \"rmat\"")
            if g.avg_degree <= 0:
                e.append("graph.avg_degree: must be > 0 for dataset "
                         "\"rmat\"")
        if g.scale <= 0:
            e.append(f"graph.scale: must be > 0, got {g.scale}")
        if g.fanout < 1:
            e.append(f"graph.fanout: must be >= 1, got {g.fanout}")
        if g.n_construct_workers < 1:
            e.append("graph.n_construct_workers: must be >= 1, got "
                     f"{g.n_construct_workers}")

        if m.name not in _reg.MODELS:
            e.append(f"model.name: unknown model {m.name!r}; registered: "
                     + ", ".join(_reg.MODELS.names()))
        if m.n_layers < 1:
            e.append(f"model.n_layers: must be >= 1, got {m.n_layers}")
        if m.d_feature < 1:
            e.append(f"model.d_feature: must be >= 1, got {m.d_feature}")
        if m.heads < 1:
            e.append(f"model.heads: must be >= 1, got {m.heads}")
        elif m.d_feature % m.heads != 0:
            e.append(f"model.heads: {m.heads} must divide d_feature "
                     f"{m.d_feature}")

        if pt.p < 1:
            e.append(f"partition.p: must be >= 1, got {pt.p}")
        if pt.m < 1:
            e.append(f"partition.m: must be >= 1, got {pt.m}")

        if ex.name not in _reg.EXECUTORS:
            why = _NOT_PORTED.get(ex.name)
            e.append(f"executor.name: " + (
                f"{ex.name!r} is not in the port ({why})" if why else
                f"unknown executor {ex.name!r}")
                + f"; registered: {', '.join(_reg.EXECUTORS.names())}")
        if ex.fused_gather is not None and not isinstance(
                ex.fused_gather, bool):
            e.append("executor.fused_gather: must be a bool or None, "
                     f"got {ex.fused_gather!r}")
        if ex.block_table is not None:
            e.append("executor.block_table: the port has no tuned block "
                     f"table yet; must be null, got {ex.block_table!r}")

        tel = self.telemetry
        if tel.clock not in ("monotonic", "fake"):
            e.append(f"telemetry.clock: must be \"monotonic\" or "
                     f"\"fake\", got {tel.clock!r}")

        if e:
            raise ConfigError("invalid DealConfig:\n  - "
                              + "\n  - ".join(e))
        return self
