"""``DealConfig`` — the port's copy of ``repro.api.config``'s config tree.

The same sections and fields, the same strict ``from_dict`` and exact
JSON round-trip, so a config written for the JAX package (for example
``configs/examples/smoke.json``) loads here unchanged and dumps back to
the same bytes.  ``validate()`` checks names against the port's own
registries (``api.registry``).

The port runs every section: the offline pipeline (graph, model,
partition and executor, the distributed executor and the tuned block
table included), the serving tier (store, qos, refresh), telemetry
(spans, exporters, the scrape endpoint and snapshots) and the
multi-process cluster tier (``cluster.n_shards > 0``), and validates
each as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.api import registry as _reg

# executors of the JAX package that the port does not have yet
_NOT_PORTED = {"pallas": "its kernels are the port's \"cuda\" executor"}
# built-in executors whose kernels take no tuned tiling
_NO_TILING = ("ref", "dist")


class ConfigError(ValueError):
    """Raised by ``DealConfig.validate`` with every bad field listed."""


def _load_builtin_plugins() -> None:
    """Importing the defining modules registers the built-in executors
    (``core.ops``), models (``core.gnn_models``) and store policies
    (``gnnserve.store``)."""
    import repro_torch.core.gnn_models   # noqa: F401
    import repro_torch.core.ops          # noqa: F401
    import repro_torch.gnnserve.store    # noqa: F401


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
    """The 1-D collaborative partition geometry: ``p`` graph partitions
    x ``m`` feature partitions (the dist executor's mesh); the
    single-device executors ignore it."""
    p: int = 2
    m: int = 1


@dataclasses.dataclass
class ExecutorSpec:
    """Backend selection.  ``fused_gather`` is the cuda executor's fused
    gather+spmm switch; ``block_table`` its tuned tiling table
    (``tuning.resolve_block_table``: "default" = the port's
    ``configs/tuned_blocks_torch.json``, or a path).  Left at None,
    either is omitted, so executors that do not take them never see
    them; the built-in "ref" and "dist" take no tiling and refuse a
    table.

    ``fallback_to_ref`` is carried for the JAX package's configs: there
    a trivial (p*m <= 1) "dist" becomes its jnp "ref" executor.  The
    port's "ref" is the plain versions, which the card must not fall
    back to, so a trivial "dist" runs as a one-shard ``DistExecutor``
    (its kernels launch) whatever this field says."""
    name: str = "ref"               # a registered executor
    fallback_to_ref: bool = True    # read by the JAX package only
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fused_gather: Optional[bool] = None
    block_table: Optional[str] = None

    def _options(self) -> Dict[str, Any]:
        opts = dict(self.options)
        if self.fused_gather is not None:
            opts.setdefault("fused_gather", self.fused_gather)
        if self.block_table is not None:
            opts.setdefault("block_table", self.block_table)
        return opts

    def build(self, partition: Optional[PartitionSpec] = None, *,
              n_nodes: Optional[int] = None, device="cuda"):
        """Resolve this spec into an executor instance on ``device``; for
        "dist", the geometry checks and the mesh of ``partition`` on
        ``device`` (``launch.mesh.make_host_mesh``).  Raises
        ``ConfigError`` naming the field and what the port has."""
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
        if self.block_table is not None and self.name in _NO_TILING:
            raise ConfigError(
                f"executor.block_table: the {self.name!r} executor takes "
                "no tiling; a tuned block table needs \"cuda\"")
        factory = _reg.EXECUTORS.get(self.name)
        if self.name != "dist":
            return factory(device=device, **self._options())
        part = partition or PartitionSpec()
        p, m = part.p, part.m
        if n_nodes is not None and n_nodes % p != 0:
            raise ConfigError(
                f"partition.p: {p} must divide the node count {n_nodes}")
        if m & (m - 1) != 0:
            raise ConfigError(
                f"partition.m: {m} must be a power of two "
                "(row-subset pad buckets)")
        from repro_torch.launch.mesh import make_host_mesh
        return factory(device=device, mesh=make_host_mesh(p, m, device),
                       **self.options)


@dataclasses.dataclass
class StoreSpec:
    """The versioned embedding store: sharding, memory budget, and
    incremental node onboarding."""
    n_shards: int = 4
    budget_rows: int = 0            # 0 = unbudgeted; else rows per level
    evict_policy: str = "heat"      # a registered eviction policy
    admission: str = "probation"    # a registered admission policy
    onboarding: str = "none"        # "tail": node adds append a tail
    #                                 partition served via delta refresh


@dataclasses.dataclass
class QoSSpec:
    """The engine's batching geometry plus the optional multi-tenant
    schedule (empty ``tenants`` = one implicit tenant at
    ``staleness_bound``)."""
    staleness_bound: int = 64
    batch_slots: int = 4
    rows_per_step: int = 256
    refresh_charge: float = 1.0
    tenants: Tuple[Dict[str, Any], ...] = ()

    def tenant_registry(self):
        """The runtime ``gnnserve.qos.TenantRegistry`` (None when no
        tenants are declared)."""
        if not self.tenants:
            return None
        from repro_torch.gnnserve.qos import TenantRegistry, TenantSpec
        return TenantRegistry([TenantSpec(**dict(t)) for t in self.tenants])


@dataclasses.dataclass
class RefreshSpec:
    """Delta re-inference knobs: the content-addressed resample seed,
    the dist frontier-size cutover — a refresh layer whose gathered
    universe is below ``dist_local_cutover`` rows runs on a local
    executor instead of the mesh (0 = never cut over; routing decisions
    surface in ``Session.stats()`` and the ``refresh.route`` spans) —
    and ``chunk_rows``: the delta frontier splits into chunks of this
    many rows that the engine interleaves with tenant gathers, one a
    serve step (0 = the whole refresh inline).  Any value serves the
    bits of the inline refresh."""
    sample_seed: int = 0
    dist_local_cutover: int = 0
    chunk_rows: int = 0


@dataclasses.dataclass
class TelemetrySpec:
    """The port's ``obs`` spans and metrics, off by default: the span
    ring buffer's ``capacity`` and ``clock``, the scrape endpoint
    (``http_port`` >= 0; 0 picks a free port) and the periodic JSON
    snapshot (``snapshot_path`` every ``snapshot_every_s``) that
    ``Session.serve()`` starts, and the serving tier's health options."""
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
        return obs.Telemetry(enabled=True, clock=clock,
                             capacity=self.capacity)


@dataclasses.dataclass
class ClusterSpec:
    """Multi-process serving tier: ``n_shards > 0`` makes
    ``Session.serve()`` spawn that many shard-worker processes (each on
    the session's device) behind an RPC router
    (``gnnserve.cluster``)."""
    n_shards: int = 0
    host: str = "127.0.0.1"
    ports: Tuple[int, ...] = ()
    http_port: int = -1
    run_dir: str = ""
    ready_timeout_s: float = 120.0
    hang_timeout_s: float = 60.0
    overrides: Tuple[Dict[str, Any], ...] = ()


_OVERRIDE_FIELDS = ("shard", "budget_rows", "evict_policy", "admission",
                    "staleness_bound", "batch_slots", "rows_per_step")

_TENANT_FIELDS = ("name", "priority", "slot_quota", "rate", "staleness_slo")


def tenants_from_string(text: str) -> Tuple[Dict[str, Any], ...]:
    """The CLI ``--tenants`` format ("name:priority:quota:rate:slo,...")
    as config-tree tenant dicts, through ``gnnserve.qos.parse_tenants``;
    every problem is re-raised as ``ConfigError``."""
    from repro_torch.gnnserve.qos import parse_tenants
    try:
        reg = parse_tenants(text)
    except (ValueError, AssertionError) as exc:
        raise ConfigError(f"qos.tenants: {exc}") from None
    return tuple({"name": t.name, "priority": t.priority,
                  "slot_quota": t.slot_quota, "rate": t.rate,
                  "staleness_slo": t.staleness_slo} for t in reg)


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
        st, q, r = self.store, self.qos, self.refresh

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
        if ex.block_table is not None and not isinstance(
                ex.block_table, str):
            e.append("executor.block_table: must be a str or None, "
                     f"got {ex.block_table!r}")

        if st.n_shards < 1:
            e.append(f"store.n_shards: must be >= 1, got {st.n_shards}")
        if st.budget_rows < 0:
            e.append(f"store.budget_rows: must be >= 0 (0 = unbudgeted), "
                     f"got {st.budget_rows}")
        if st.evict_policy not in _reg.EVICT_POLICIES:
            e.append(f"store.evict_policy: unknown policy "
                     f"{st.evict_policy!r}; registered: "
                     + ", ".join(_reg.EVICT_POLICIES.names()))
        if st.admission not in _reg.ADMISSIONS:
            e.append(f"store.admission: unknown policy {st.admission!r}; "
                     f"registered: {', '.join(_reg.ADMISSIONS.names())}")
        if st.onboarding not in ("none", "tail"):
            e.append(f"store.onboarding: must be \"none\" or \"tail\", "
                     f"got {st.onboarding!r}")

        if q.staleness_bound < 1:
            e.append(f"qos.staleness_bound: must be >= 1, got "
                     f"{q.staleness_bound}")
        if q.batch_slots < 1:
            e.append(f"qos.batch_slots: must be >= 1, got {q.batch_slots}")
        if q.rows_per_step < 1:
            e.append(f"qos.rows_per_step: must be >= 1, got "
                     f"{q.rows_per_step}")
        seen = set()
        _num = (int, float)
        tenant_types = {"name": (str, "str"), "priority": (_num, "number"),
                        "slot_quota": (int, "int"), "rate": (_num, "number"),
                        "staleness_slo": (int, "int")}
        for i, t in enumerate(q.tenants):
            path = f"qos.tenants[{i}]"
            if not isinstance(t, dict):
                e.append(f"{path}: must be a dict with fields "
                         + ", ".join(_TENANT_FIELDS))
                continue
            bad_types = False
            for k, v in t.items():
                if k not in _TENANT_FIELDS:
                    e.append(f"{path}.{k}: unknown tenant field; valid: "
                             + ", ".join(_TENANT_FIELDS))
                elif (not isinstance(v, tenant_types[k][0])
                      or isinstance(v, bool)):
                    e.append(f"{path}.{k}: expected {tenant_types[k][1]},"
                             f" got {type(v).__name__} ({v!r})")
                    bad_types = True
            if bad_types:
                continue            # value checks assume sane types
            name = t.get("name", "")
            if not name:
                e.append(f"{path}.name: required and non-empty")
            elif name in seen:
                e.append(f"{path}.name: duplicate tenant {name!r}")
            seen.add(name)
            if t.get("priority", 1.0) <= 0:
                e.append(f"{path}.priority: must be > 0, got "
                         f"{t.get('priority')}")
            if t.get("slot_quota", 1) < 0:
                e.append(f"{path}.slot_quota: must be >= 0, got "
                         f"{t.get('slot_quota')}")
            if t.get("staleness_slo", 64) < 1:
                e.append(f"{path}.staleness_slo: must be >= 1, got "
                         f"{t.get('staleness_slo')}")
        # (refresh.sample_seed's type is covered by the type pass above)
        if r.dist_local_cutover < 0:
            e.append(f"refresh.dist_local_cutover: must be >= 0 "
                     f"(0 = never cut over), got {r.dist_local_cutover}")
        if r.chunk_rows < 0:
            e.append(f"refresh.chunk_rows: must be >= 0 "
                     f"(0 = inline refresh), got {r.chunk_rows}")
        tel = self.telemetry
        if tel.capacity < 1:
            e.append(f"telemetry.capacity: must be >= 1, got "
                     f"{tel.capacity}")
        if tel.clock not in ("monotonic", "fake"):
            e.append(f"telemetry.clock: must be \"monotonic\" or "
                     f"\"fake\", got {tel.clock!r}")
        if not -1 <= tel.http_port <= 65535:
            e.append(f"telemetry.http_port: must be -1 (off), 0 "
                     f"(ephemeral) or a valid port, got {tel.http_port}")
        if tel.snapshot_every_s <= 0:
            e.append(f"telemetry.snapshot_every_s: must be > 0, got "
                     f"{tel.snapshot_every_s}")
        if tel.health_window < 2:
            e.append(f"telemetry.health_window: must be >= 2, got "
                     f"{tel.health_window}")
        if not 0 < tel.slo_error_budget <= 1:
            e.append(f"telemetry.slo_error_budget: must be in (0, 1], "
                     f"got {tel.slo_error_budget}")
        if tel.burn_threshold <= 0:
            e.append(f"telemetry.burn_threshold: must be > 0, got "
                     f"{tel.burn_threshold}")
        if tel.wait_slo_ms < 0:
            e.append(f"telemetry.wait_slo_ms: must be >= 0 (0 = wait "
                     f"detector off), got {tel.wait_slo_ms}")

        cl = self.cluster
        if cl.n_shards < 0:
            e.append(f"cluster.n_shards: must be >= 0 (0 = single-"
                     f"process serving), got {cl.n_shards}")
        if cl.ports and len(cl.ports) != cl.n_shards:
            e.append(f"cluster.ports: need one port per shard "
                     f"({cl.n_shards}) or none (ephemeral), got "
                     f"{len(cl.ports)}")
        for i, p in enumerate(cl.ports):
            if not (isinstance(p, int) and not isinstance(p, bool)
                    and 1 <= p <= 65535):
                e.append(f"cluster.ports[{i}]: must be a valid port, "
                         f"got {p!r}")
        if not -1 <= cl.http_port <= 65535:
            e.append(f"cluster.http_port: must be -1 (off), 0 "
                     f"(ephemeral) or a valid port, got {cl.http_port}")
        if cl.ready_timeout_s <= 0:
            e.append(f"cluster.ready_timeout_s: must be > 0, got "
                     f"{cl.ready_timeout_s}")
        if cl.hang_timeout_s <= 0:
            e.append(f"cluster.hang_timeout_s: must be > 0, got "
                     f"{cl.hang_timeout_s}")
        for i, ov in enumerate(cl.overrides):
            path = f"cluster.overrides[{i}]"
            if not isinstance(ov, dict):
                e.append(f"{path}: must be a dict with fields "
                         + ", ".join(_OVERRIDE_FIELDS))
                continue
            for k in ov:
                if k not in _OVERRIDE_FIELDS:
                    e.append(f"{path}.{k}: unknown override field; "
                             f"valid: " + ", ".join(_OVERRIDE_FIELDS))
            shard = ov.get("shard")
            if not (isinstance(shard, int) and not isinstance(shard, bool)
                    and 0 <= shard < max(cl.n_shards, 1)):
                e.append(f"{path}.shard: must be a shard index in "
                         f"[0, {cl.n_shards}), got {shard!r}")
            ev = ov.get("evict_policy")
            if ev is not None and ev not in _reg.EVICT_POLICIES:
                e.append(f"{path}.evict_policy: unknown policy {ev!r}; "
                         f"registered: "
                         + ", ".join(_reg.EVICT_POLICIES.names()))
            adm = ov.get("admission")
            if adm is not None and adm not in _reg.ADMISSIONS:
                e.append(f"{path}.admission: unknown policy {adm!r}; "
                         f"registered: "
                         + ", ".join(_reg.ADMISSIONS.names()))
            for k in ("budget_rows",):
                if k in ov and (not isinstance(ov[k], int)
                                or isinstance(ov[k], bool)
                                or ov[k] < 0):
                    e.append(f"{path}.{k}: must be an int >= 0, got "
                             f"{ov[k]!r}")
            for k in ("staleness_bound", "batch_slots", "rows_per_step"):
                if k in ov and (not isinstance(ov[k], int)
                                or isinstance(ov[k], bool)
                                or ov[k] < 1):
                    e.append(f"{path}.{k}: must be an int >= 1, got "
                             f"{ov[k]!r}")
        if cl.n_shards > 0 and ex.name == "dist":
            e.append("cluster.n_shards: the dist executor inside "
                     "cluster workers needs per-process device flags; "
                     "run dist single-process or workers with "
                     "ref/cuda")

        if e:
            raise ConfigError("invalid DealConfig:\n  - "
                              + "\n  - ".join(e))
        return self
