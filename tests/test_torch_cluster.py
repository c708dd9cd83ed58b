"""The port's cluster serving tier (``repro_torch.gnnserve.cluster``):
the mirror of ``tests/test_cluster.py`` (protocol framing, the
in-process WorkerCore WAL/seq contract, the router's failure contract,
and a live 2-shard deployment whose lookups are BITWISE the
single-process ``Session``'s on the same ``DealConfig``, including after
kill/restart/WAL replay of one shard; merged stats and attribution,
heartbeat wedge detection, the aggregated ``/healthz``), plus the
cross-package checks: the port's frames byte for byte the JAX package's,
its ``merge_*`` functions equal to JAX's on the same per-shard trees,
and a port ``WorkerCore`` against a JAX ``WorkerCore`` through the same
commits (the same params, atol 1e-4, rtol 3e-3).

Everything runs on the CPU: the sessions and their workers take
``device="cpu"`` (the kernels' plain versions).  The deployment tests
share module-scoped fixtures (worker processes cost seconds to spawn)
and run in FILE ORDER: tests that mutate the worlds mirror the mutation
on BOTH the single-process and cluster sessions, so the equal-worlds
invariant holds for every later test.  Every fixture closes its
sessions, and ``test_no_worker_outlives_its_deployment`` checks that
their processes are gone.
"""
import json
import os
import socket
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.gnnserve.cluster import protocol as jprotocol  # noqa: E402
from repro.gnnserve.cluster import router as jrouter  # noqa: E402
from repro_torch.api import (ClusterSpec, DealConfig, ExecutorSpec,  # noqa
                             GraphSpec, ModelSpec, QoSSpec, Session,
                             TelemetrySpec, tenants_from_string)
from repro_torch.gnnserve.cluster import (ProtocolError,  # noqa: E402
                                          WorkerCore, merge_health,
                                          recv_msg, send_msg)
from repro_torch.gnnserve.engine import Query  # noqa: E402

N = 192
D = 16
WAIT_S = 30           # every join and wait here gives up after this


def _cfg_dict(*, executor="ref", n=N):
    return {
        "graph": {"dataset": "rmat", "n_nodes": n, "avg_degree": 4,
                  "fanout": 4, "seed": 3},
        "model": {"name": "sage", "n_layers": 2, "d_feature": D},
        "executor": {"name": executor},
        "store": {"onboarding": "tail"},
        "qos": {"staleness_bound": 4},
    }


def _qos_cfg(run_dir, *, n_shards=2, http_port=0):
    return DealConfig(
        graph=GraphSpec(dataset="rmat", n_nodes=N, avg_degree=4,
                        fanout=4, seed=3),
        model=ModelSpec(name="sage", n_layers=2, d_feature=D),
        executor=ExecutorSpec(name="ref"),
        qos=QoSSpec(staleness_bound=8, batch_slots=4, rows_per_step=64,
                    tenants=tenants_from_string(
                        "ui:4:2:0:4,batch:1:1:0:64")),
        telemetry=TelemetrySpec(enabled=True),
        cluster=ClusterSpec(n_shards=n_shards, http_port=http_port,
                            run_dir=run_dir))


def _workload(eng, *, n=N, ticks=5, rows=12, seed=11):
    """Deterministic mixed traffic (edge adds + feature updates +
    queries) — identical on any engine built from the same config."""
    outs = []
    r = np.random.default_rng(seed)
    for t in range(ticks):
        log = eng.mutate()
        for _ in range(3):
            a, b = r.integers(0, n, 2)
            log.add_edge(int(a), int(b))
        ids = np.unique(r.integers(0, n, 4).astype(np.int64))
        log.update_features(
            ids, r.standard_normal((ids.size, D)).astype(np.float32))
        q = Query(1000 + t, r.integers(0, n, rows).astype(np.int64))
        eng.submit(q)
        eng.run()
        outs.append((q.out.copy(), q.served_version))
    return outs


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie (exited, not yet reaped) is not a running worker
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(")")[-1].split()[0] != "Z"


def _wait_dead(pids):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if not any(_alive(p) for p in pids):
            return True
        time.sleep(0.1)
    return False


_SEEN_PIDS = []       # every worker pid a fixture or test saw


def _record_pids(session):
    _SEEN_PIDS.extend(st["pid"] for st in session.cluster.router.statuses())


# ----------------------------------------------------------------------
# protocol framing (no processes)
# ----------------------------------------------------------------------

def test_protocol_roundtrip_is_bit_exact():
    a, b = socket.socketpair()
    try:
        arrays = {
            "rows": np.random.default_rng(0).standard_normal(
                (7, 5)).astype(np.float32),
            "ids": np.arange(9, dtype=np.int64)[::3].copy(),
        }
        send_msg(a, {"op": "lookup", "level": -1, "ok": True}, arrays)
        header, got = recv_msg(b)
        assert header == {"op": "lookup", "level": -1, "ok": True}
        assert set(got) == {"rows", "ids"}
        for k in got:
            assert got[k].dtype == arrays[k].dtype
            assert np.array_equal(got[k], arrays[k])
        # empty-array legs survive too
        send_msg(b, {"op": "x"}, {"e": np.empty((0, 3), np.float32)})
        _, got = recv_msg(a)
        assert got["e"].shape == (0, 3)
    finally:
        a.close()
        b.close()


def test_protocol_rejects_eof_and_torn_frames():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(ProtocolError, match="closed"):
        recv_msg(b)
    b.close()
    a, b = socket.socketpair()
    try:
        # a frame whose header claims to be longer than the frame
        head = json.dumps({"op": "x"}).encode()
        body = struct.pack("<I", len(head) + 999) + head
        a.sendall(struct.pack("<I", len(body)) + body)
        with pytest.raises(ProtocolError, match="header length"):
            recv_msg(b)
    finally:
        a.close()
        b.close()


def test_protocol_frame_cap_rejects_allocation_bomb():
    # the cap must stay small enough that a corrupt length prefix can
    # never trigger a multi-GiB allocation in _recv_exact
    from repro_torch.gnnserve.cluster.protocol import MAX_FRAME
    assert MAX_FRAME <= 1 << 28
    assert MAX_FRAME == jprotocol.MAX_FRAME
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<I", MAX_FRAME + 1))
        with pytest.raises(ProtocolError, match="exceeds cap"):
            recv_msg(b)
    finally:
        a.close()
        b.close()


def test_float_wire_helpers_roundtrip_exactly():
    from repro_torch.gnnserve.cluster.worker import (_rows_from_wire,
                                                     _rows_to_wire)
    rows = np.random.default_rng(3).standard_normal(
        (11, 6)).astype(np.float32)
    wire = json.loads(json.dumps(_rows_to_wire(rows)))
    back = _rows_from_wire(wire)
    assert back.dtype == np.float32
    assert np.array_equal(back, rows)


def _frame(send, header, arrays):
    a, b = socket.socketpair()
    try:
        send(a, header, arrays)
        a.close()
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        b.close()


def test_frames_are_byte_identical_to_the_jax_packages():
    r = np.random.default_rng(1)
    header = {"op": "commit", "seq": 3, "edge_ops": [["add", 1, 2]],
              "stats": {"x": 1.5, "names": ["a", "b"]}}
    arrays = {"feat_ids": np.arange(4, dtype=np.int64),
              "feat_rows": r.standard_normal((4, D)).astype(np.float32),
              "mask": r.random((3, 2)) > 0.5,
              "empty": np.empty((0, 7), np.float32),
              "strided": np.arange(20, dtype=np.int32).reshape(4, 5)[:, 1]}
    ours = _frame(send_msg, header, arrays)
    theirs = _frame(jprotocol.send_msg, header, arrays)
    assert ours == theirs
    assert _frame(send_msg, {"op": "status"}, None) == \
        _frame(jprotocol.send_msg, {"op": "status"}, None)


@pytest.mark.parametrize("sender,receiver", [
    ("repro_torch", "repro"), ("repro", "repro_torch")])
def test_each_package_reads_the_others_frames(sender, receiver):
    pkgs = {"repro_torch": (send_msg, recv_msg),
            "repro": (jprotocol.send_msg, jprotocol.recv_msg)}
    send, recv = pkgs[sender][0], pkgs[receiver][1]
    arrays = {"rows": np.random.default_rng(2).standard_normal(
        (5, 3)).astype(np.float32), "ids": np.arange(5, dtype=np.int64)}
    a, b = socket.socketpair()
    try:
        send(a, {"op": "lookup", "uid": 9}, arrays)
        header, got = recv(b)
    finally:
        a.close()
        b.close()
    assert header == {"op": "lookup", "uid": 9}
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v)


# ----------------------------------------------------------------------
# WorkerCore in-process: seq chain, WAL replay, config neutralization
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def core_cfg():
    return DealConfig.from_dict({**_cfg_dict(n=128)})


def _core(cfg, shard, n_shards, run_dir):
    return WorkerCore(cfg, shard, n_shards, str(run_dir), device="cpu")


def _commit_header(seq, edge_ops):
    return {"op": "commit", "seq": seq, "edge_ops": edge_ops,
            "n_new_nodes": 0}


def test_worker_core_seq_chain(core_cfg, tmp_path):
    core = _core(core_cfg, 0, 1, tmp_path)
    resp, _ = core.dispatch(_commit_header(1, [["add", 1, 2]]), {})
    assert resp["seq"] == 1 and not resp.get("duplicate")
    v1 = resp["store_version"]
    # duplicate seq acks idempotently, without re-applying
    resp, _ = core.dispatch(_commit_header(1, [["add", 1, 2]]), {})
    assert resp["duplicate"] and resp["store_version"] == v1
    # a gap breaks the monotonic chain loudly
    with pytest.raises(ValueError, match="monotonic"):
        core.dispatch(_commit_header(5, []), {})
    assert core.last_seq == 1


def test_worker_core_wal_replay_is_bitwise(core_cfg, tmp_path):
    run_dir = str(tmp_path)
    core = _core(core_cfg, 0, 1, run_dir)
    core.dispatch(_commit_header(1, [["add", 3, 4], ["add", 5, 6]]), {})
    core.dispatch(_commit_header(2, [["del", 3, 4]]), {})
    want, _ = core.dispatch({"op": "digest"}, {})
    # checkpoint restore path: ckpt has committed_seq == 2, empty replay
    restored = _core(core_cfg, 0, 1, run_dir)
    assert restored.restored and restored.last_seq == 2
    assert restored.replayed == 0
    got, _ = restored.dispatch({"op": "digest"}, {})
    assert got["digests"] == want["digests"]
    # full WAL replay path: no checkpoint, every entry replays
    os.unlink(core.ckpt_path)
    replayed = _core(core_cfg, 0, 1, run_dir)
    assert not replayed.restored and replayed.replayed == 2
    assert replayed.last_seq == 2
    got, _ = replayed.dispatch({"op": "digest"}, {})
    assert got["digests"] == want["digests"]
    assert got["store_version"] == want["store_version"]


def test_worker_rolls_back_wal_and_world_when_apply_fails(
        core_cfg, tmp_path, monkeypatch):
    (tmp_path / "w").mkdir()
    core = _core(core_cfg, 0, 1, tmp_path / "w")
    core.dispatch(_commit_header(1, [["add", 1, 2]]), {})
    boom = {"on": True}
    real = WorkerCore._apply_commit

    def flaky(self, entry):
        if boom["on"]:
            raise RuntimeError("injected apply failure")
        return real(self, entry)

    monkeypatch.setattr(WorkerCore, "_apply_commit", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        core.dispatch(_commit_header(2, [["add", 5, 6]]), {})
    # the torn seq-2 entry is truncated back out and the chain intact:
    # a restart must not replay it, a retry must not duplicate it
    assert core.last_seq == 1
    with open(core.wal_path) as f:
        lines = [l for l in f if l.strip()]
    assert len(lines) == 1 and json.loads(lines[0])["seq"] == 1
    boom["on"] = False
    resp, _ = core.dispatch(_commit_header(2, [["add", 5, 6]]), {})
    assert resp["seq"] == 2 and not resp["duplicate"]
    # ... and the recovered world is bitwise-equal to a never-failed one
    (tmp_path / "ctrl").mkdir()
    ctrl = _core(core_cfg, 0, 1, tmp_path / "ctrl")
    ctrl.dispatch(_commit_header(1, [["add", 1, 2]]), {})
    ctrl.dispatch(_commit_header(2, [["add", 5, 6]]), {})
    assert core.dispatch({"op": "digest"}, {})[0]["digests"] == \
        ctrl.dispatch({"op": "digest"}, {})[0]["digests"]


def test_replay_rejects_duplicate_and_gapped_wal(core_cfg, tmp_path):
    entry = {"seq": 1, "kind": "commit", "edge_ops": [["add", 1, 2]],
             "feat_ids": [], "feat_rows": [], "n_new_nodes": 0,
             "new_node_rows": None}
    dup = tmp_path / "dup"
    dup.mkdir()
    (dup / "shard0.wal").write_text(
        json.dumps(entry) + "\n" + json.dumps(entry) + "\n")
    with pytest.raises(ValueError, match="duplicate|out-of-order"):
        _core(core_cfg, 0, 1, dup)
    gap = tmp_path / "gap"
    gap.mkdir()
    (gap / "shard0.wal").write_text(
        json.dumps(entry) + "\n" + json.dumps({**entry, "seq": 3})
        + "\n")
    with pytest.raises(ValueError, match="gap"):
        _core(core_cfg, 0, 1, gap)


def test_worker_config_overrides_and_neutralization(tmp_path):
    cfg = DealConfig.from_dict({
        **_cfg_dict(n=128),
        "telemetry": {"enabled": False, "http_port": 9999},
        "cluster": {"n_shards": 2,
                    "overrides": [{"shard": 1, "budget_rows": 64,
                                   "staleness_bound": 2}]},
    })
    core = _core(cfg, 1, 2, tmp_path)
    assert core.cfg.cluster.n_shards == 0      # no recursive clusters
    assert core.cfg.telemetry.http_port == -1  # router owns the door
    assert core.cfg.store.budget_rows == 64
    assert core.cfg.qos.staleness_bound == 2
    (tmp_path / "s0").mkdir()
    other = _core(cfg, 0, 2, tmp_path / "s0")
    assert other.cfg.store.budget_rows == 0    # override is shard-1 only


def test_worker_status_carries_the_ports_diagnostics(core_cfg, tmp_path):
    """The port-only ``status`` keys: this process's kernel launches
    (zero on the CPU: the plain versions run), the load and commit
    timings, and the peak memory."""
    from repro_torch.kernels import ops as kops
    core = _core(core_cfg, 0, 1, tmp_path)
    core.dispatch(_commit_header(1, [["add", 1, 2]]), {})
    st, _ = core.dispatch({"op": "status"}, {})
    assert set(st["kernel_launches"]) == set(kops.KERNELS)
    assert all(v == 0 for v in st["kernel_launches"].values())
    t = st["timings"]
    for k in ("build_s", "epoch_s", "replay_s", "commit_wal_s",
              "commit_apply_s", "commit_checkpoint_s"):
        assert t[k] >= 0.0, k
    assert st["memory"]["host_peak_rss_bytes"] > 0
    assert st["memory"]["device_peak_bytes"] == 0
    restored = _core(core_cfg, 0, 1, tmp_path)
    assert "restore_s" in restored.timings
    assert "epoch_s" not in restored.timings


# ----------------------------------------------------------------------
# one commit stream through a port WorkerCore and a JAX WorkerCore
# ----------------------------------------------------------------------

def test_worker_core_matches_the_jax_worker_core(core_cfg, tmp_path,
                                                 monkeypatch):
    """The same commits through a JAX ``WorkerCore`` and a port one whose
    ``Session.build`` takes the JAX world's params (``params_from_numpy``):
    every level of both stores within atol 1e-4, rtol 3e-3, at equal
    versions and seqs, after edge adds and removes, feature updates and
    node adds."""
    from repro.api.config import DealConfig as JDealConfig
    from repro.gnnserve.cluster import WorkerCore as JWorkerCore
    from repro_torch.api import session as tsession
    from repro_torch.core.gnn_models import params_from_numpy
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jcore = JWorkerCore(JDealConfig.from_dict(_cfg_dict(n=128)), 0, 1,
                        str(tmp_path / "jax"))
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if hasattr(x, "shape") else x,
        jcore.session.params)
    build = tsession.Session.build.__func__

    def with_jax_params(cls, cfg, device="cuda", params=None):
        return build(cls, cfg, device=device,
                     params=params_from_numpy("sage", jp, device))

    monkeypatch.setattr(tsession.Session, "build",
                        classmethod(with_jax_params))
    core = _core(core_cfg, 0, 1, tmp_path / "port")
    r = np.random.default_rng(7)
    commits = []
    for seq in (1, 2, 3):
        ids = np.unique(r.integers(0, 128, 3)).astype(np.int64)
        header = {"op": "commit", "seq": seq, "n_new_nodes": 2 * (seq == 2),
                  "edge_ops": [["add", int(a), int(b)] for a, b in
                               r.integers(0, 128, (4, 2))]
                  + ([["del", 3, 4]] if seq == 3 else [])}
        arrays = {"feat_ids": ids,
                  "feat_rows": r.standard_normal(
                      (ids.size, D)).astype(np.float32)}
        if seq == 2:
            arrays["new_node_rows"] = r.standard_normal(
                (2, D)).astype(np.float32)
        commits.append((header, arrays))
    for header, arrays in commits:
        got, _ = core.dispatch(dict(header), dict(arrays))
        want, _ = jcore.dispatch(dict(header), dict(arrays))
        assert (got["seq"], got["store_version"], got["n_nodes"]) == \
            (want["seq"], want["store_version"], want["n_nodes"])
    n = core.engine.store.n_nodes
    assert n == jcore.engine.store.n_nodes == 130
    ids = np.arange(n, dtype=np.int64)
    for level in range(core.engine.store.n_levels):
        got = core.engine.store.lookup(ids, level)
        want = jcore.engine.store.lookup(ids, level)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=3e-3)
    # the same query through both dispatchers
    q = {"op": "lookup", "uid": 5, "level": -1}
    got, garr = core.dispatch(q, {"ids": ids[::7]})
    want, warr = jcore.dispatch(q, {"ids": ids[::7]})
    assert got["served_version"] == want["served_version"]
    np.testing.assert_allclose(garr["rows"], warr["rows"], atol=1e-4,
                               rtol=3e-3)


# ----------------------------------------------------------------------
# router failure semantics over in-process cores (no sockets)
# ----------------------------------------------------------------------

class _CoreChannel:
    """In-process stand-in for ``protocol.Channel`` over a WorkerCore:
    the same request/close surface and error taxonomy (WorkerError for
    handler failures), plus fault injection — ops named in ``fail_ops``
    raise OSError BEFORE reaching the core, modelling a transport
    failure where the shard never saw the RPC."""

    def __init__(self, core):
        self.core = core
        self.fail_ops = set()
        self._lock = threading.Lock()

    def request(self, op, arrays=None, **fields):
        from repro_torch.gnnserve.cluster import WorkerError
        with self._lock:
            if op in self.fail_ops:
                raise OSError(f"injected transport failure on {op!r}")
            try:
                return self.core.dispatch({"op": op, **fields},
                                          dict(arrays or {}))
            except Exception as exc:
                raise WorkerError(
                    f"shard op {op!r} failed: {exc}") from exc

    def close(self):
        pass


@pytest.fixture()
def core_router(core_cfg, tmp_path):
    from repro_torch.gnnserve.cluster import Router
    cores, channels = [], []
    for s in range(2):
        d = tmp_path / f"shard{s}"
        d.mkdir()
        core = _core(core_cfg, s, 2, d)
        cores.append(core)
        channels.append(_CoreChannel(core))
    st, _ = cores[0].dispatch({"op": "status"}, {})
    bounds = np.linspace(0, st["n_nodes"], 3).astype(np.int64)
    router = Router(channels, bounds, st["dims"])
    yield router, cores, channels
    router._pool.shutdown(wait=True)


def _core_digests(cores):
    return [c.dispatch({"op": "digest"}, {})[0]["digests"]
            for c in cores]


def test_commit_requeues_when_durable_nowhere(core_router):
    router, cores, channels = core_router
    for ch in channels:
        ch.fail_ops.add("commit")
    router.log.add_edge(1, 2)
    with pytest.raises(RuntimeError, match="requeued"):
        router.commit_pending()
    # nothing applied anywhere, the batch is back in the log, and no
    # shard's seq moved — the next commit re-drains under fresh seqs
    assert router.log.pending == 1
    assert router.seq == [0, 0]
    assert all(c.last_seq == 0 for c in cores)
    for ch in channels:
        ch.fail_ops.clear()
    router.commit_pending()
    assert router.seq == [1, 1]
    assert router.log.pending == 0
    d0, d1 = _core_digests(cores)
    assert d0 == d1


def test_commit_partial_failure_parks_inflight_no_seq_reuse(
        core_router, core_cfg, tmp_path):
    router, cores, channels = core_router
    channels[1].fail_ops.add("commit")
    router.log.add_edge(3, 4)
    with pytest.raises(RuntimeError, match="in-flight"):
        router.commit_pending()
    # shard 0 folded the batch; it must NOT requeue (that would double-
    # apply on shard 0 under a reused seq) — it parks in-flight instead
    assert router.seq == [1, 0]
    assert router.log.pending == 0
    assert router.router_stats()["inflight"] == "commit"
    # a new mutation arrives while the commit is parked
    router.log.add_edge(5, 6)
    channels[1].fail_ops.clear()
    router.commit_pending()     # drives the parked batch, then drains
    assert router.seq == [2, 2]
    assert router.router_stats()["inflight"] is None
    d0, d1 = _core_digests(cores)
    assert d0 == d1
    # no double-apply anywhere: equal to a control fed each batch once
    (tmp_path / "ctrl").mkdir()
    ctrl = _core(core_cfg, 0, 1, tmp_path / "ctrl")
    ctrl.dispatch(_commit_header(1, [["add", 3, 4]]), {})
    ctrl.dispatch(_commit_header(2, [["add", 5, 6]]), {})
    assert ctrl.dispatch({"op": "digest"}, {})[0]["digests"] == d0


def test_commit_resyncs_seq_when_only_the_ack_is_lost(core_router):
    """An applied-but-unacked commit must advance the router's seq via
    the status resync — NOT be re-sent as a new batch (the duplicate
    ack path) or requeued (double-apply)."""
    from repro_torch.gnnserve.cluster import WorkerError
    router, cores, channels = core_router
    real = channels[1].request

    def drop_ack(op, arrays=None, **fields):
        resp = real(op, arrays, **fields)
        if op == "commit":
            raise WorkerError("injected ack loss after apply")
        return resp

    channels[1].request = drop_ack
    router.log.add_edge(7, 8)
    router.commit_pending()     # resync sees last_seq==target: no error
    channels[1].request = real
    assert router.seq == [1, 1]
    assert all(c.last_seq == 1 for c in cores)
    assert router.log.pending == 0
    d0, d1 = _core_digests(cores)
    assert d0 == d1


def test_concurrent_lookups_and_scrapes_never_tear_a_commit(
        core_router):
    router, cores, _ = core_router
    errs = []
    stop = threading.Event()

    def _reader(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                rows, _ = router.lookup(
                    r.integers(0, 128, 8).astype(np.int64))
                assert rows.shape == (8, D)
                router.engine_stats()   # merged scrape mid-commit
            except Exception as exc:    # noqa: BLE001 — recorded
                errs.append(exc)
                return

    threads = [threading.Thread(target=_reader, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    for i in range(6):
        router.log.add_edge(int(i), int((i * 7 + 1) % 128))
        router.commit_pending()
    stop.set()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errs, f"reader raced a commit: {errs[0]}"
    d0, d1 = _core_digests(cores)
    assert d0 == d1


def test_lookup_empty_ids_returns_empty_rows(core_router):
    router, _, _ = core_router
    rows, version = router.lookup(np.empty(0, np.int64))
    assert rows.shape == (0, D)
    assert rows.dtype == np.float32
    assert version == router.statuses()[0]["store_version"]


# ----------------------------------------------------------------------
# the live 2-shard deployment vs the single-process Session
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def fifo_pair(tmp_path_factory):
    base = _cfg_dict()
    s1 = Session.build(DealConfig.from_dict(base), device="cpu")
    s2 = Session.build(DealConfig.from_dict(
        {**base, "cluster": {"n_shards": 2, "run_dir": str(
            tmp_path_factory.mktemp("fifo"))}}), device="cpu")
    try:
        e1 = s1.serve()
        e2 = s2.serve()
        _record_pids(s2)
        o1 = _workload(e1)
        o2 = _workload(e2)
        yield s1, e1, o1, s2, e2, o2
    finally:
        if s2.cluster is not None:
            _record_pids(s2)
        s1.close()
        s2.close()


def test_cluster_serves_bitwise_equal_to_single_process(fifo_pair):
    _, _, o1, _, _, o2 = fifo_pair
    for i, ((rows1, v1), (rows2, v2)) in enumerate(zip(o1, o2)):
        assert v1 == v2, f"tick {i}: served versions diverge"
        assert np.array_equal(rows1, rows2), f"tick {i}: bytes diverge"


def test_shards_hold_identical_worlds(fifo_pair):
    *_, s2, _, _ = fifo_pair
    digs = s2.cluster.router.digests()
    assert digs[0]["digests"] == digs[1]["digests"]
    assert digs[0]["store_version"] == digs[1]["store_version"]
    sts = s2.cluster.router.statuses()
    assert [st["shard"] for st in sts] == [0, 1]
    assert all(st["pending"] == 0 for st in sts)


def test_merged_stats_keep_session_schema(fifo_pair):
    s1, _, o1, s2, _, _ = fifo_pair
    st1, st2 = s1.stats(), s2.stats()
    # the cluster tree is a superset of the single-process one
    missing = set(st1) - set(st2)
    assert not missing, f"merged stats dropped keys: {sorted(missing)}"
    assert st2["store_version"] == st1["store_version"]
    assert st2["n_served"] == len(o1)          # client queries, not RPCs
    assert st2["n_served_subqueries"] >= st2["n_served"]
    assert st2["pending_mutations"] == 0
    cl = st2["cluster"]
    assert cl["n_shards"] == 2 and len(cl["shards"]) == 2
    assert cl["router"]["n_lookups"] == len(o1)
    assert cl["router"]["seq"] == [5, 5]       # one commit per tick


def test_full_epoch_matches_single_process(fifo_pair):
    _, e1, _, s2, e2, _ = fifo_pair
    e1.full_epoch()
    e2.full_epoch()
    digs = s2.cluster.router.digests()
    assert digs[0]["digests"] == digs[1]["digests"]
    r = np.random.default_rng(23)
    ids = r.integers(0, N, 16).astype(np.int64)
    q1, q2 = Query(2000, ids), Query(2000, ids.copy())
    e1.submit(q1), e2.submit(q2)
    e1.run(), e2.run()
    assert q1.served_version == q2.served_version
    assert np.array_equal(q1.out, q2.out)


def test_killed_shard_rejoins_bitwise_after_replay(fifo_pair):
    _, e1, _, s2, e2, _ = fifo_pair
    dep = s2.cluster
    dep.kill_worker(1)
    dep.restart_worker(1)
    _record_pids(s2)
    digs = dep.router.digests()
    assert digs[0]["digests"] == digs[1]["digests"], \
        "restarted shard is not bitwise-equal after checkpoint+replay"
    sts = dep.router.statuses()
    assert sts[1]["restored"]                   # came back via checkpoint
    ids = np.arange(60, 120, dtype=np.int64)    # spans both shards
    q1, q2 = Query(3000, ids), Query(3000, ids.copy())
    e1.submit(q1), e2.submit(q2)
    e1.run(), e2.run()
    assert np.array_equal(q1.out, q2.out)
    assert dep.n_restarts >= 1


def test_router_retries_transparently_through_a_dead_worker(fifo_pair):
    _, e1, _, s2, e2, _ = fifo_pair
    dep = s2.cluster
    before = dep.router.n_retries
    dep.kill_worker(0)                          # kill, do NOT restart
    ids = np.arange(0, 50, dtype=np.int64)      # owned by shard 0
    q1, q2 = Query(4000, ids), Query(4000, ids.copy())
    e1.submit(q1), e2.submit(q2)
    e1.run(), e2.run()                          # reconnect hook respawns
    assert np.array_equal(q1.out, q2.out)
    assert dep.router.n_retries > before
    _record_pids(s2)


def test_wedged_worker_killed_with_stage_named_diagnosis(fifo_pair):
    *_, s2, _, _ = fifo_pair
    dep = s2.cluster
    hbs = dep.check_heartbeats()
    assert all(h["alive"] and h["age_s"] < 5.0 for h in hbs)

    def _hang():
        try:
            dep.router.channels[1].request("_test_hang", seconds=60)
        except Exception:
            pass                                # killed mid-request

    t = threading.Thread(target=_hang, daemon=True)
    t.start()
    deadline = time.time() + 15.0
    while time.time() < deadline:
        hbs = dep.check_heartbeats()
        if hbs[1]["stage"] == "op:_test_hang" and hbs[1]["age_s"] > 1.0:
            break
        time.sleep(0.2)
    diags = dep.kill_wedged(max_age_s=1.0, restart=True)
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert len(diags) == 1
    assert "shard 1" in diags[0] and "op:_test_hang" in diags[0]
    _record_pids(s2)
    digs = dep.router.digests()                 # rejoined bitwise again
    assert digs[0]["digests"] == digs[1]["digests"]


def test_node_adds_route_and_onboard_identically(fifo_pair):
    _, e1, _, s2, e2, _ = fifo_pair
    n0 = e2.store.n_nodes
    for eng in (e1, e2):
        r = np.random.default_rng(31)
        log = eng.mutate()
        log.add_nodes(3, r.standard_normal((3, D)).astype(np.float32))
        log.add_edge(int(n0), 5)
        log.add_edge(7, int(n0 + 2))
        eng.refresh()
    assert e1.store.n_nodes == e2.store.n_nodes == n0 + 3
    ids = np.arange(n0 - 2, n0 + 3, dtype=np.int64)   # tail straddle
    q1, q2 = Query(5000, ids), Query(5000, ids.copy())
    e1.submit(q1), e2.submit(q2)
    e1.run(), e2.run()
    assert np.array_equal(q1.out, q2.out)
    digs = s2.cluster.router.digests()
    assert digs[0]["digests"] == digs[1]["digests"]


@pytest.mark.parametrize("executor", ["cuda"])
def test_cluster_bitwise_on_accelerated_executor(executor, tmp_path):
    """The kernels' executor (on the CPU: its wrappers' plain versions)
    in the workers and in the single-process session."""
    base = _cfg_dict(executor=executor, n=128)
    with Session.build(DealConfig.from_dict(base), device="cpu") as s1, \
            Session.build(DealConfig.from_dict(
                {**base, "cluster": {"n_shards": 2,
                                     "run_dir": str(tmp_path)}}),
                device="cpu") as s2:
        o1 = _workload(s1.serve(), n=128, ticks=3)
        o2 = _workload(s2.serve(), n=128, ticks=3)
        _record_pids(s2)
        for (rows1, v1), (rows2, v2) in zip(o1, o2):
            assert v1 == v2
            assert np.array_equal(rows1, rows2)
        s2.cluster.kill_worker(0)
        s2.cluster.restart_worker(0)
        _record_pids(s2)
        digs = s2.cluster.router.digests()
        assert digs[0]["digests"] == digs[1]["digests"]


# ----------------------------------------------------------------------
# QoS + telemetry cluster: merged attribution, aggregated /healthz
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def qos_cluster(tmp_path_factory):
    s = Session.build(_qos_cfg(str(tmp_path_factory.mktemp("qos"))),
                      device="cpu")
    try:
        eng = s.serve()
        _record_pids(s)
        r = np.random.default_rng(5)
        for t in range(12):
            for tenant, rows in (("ui", 4), ("batch", 24)):
                ids = r.integers(0, N, rows).astype(np.int64)
                eng.submit(Query(100 * t + rows, ids, tenant=tenant))
            log = eng.mutate()
            log.add_edge(int(r.integers(0, N)), int(r.integers(0, N)))
            eng.run()
        yield s, eng
    finally:
        s.close()


def test_cluster_attribution_reconciles_within_gate(qos_cluster):
    from repro_torch.obs.report import ATTRIBUTION_TOLERANCE
    s, _ = qos_cluster
    st = s.stats()
    attribution = st.get("attribution", {})
    assert set(attribution) == {"ui", "batch"}
    for tenant, doc in attribution.items():
        assert doc["n_queries"] > 0
        frac = doc["attributed_frac"]
        assert abs(frac - 1.0) <= ATTRIBUTION_TOLERANCE, \
            f"tenant {tenant}: merged attribution closes at {frac:.3f}"
    tenants = st["tenants"]
    assert set(tenants) == {"ui", "batch"}
    assert tenants["ui"]["staleness_slo"] == 4


def test_router_healthz_aggregates_per_shard_health(qos_cluster):
    s, _ = qos_cluster
    ep = s.cluster.endpoint
    assert ep is not None and ep.port
    base = f"http://127.0.0.1:{ep.port}"
    with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
        doc = json.loads(r.read())
    assert doc["status"] in ("ok", "alerting")
    assert [sh["shard"] for sh in doc["shards"]] == [0, 1]
    for sh in doc["shards"]:
        assert sh["status"] in ("ok", "alerting")
    with urllib.request.urlopen(f"{base}/shards", timeout=10) as r:
        shards = json.loads(r.read())
    assert shards["router"]["n_lookups"] > 0
    assert len(shards["shards"]) == 2
    with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
        st = json.loads(r.read())
    assert st["cluster"]["n_shards"] == 2


def test_merge_health_fires_if_any_shard_fires():
    ok = {"n_alerts": 0, "alerts": [], "burn_rate": {"ui": 0.1},
          "wait_burn_rate": {}, "firing": []}
    bad = {"n_alerts": 2,
           "alerts": [{"kind": "slo_burn", "tenant": "ui"}],
           "burn_rate": {"ui": 2.5}, "wait_burn_rate": {},
           "firing": ["slo_burn:ui"]}
    merged = merge_health([ok, bad])
    assert merged["status"] == "alerting"
    assert merged["firing"] == ["shard1:slo_burn:ui"]
    assert merged["burn_rate"]["ui"] == 2.5    # worst shard wins
    assert merged["alerts"][0]["shard"] == 1
    assert [s["status"] for s in merged["shards"]] == ["ok", "alerting"]
    assert merge_health([ok, ok])["status"] == "ok"


# ----------------------------------------------------------------------
# the merge functions against the JAX package's
# ----------------------------------------------------------------------

def _shard_trees(i):
    """One shard's engine/session stats, attribution and health, with
    the shapes the workers report."""
    tenants = {"ui": {"n_served": 3 + i, "rows_served": 40 * (i + 1),
                      "wait_p50_steps": 1.0 + i, "wait_p95_steps": 2.5,
                      "staleness_max": 3.0 * i, "staleness_slo": 4,
                      "quota_util": 0.25 * (i + 1), "view_version": 2,
                      "slo_violations": i},
               "batch": {"n_served": 7, "rows_served": 100 + i,
                         "wait_p50_steps": 4.0, "wait_p95_steps": 9.0 - i,
                         "staleness_max": 1.0, "staleness_slo": 64,
                         "quota_util": 0.5, "view_version": 2,
                         "slo_violations": 0}}
    eng = {"store_version": 2, "n_served": 10 + i, "n_gather_steps": 4,
           "store_n_lookups": 20 + i, "store_rows_gathered": 300 * (i + 1),
           "store_hits": 50 + i, "store_misses": 5 * i,
           "store_n_evictions": i, "store_rows_evicted": 3 * i,
           "store_n_recomputes": 1, "store_n_recompute_spans": 2,
           "store_rows_recomputed": 7 * i, "store_recompute_s": 0.5 * i,
           "store_resident_bytes": 1000 + i, "store_budget_util": 0.4 + i,
           "n_refreshes": 3, "pending_mutations": 0, "tenants": tenants}
    attribution = {
        name: {"n_queries": 2 + i,
               "e2e_ms": {"sum": 10.0 + i, "p50": 1.0 + i, "p95": 3.0,
                          "max": 4.0 + i, "mean": 0.0},
               "segments_ms": {"queue_wait": 4.0 + i, "gather": 6.0}}
        for name in ("ui", "batch")}
    health = {"n_alerts": i, "alerts": [{"kind": "slo_burn"}] * i,
              "burn_rate": {"ui": 0.5 + i}, "wait_burn_rate": {"ui": 0.1},
              "firing": ["slo_burn:ui"] * i}
    session = dict(eng, attribution=attribution, health=health,
                   refresh_cutover={"threshold": 0, "n_local": 0},
                   metrics={"x": i}, plan_cache={"hits": i})
    memory = {f"level{l}": {"resident_rows": 10 * (l + 1) + i,
                            "budget_rows": 64, "resident_bytes": 640 + i}
              for l in range(3)}
    return eng, session, attribution, health, memory


def test_merge_functions_equal_the_jax_packages():
    from repro_torch.gnnserve.cluster import router as trouter
    trees = [_shard_trees(i) for i in range(3)]
    eng, session, attribution, health, memory = (
        [t[k] for t in trees] for k in range(5))
    for name, arg, kw in (
            ("merge_engine_stats", eng, {"pending": 4}),
            ("merge_session_stats", session, {"pending": 2}),
            ("merge_attribution", attribution, {}),
            ("merge_health", health, {}),
            ("merge_memory_stats", memory, {})):
        ours = getattr(trouter, name)(json.loads(json.dumps(arg)), **kw)
        theirs = getattr(jrouter, name)(json.loads(json.dumps(arg)), **kw)
        assert ours == theirs, name
    bad = [dict(eng[0]), dict(eng[1], store_version=3)]
    for mod in (trouter, jrouter):
        with pytest.raises(RuntimeError, match="different store versions"):
            mod.merge_engine_stats(bad)


# ----------------------------------------------------------------------
# lifecycle: launch failures, config checks, no process left behind
# ----------------------------------------------------------------------

def test_a_failed_launch_leaves_no_worker(tmp_path):
    """A worker that is not ready in time fails the launch with a
    stage-named diagnosis, and the deployment stops every process it
    started."""
    from repro_torch.gnnserve.cluster import (ClusterDeployment,
                                              WorkerWedged)
    cfg = DealConfig.from_dict({**_cfg_dict(n=128),
                                "cluster": {"n_shards": 2,
                                            "ready_timeout_s": 0.01}})
    spawned = []
    real = ClusterDeployment._spawn

    def spy(self, shard):
        real(self, shard)
        spawned.append(self.procs[shard])

    ClusterDeployment._spawn = spy
    try:
        with pytest.raises(WorkerWedged, match="not ready after"):
            ClusterDeployment(cfg, run_dir=str(tmp_path), device="cpu")
    finally:
        ClusterDeployment._spawn = real
    assert len(spawned) == 2
    assert all(p.poll() is not None for p in spawned)


def test_cluster_validation_matches_the_jax_package():
    from repro.api.config import ConfigError as JConfigError
    from repro.api.config import DealConfig as JDealConfig
    from repro_torch.api import ConfigError
    bad = {"cluster": {"n_shards": 2, "ports": [70000], "http_port": -5,
                       "ready_timeout_s": 0, "hang_timeout_s": -1,
                       "overrides": [{"shard": 7, "budget_rows": -1,
                                      "evict_policy": "nope", "wat": 1}]}}
    with pytest.raises(ConfigError) as ours:
        DealConfig.from_dict(bad).validate()
    with pytest.raises(JConfigError) as theirs:
        JDealConfig.from_dict(bad).validate()
    lines = [l for l in str(theirs.value).splitlines()
             if l.strip().startswith("- cluster.")]
    assert len(lines) >= 8
    for line in lines:
        assert line in str(ours.value).splitlines(), line
    with pytest.raises(ConfigError, match="the dist executor inside "
                       "cluster workers"):
        DealConfig.from_dict({"executor": {"name": "dist"},
                              "cluster": {"n_shards": 2}}).validate()


def test_from_checkpoint_refuses_cluster_configs(tmp_path):
    from repro_torch.api import ConfigError
    cfg = DealConfig.from_dict({**_cfg_dict(n=128),
                                "cluster": {"n_shards": 2}})
    with pytest.raises(ConfigError, match="single-process engine"):
        Session.from_checkpoint(tmp_path / "none.npz", cfg, device="cpu")


def test_no_worker_outlives_its_deployment(fifo_pair, qos_cluster,
                                           tmp_path):
    """Runs last in the file: every worker the module's deployments
    spawned (the fixtures close theirs at module teardown, so here only
    the ones already replaced or closed) is gone once its deployment
    let it go, and a fresh deployment's workers die with its close."""
    *_, s2, _, _ = fifo_pair
    live = {st["pid"] for st in s2.cluster.router.statuses()}
    gone = [p for p in _SEEN_PIDS if p not in live
            and p not in {st["pid"] for st in
                          qos_cluster[0].cluster.router.statuses()}]
    assert _wait_dead(gone), [p for p in gone if _alive(p)]
    with Session.build(DealConfig.from_dict(
            {**_cfg_dict(n=128), "cluster": {"n_shards": 2,
                                             "run_dir": str(tmp_path)}}),
            device="cpu") as s:
        s.serve()
        pids = [st["pid"] for st in s.cluster.router.statuses()]
        assert all(_alive(p) for p in pids)
    assert _wait_dead(pids)
