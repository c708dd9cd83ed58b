"""The port's HTTP telemetry endpoint under concurrent scrapes (mirrors
tests/test_endpoint.py): ``/metrics``, ``/healthz`` and ``/stats`` serve
parallel readers while the engine keeps serving, an unknown path is a
404, the snapshot writer leaves a parseable file, and ``close()`` stops
the server; and the cluster router's endpoint over stub shards, serving
the JAX package's documents."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import DealConfig, Session  # noqa: E402
from repro_torch.gnnserve import Query  # noqa: E402
from repro_torch.obs.endpoint import json_sanitize  # noqa: E402


def _session(executor="ref", **telemetry):
    return Session.build(DealConfig.from_dict({
        "graph": {"dataset": "rmat", "n_nodes": 160, "avg_degree": 4,
                  "fanout": 4, "seed": 1},
        "model": {"name": "gcn", "n_layers": 2, "d_feature": 16},
        "executor": {"name": executor},
        "qos": {"staleness_bound": 4},
        "telemetry": {"enabled": True, **telemetry},
    }), device="cpu")


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        assert r.status == 200
        return r.read()


def _scrape_all(base, paths, n_rounds, failures):
    try:
        for _ in range(n_rounds):
            for p in paths:
                body = _get(f"{base}{p}")
                if p == "/metrics":
                    assert b"deal_" in body or body == b""
                else:
                    json.loads(body)
    except Exception as exc:        # surface thread failures to pytest
        failures.append(exc)


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_telemetry_endpoint_survives_concurrent_scrapes(executor):
    with _session(executor, http_port=0) as s:
        eng = s.serve()
        ep = s.endpoint
        assert ep is not None and ep.port
        base = f"http://127.0.0.1:{ep.port}"
        failures = []
        threads = [threading.Thread(
            target=_scrape_all, args=(base, ["/metrics", "/healthz",
                                            "/stats"], 10, failures))
            for _ in range(6)]
        for t in threads:
            t.start()
        # keep serving while the scrapers read the stats tree
        r = np.random.default_rng(2)
        for i in range(30):
            eng.mutate().add_edge(int(r.integers(0, 160)),
                                  int(r.integers(0, 160)))
            eng.submit(Query(i, r.integers(0, 160, 8).astype(np.int64)))
            eng.run()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert failures == []
        doc = json.loads(_get(f"{base}/stats"))
        assert doc["n_served"] == 30 and doc["n_refreshes"] > 0
        health = json.loads(_get(f"{base}/healthz"))
        assert health["status"] in ("ok", "alerting")
        metrics = _get(f"{base}/metrics").decode()
        assert metrics == s.prometheus_text()
        assert "deal_serve_gather_ms_count" in metrics


def test_telemetry_endpoint_404_and_stop():
    with _session(http_port=0) as s:
        s.serve()
        base = f"http://127.0.0.1:{s.endpoint.port}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert ei.value.code == 404
    assert s.endpoint is None
    # close() stopped the server: a later request fails to connect
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(f"{base}/stats", timeout=2)


def test_snapshot_writer_without_http(tmp_path):
    """``snapshot_path`` alone starts the writer (no server); the last
    snapshot on close holds the final stats and health."""
    path = tmp_path / "snap.json"
    with _session(snapshot_path=str(path), snapshot_every_s=0.05) as s:
        eng = s.serve()
        assert s.endpoint.port is None
        eng.submit(Query(0, np.arange(8)))
        eng.run()
    doc = json.loads(path.read_text())
    assert doc["stats"]["n_served"] == 1
    assert doc["health"]["status"] == "ok"
    assert not path.with_name("snap.json.tmp").exists()


def test_json_sanitize_turns_torch_and_numpy_into_json():
    tree = {"t0": torch.tensor(2.5), "t1": torch.arange(3),
            "bf16": torch.ones(2, dtype=torch.bfloat16), "i": np.int64(4),
            "f": np.float32(0.5), "a0": np.array(7), "nan": float("nan"),
            1: (np.arange(2), None, True)}
    got = json_sanitize(tree)
    assert got == {"t0": 2.5, "t1": [0, 1, 2], "bf16": [1.0, 1.0],
                   "i": 4, "f": 0.5, "a0": 7, "nan": None,
                   "1": [[0, 1], None, True]}
    json.dumps(got)


class _StubRouter:
    def __init__(self, per_shard):
        self.per_shard = per_shard

    def health(self):
        from repro_torch.gnnserve.cluster import merge_health
        return merge_health(self.per_shard)

    def statuses(self):
        return [{"shard": i, "pid": 1000 + i, "pending": 0}
                for i in range(len(self.per_shard))]

    def router_stats(self):
        return {"n_shards": len(self.per_shard), "n_lookups": 3,
                "n_subqueries": 5, "n_scatter": 2, "n_commits": 1,
                "n_retries": 0, "seq": [1, 1], "pending_mutations": 0}


class _StubDeployment:
    def __init__(self, per_shard):
        self.router = _StubRouter(per_shard)

    def stats(self):
        return {"n_served": 3, "cluster": {"n_shards": 2}}


def test_router_endpoint_aggregates_shard_health_states():
    """The mirror of tests/test_endpoint.py's router-endpoint test on the
    port's ``RouterEndpoint``: concurrent scrapes of every route, ANY
    alerting shard makes the aggregate alert, and the documents are the
    JAX package's."""
    from repro.gnnserve.cluster import RouterEndpoint as JRouterEndpoint
    from repro_torch.gnnserve.cluster import RouterEndpoint
    ok = {"n_alerts": 0, "alerts": [], "burn_rate": {},
          "wait_burn_rate": {}, "firing": [], "status": "ok"}
    alerting = {"n_alerts": 1,
                "alerts": [{"kind": "refresh_backlog"}],
                "burn_rate": {"ui": 3.0}, "wait_burn_rate": {},
                "firing": ["refresh_backlog"], "status": "alerting"}
    dep = _StubDeployment([ok, alerting])
    ep = RouterEndpoint(dep).start()
    jep = JRouterEndpoint(dep).start()
    try:
        base = f"http://127.0.0.1:{ep.port}"
        failures = []
        threads = [threading.Thread(
            target=_scrape_all,
            args=(base, ["/healthz", "/shards", "/stats"], 10,
                  failures)) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert failures == []
        doc = json.loads(_get(f"{base}/healthz"))
        assert doc["status"] == "alerting"         # ANY shard alerting
        assert doc["firing"] == ["shard1:refresh_backlog"]
        assert [s["status"] for s in doc["shards"]] == \
            ["ok", "alerting"]
        shards = json.loads(_get(f"{base}/shards"))
        assert [s["shard"] for s in shards["shards"]] == [0, 1]
        assert shards["router"]["n_shards"] == 2
        jbase = f"http://127.0.0.1:{jep.port}"
        for path in ("/healthz", "/shards", "/stats"):
            assert _get(f"{base}{path}") == _get(f"{jbase}{path}"), path
    finally:
        ep.stop()
        jep.stop()
