"""The benchmark's inputs are made from the seed alone: the same seed
gives the same edges, features and params; another seed others."""
import numpy as np
import pytest

from gnnbench import inputs

CFG = {"model": "sage", "n_nodes": 256, "n_edges": 256 * 6,
       "d_feature": 8, "hidden_size": 12, "n_layers": 2, "heads": 1}
FANOUTS = (25, 10)


def _same(a, b):
    sa, da, xa, ta, ka = a
    sb, db, xb, tb, kb = b
    return (np.array_equal(sa, sb) and np.array_equal(da, db)
            and np.array_equal(xa, xb) and ka == kb
            and all(np.array_equal(pa[k], pb[k])
                    for pa, pb in zip(ta["layers"], tb["layers"])
                    for k in pa))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3, -3])
def test_inputs_are_deterministic_by_seed(seed):
    a = inputs.make(CFG, FANOUTS, seed, "cpu")
    assert _same(a, inputs.make(CFG, FANOUTS, seed, "cpu"))
    assert not _same(a, inputs.make(CFG, FANOUTS, seed + 1, "cpu"))


def test_inputs_have_the_configured_shapes():
    src, dst, X, tree, draws = inputs.make(CFG, FANOUTS, 11, "cpu")
    assert src.shape == dst.shape == (256 * 6,)
    assert src.dtype == dst.dtype == np.int64
    assert 0 <= src.min() and src.max() < 256 and dst.max() < 256
    assert X.shape == (256, 8) and X.dtype == np.float32
    assert len(tree["layers"]) == 2
    assert set(tree["layers"][0]) == {"w_self", "w_nbr"}
    assert tree["layers"][0]["w_nbr"].shape == (8, 12)
    assert tree["layers"][1]["w_nbr"].shape == (12, 12)
    assert [(f, n) for f, n, _ in draws] == [(25, 1), (10, 1)]
    assert all(0 <= s < 2 ** 63 for _, _, s in draws)


def test_gat_params_carry_heads():
    tree = inputs.params("gat", [10, 12, 12, 12], 4, 5, "cpu")
    assert tree["heads"] == 4
    assert [set(p) for p in tree["layers"]] == [{"wq", "wk", "wv"}] * 3
    assert [p["wq"].shape for p in tree["layers"]] == [(10, 12), (12, 12),
                                                       (12, 12)]


def test_params_scale_by_the_width_in():
    tree = inputs.params("sage", [64, 256], 1, 3, "cpu")
    assert tree["layers"][0]["w_self"].std() == pytest.approx(64 ** -0.5,
                                                              rel=0.05)


@pytest.mark.parametrize("fanouts,runs", [((10, 10, 10), [(10, 3)]),
                                          ((25, 10), [(25, 1), (10, 1)]),
                                          ((15, 10, 10), [(15, 1), (10, 2)])])
def test_sample_draws_share_runs_of_equal_fanouts(fanouts, runs):
    draws = inputs.sample_draws(fanouts, 99)
    assert [(f, n) for f, n, _ in draws] == runs
    assert len({s for _, _, s in draws}) == len(runs)
    assert draws == inputs.sample_draws(fanouts, 99)


def test_undirected_edges_are_taken_both_ways():
    cfg = dict(CFG, undirected=True)
    src, dst = inputs.edges(cfg, 5, "cpu")
    half = 256 * 6
    assert src.shape == (2 * half,)
    assert np.array_equal(src[half:], dst[:half])
    assert np.array_equal(dst[half:], src[:half])


def test_fanouts_must_match_the_layers():
    with pytest.raises(ValueError):
        inputs.make(CFG, (10, 10, 10), 1, "cpu")


def test_rmat_folds_ids_below_a_node_count_off_a_power_of_two():
    src, dst = inputs.rmat_edges(1000, 5000, 3, "cpu")
    assert src.max() < 1000 and dst.max() < 1000


def test_rmat_skews_towards_low_ids():
    """Graph500's (0.57, 0.19, 0.19, 0.05): the first quadrant takes
    most edges, so low ids gather the in-edges."""
    src, dst = inputs.rmat_edges(1024, 20000, 3, "cpu")
    assert (dst < 512).mean() > 0.7
    assert (src < 512).mean() > 0.7


def test_spawned_seeds_differ():
    s = inputs.spawn_seeds(123, 4)
    assert len(set(s)) == 4 and all(0 <= x < 2 ** 63 for x in s)
    assert inputs.spawn_seeds(-123, 4) != s


# -- the two configurations' inputs, pinned bitwise ---------------------

def _digest(out) -> str:
    """One sha256 over every input of ``inputs.make``: the edges, the
    features, the param tree's keys, its other entries and every leaf
    with its dtype and shape, and the sampler's draws."""
    import hashlib
    import json
    src, dst, X, tree, draws = out
    h = hashlib.sha256()
    for a in (src, dst, X):
        h.update(str((a.dtype, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(json.dumps(sorted(tree)).encode())
    h.update(json.dumps({k: v for k, v in tree.items() if k != "layers"},
                        sort_keys=True).encode())
    for layer in tree["layers"]:
        for k in sorted(layer):
            a = np.asarray(layer[k])
            h.update(k.encode())
            h.update(str((a.dtype, a.shape)).encode())
            h.update(a.tobytes())
    h.update(json.dumps(draws).encode())
    return h.hexdigest()


# taken before the model-specific steps moved into the models' modules
PINNED = {
    "sage-papers100m": ((25, 10), 59588, "6bcb060fa1de4b133ea13bd2cfa6aacf"
                        "7bd057ea34befbcdf2a0673c425370c9"),
    "gat-products": ((10, 10, 10), 103459, "8c5f0848e25fd79229b77d6ee75297"
                     "8250654dd6a89da471315643e21b1eeaf5"),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_inputs_of_each_configuration_are_pinned_bitwise(name):
    """At 4,096 nodes, the configuration's in-degree and published
    widths, ``inputs.make`` gives the same bytes as before."""
    import json
    from pathlib import Path
    fanouts, n_edges, want = PINNED[name]
    cfg = json.loads((Path(__file__).parent / "configs"
                      / f"{name}.json").read_text())
    n = 4096
    cfg.update(n_nodes=n, n_edges=cfg["n_edges"] * n // cfg["n_nodes"])
    assert cfg["n_edges"] == n_edges
    assert _digest(inputs.make(cfg, fanouts, 2 ** 31 + 7, "cpu")) == want


# -- typed graphs ---------------------------------------------------------

TYPED = {"model": "sage", "n_nodes": 600, "d_feature": 8, "hidden_size": 12,
         "n_layers": 2, "heads": 1,
         "node_types": {"paper": 400, "author": 150, "inst": 50},
         "relations": [
             {"name": "cites", "src": "paper", "dst": "paper",
              "n_edges": 2000, "undirected": True},
             {"name": "writes", "src": "author", "dst": "paper",
              "n_edges": 900, "undirected": False},
             {"name": "affiliated", "src": "author", "dst": "inst",
              "n_edges": 300, "undirected": True}]}


def test_typed_blocks_and_relation_table():
    b = inputs.typed_blocks(TYPED)
    assert b["node_offsets"] == [0, 400, 550, 600]
    # rows: the destination's type; columns: the source's
    assert b["relation_table"] == [[0, 1, -1], [-1, -1, 2], [-1, 2, -1]]
    assert b["relation_edges"] == [2000, 900, 300]
    assert inputs.typed_blocks(CFG) is None
    assert set(inputs.model_params(CFG, 1, "cpu")) == {"layers"}


def test_typed_edges_lie_in_their_relations_blocks():
    src, dst = inputs.edges(TYPED, 5, "cpu")
    assert src.shape == dst.shape == (2 * 2000 + 900 + 2 * 300,)
    assert src.dtype == dst.dtype == np.int64
    blocks = {"cites": (0, 4000, (0, 400), (0, 400)),
              "writes": (4000, 4900, (400, 550), (0, 400)),
              "affiliated": (4900, 5500, (400, 550), (550, 600))}
    for name, (lo, hi, (s0, s1), (d0, d1)) in blocks.items():
        s, d = src[lo:hi], dst[lo:hi]
        if name == "affiliated":             # undirected: both ways
            s, d = s[:300], d[:300]
            assert np.array_equal(src[lo + 300:hi], d)
            assert np.array_equal(dst[lo + 300:hi], s)
        assert s0 <= s.min() and s.max() < s1, name
        assert d0 <= d.min() and d.max() < d1, name
    assert np.array_equal(src[2000:4000], dst[:2000])
    assert len(np.unique(dst[4000:4900])) > 100


def test_each_relation_draws_from_a_seed_of_its_own():
    """A change in one relation's edge count leaves the others' draws
    alone."""
    a = inputs.edges(TYPED, 9, "cpu")
    rels = [dict(r) for r in TYPED["relations"]]
    rels[1]["n_edges"] = 700
    b = inputs.edges(dict(TYPED, relations=rels), 9, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x[:4000], y[:4000])
        assert np.array_equal(x[4900:], y[4700:])
        assert not np.array_equal(x[4000:4700], y[4000:4700])


def test_typed_blocks_keep_their_shares_in_a_smaller_run():
    """The published MAG240M layout cut to 1,024 nodes and 6,144 edges,
    as the tests cut every cell: each block and relation keeps its
    share, at least one node or edge each."""
    cfg = {"node_types": {"paper": 121751666, "author": 122383112,
                          "institution": 25721},
           "relations": [{"src": "paper", "dst": "paper",
                          "n_edges": 1297748926, "undirected": True},
                         {"src": "author", "dst": "paper",
                          "n_edges": 386022720},
                         {"src": "paper", "dst": "author",
                          "n_edges": 386022720},
                         {"src": "author", "dst": "institution",
                          "n_edges": 44592586},
                         {"src": "institution", "dst": "author",
                          "n_edges": 44592586}],
           "n_nodes": 1024, "n_edges": 6144}
    b = inputs.typed_blocks(cfg)
    assert b["node_offsets"] == [0, 510, 1023, 1024]
    assert b["relation_edges"] == [3693, 1098, 1098, 126, 126]
    src, dst = inputs.edges(cfg, 3, "cpu")
    assert src.shape == (2 * 3693 + 2 * 1098 + 2 * 126,)
    assert src.max() < 1024 and dst.max() < 1024


def test_relations_that_share_a_pair_of_types_are_refused():
    rels = TYPED["relations"] + [{"src": "inst", "dst": "author",
                                  "n_edges": 10}]
    with pytest.raises(ValueError, match="both join inst to author"):
        inputs.typed_blocks(dict(TYPED, relations=rels))
    with pytest.raises(ValueError, match="cannot hold"):
        inputs.typed_blocks(dict(TYPED, n_nodes=2))


def test_typed_graph_puts_its_layout_in_the_tree():
    """As Python ints, which the port's ``params_from_numpy`` passes
    through unchanged (f32 would round ids above 2 ** 24)."""
    src, dst, X, tree, _ = inputs.make(TYPED, (5, 5), 4, "cpu")
    assert X.shape == (600, 8)
    assert tree["node_offsets"] == [0, 400, 550, 600]
    assert tree["relation_table"] == inputs.typed_blocks(
        TYPED)["relation_table"]
    assert all(type(x) is int for x in tree["node_offsets"])
    assert set(tree) == {"layers", "node_offsets", "relation_table"}


# -- params that a model declares ------------------------------------------

SPEC = {"layers": [{"w": ((3, 64, 32), "fan_in"), "b": ((32,), 0.1),
                    "var": ((32,), (0.5, 1.5)), "z": ((4,), 0)}],
        "head": [((32, 7), "fan_in"), ((7,), (-1.0, 1.0))]}


def test_declared_params_draw_each_leaf_as_declared():
    tree = inputs.declared_params(SPEC, 3, "cpu")
    p = tree["layers"][0]
    assert list(tree) == ["layers", "head"] and list(p) == ["w", "b", "var",
                                                            "z"]
    assert p["w"].shape == (3, 64, 32) and p["w"].dtype == np.float32
    assert p["w"].std() == pytest.approx(64 ** -0.5, rel=0.05)
    assert p["b"].shape == (32,) and 0.05 < p["b"].std() < 0.2
    assert 0.5 <= p["var"].min() and p["var"].max() < 1.5
    assert not p["z"].any()
    w, v = tree["head"]
    assert w.shape == (32, 7) and v.shape == (7,)
    assert -1 <= v.min() and v.max() < 1
    again = inputs.declared_params(SPEC, 3, "cpu")
    assert all(np.array_equal(p[k], again["layers"][0][k]) for k in p)
    assert not np.array_equal(
        p["w"], inputs.declared_params(SPEC, 4, "cpu")["layers"][0]["w"])


def test_fan_in_needs_a_matrix():
    with pytest.raises(ValueError, match="fan_in"):
        inputs.declared_params({"b": ((8,), "fan_in")}, 1, "cpu")


def test_model_params_take_the_modules_shapes_and_heads(monkeypatch):
    """A model whose reference declares ``param_shapes`` gets those
    leaves, ``heads`` where it has more than one, and a typed graph's
    layout; one with one head gets no ``heads``."""
    import sys
    import types
    mod = types.ModuleType("gnnbench.reference.declared")
    mod.param_shapes = lambda cfg: {"layers": [
        {"w": ((cfg["d_feature"], cfg["hidden_size"]), "fan_in")}]}
    monkeypatch.setitem(sys.modules, "gnnbench.reference.declared", mod)
    cfg = dict(TYPED, model="declared", heads=4)
    tree = inputs.model_params(cfg, 7, "cpu")
    assert tree["heads"] == 4 and tree["layers"][0]["w"].shape == (8, 12)
    assert tree["node_offsets"] == [0, 400, 550, 600]
    assert "heads" not in inputs.model_params(dict(cfg, heads=1), 7, "cpu")
    assert "heads" not in inputs.model_params(CFG, 7, "cpu")
