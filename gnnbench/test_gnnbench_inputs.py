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
