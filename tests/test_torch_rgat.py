"""R-GAT (``rgat``) in the port against the benchmark's plain reference,
``gnnbench/reference/rgat.py``, on a typed graph of about a thousand
nodes on seeded weights; each slot's relation and table row against a
brute-force mapping; R-GAT's attention wrapper against the definition
written out slot by slot; the ``ops.rel_rows`` counter against the rows
the reference's FLOPs count; and ``params_from_numpy("rgat")``'s
checks.  The tests marked ``gpu`` hold the kernel and the engine to
their plain versions on the card, at the benchmark cell's shapes.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gnnbench import inputs, reference, yardstick  # noqa: E402
from gnnbench.reference import rgat as rgat_ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import gnn_models  # noqa: E402
from repro_torch.core.graph import csr_from_edges_distributed  # noqa: E402
from repro_torch.core.layerwise import LOCAL_ENGINES  # noqa: E402
from repro_torch.core.ops import slot_relations  # noqa: E402
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# MAG240M's three node types and five relations (rgnn.py's edge types
# 0-4) at 1,200 nodes, the published shares; widths cut for the CPU
MAG = {"model": "rgat", "n_layers": 2, "d_feature": 24, "hidden_size": 32,
       "heads": 4, "n_classes": 8, "n_nodes": 1200, "n_edges": 9000,
       "node_types": {"paper": 121751666, "author": 122383112,
                      "institution": 25721},
       "relations": [
           {"name": "cites", "src": "paper", "dst": "paper",
            "n_edges": 1297748926, "undirected": True},
           {"name": "writes", "src": "author", "dst": "paper",
            "n_edges": 386022720},
           {"name": "written_by", "src": "paper", "dst": "author",
            "n_edges": 386022720},
           {"name": "affiliated_with", "src": "author",
            "dst": "institution", "n_edges": 44592586},
           {"name": "employs", "src": "institution", "dst": "author",
            "n_edges": 44592586}]}
# an undirected relation between two types: one relation, two blocks
MIXED = dict(MAG, node_types={"paper": 500, "author": 300, "inst": 100},
             n_nodes=900, n_edges=6000,
             relations=[{"src": "paper", "dst": "paper", "n_edges": 3000,
                         "undirected": True},
                        {"src": "author", "dst": "paper", "n_edges": 2000},
                        {"src": "author", "dst": "inst", "n_edges": 1000,
                         "undirected": True}])


def _world(cfg, fanouts, seed):
    """The benchmark's inputs, the port's layer graphs and params."""
    src, dst, X, tree, draws = inputs.make(cfg, fanouts, seed, "cpu")
    g, _ = csr_from_edges_distributed(src, dst, X.shape[0])
    lgs = [lg for fanout, n, s in draws
           for lg in sample_layer_graphs(g, fanout, n, s)]
    return src, dst, X, tree, draws, lgs


# The port's f32 sums run in other orders than the reference's: it folds
# each target score into x (W_r a_dst) and the biases and BatchNorm into
# one multiply-add, takes scores by GEMM and sums slots in slot order.
# Measured about 2e-7 (rel_l2) and 2e-6 (max_err); TF32 GEMMs read above
# 1e-4 (test_tf32_control_fails_at_this_size).
TOL = {"rel_l2": 1e-5, "max_err": 1e-4}


@pytest.mark.parametrize("executor", ["ref", "cuda"])
@pytest.mark.parametrize("cfg,fanouts", [(MAG, (25, 15)), (MAG, (6, 4)),
                                         (MIXED, (10, 5))],
                         ids=["mag-25-15", "mag-6-4", "mixed-10-5"])
def test_port_matches_the_reference(executor, cfg, fanouts):
    src, dst, X, tree, draws, lgs = _world(cfg, fanouts, 11)
    params = gnn_models.params_from_numpy("rgat", tree, "cpu")
    got = LOCAL_ENGINES["rgat"](lgs, X, params, executor=executor,
                                device="cpu")
    want = reference.embed_all("rgat", src, dst, X, tree, draws, "cpu")
    assert tuple(got.shape) == tuple(want.shape) == (X.shape[0], 8)
    err = yardstick.errors(got, want)
    assert err["rel_l2"] < TOL["rel_l2"], err
    assert err["max_err"] < TOL["max_err"], err


def test_tf32_control_fails_at_this_size():
    src, dst, X, tree, draws, _ = _world(MAG, (25, 15), 11)
    f32 = reference.embed_all("rgat", src, dst, X, tree, draws, "cpu")
    tf32 = reference.embed_all("rgat", src, dst, X, tree, draws, "cpu",
                               "tf32")
    assert yardstick.errors(tf32, f32)["rel_l2"] > 10 * TOL["rel_l2"]


def _brute_relations(nbr, mask, off, table, blocks):
    """rel and tid slot by slot, from the offsets and the table."""
    kind = np.searchsorted(np.asarray(off[1:]), np.arange(off[-1]),
                           side="right")
    base = {(r, st): b for r, st, b, _ in blocks}
    rel = np.full(nbr.shape, -1, np.int8)
    tid = np.zeros(nbr.shape, np.int32)
    for i in range(nbr.shape[0]):
        for f in range(nbr.shape[1]):
            j = nbr[i, f]
            r = table[kind[i]][kind[j]]
            if mask[i, f] and r >= 0:
                rel[i, f] = r
                tid[i, f] = base[r, kind[j]] + j - off[kind[j]]
    return rel, tid


@pytest.mark.parametrize("cfg", [MAG, MIXED], ids=["mag", "mixed"])
def test_slot_relations_match_a_brute_force_mapping(cfg):
    _, _, _, tree, _, lgs = _world(cfg, (25, 15), 3)
    typing = gnn_models.node_typing(tree["node_offsets"],
                                    tree["relation_table"],
                                    len(cfg["relations"]))
    for lg in lgs:
        mask = lg.mask.copy()
        mask[::7, 0] = False                 # masked slots keep no relation
        rel, tid = slot_relations(torch.as_tensor(lg.nbr),
                                  torch.as_tensor(mask), typing)
        want_rel, want_tid = _brute_relations(lg.nbr, mask,
                                              typing.offsets, typing.table,
                                              typing.blocks)
        assert rel.dtype == torch.int8 and tid.dtype == torch.int32
        np.testing.assert_array_equal(rel.numpy(), want_rel)
        np.testing.assert_array_equal(tid.numpy(), want_tid)
        assert (rel.numpy() >= 0).sum() == mask.sum()  # every edge typed
        assert int(tid.max()) < typing.rows


def test_mag_typing_has_five_relations_over_twice_the_rows():
    typing = gnn_models.node_typing([0, 500, 1000, 1010],
                                    [[0, 1, -1], [2, -1, 4], [-1, 3, -1]], 5)
    # cites and written_by project papers; writes and affiliated_with
    # authors; employs institutions
    assert typing.blocks == [(0, 0, 0, 500), (1, 1, 500, 500),
                             (2, 0, 1000, 500), (3, 1, 1500, 500),
                             (4, 2, 2000, 10)]
    assert typing.rows == 2010
    assert typing.sources(1) == [(0, 2, 1000), (2, 4, 2000)]


def _alpha_by_definition(s_src, s_dst, tid, rel, mask, slope=0.2):
    """alpha slot by slot: LeakyReLU(s_src + s_dst), a softmax over each
    row's live slots of each relation, in f64."""
    R, F = tid.shape
    H = s_src.shape[1]
    out = np.zeros((R, F, H))
    for i in range(R):
        for g in set(int(x) for x in rel[i][mask[i]]) - {-1}:
            fs = [f for f in range(F) if mask[i, f] and rel[i, f] == g]
            e = s_src[tid[i, fs]].astype(np.float64) + s_dst[i, g]
            e = np.where(e > 0, e, slope * e)
            p = np.exp(e - e.max(axis=0))
            out[i, fs] = p / p.sum(axis=0)
    return out


def _attention_case(R=64, F=25, H=4, n_rel=5, U=300, seed=0):
    """Rows with no live slot, rows that lack a relation, repeated
    neighbours, live slots of no relation."""
    g = torch.Generator().manual_seed(seed)
    s_src = torch.randn((U, H), generator=g)
    s_dst = torch.randn((R, n_rel, H), generator=g)
    tid = torch.randint(0, U, (R, F), generator=g, dtype=torch.int32)
    rel = torch.randint(0, 2, (R, F), generator=g).to(torch.int8)
    rel[R // 2:] += 2                      # rows of another pair of relations
    mask = torch.rand((R, F), generator=g) < 0.6
    mask[:4] = False                       # no live slot
    rel[4:8] = 1                           # lacks relation 0
    tid[8:12] = tid[8:12, :1]              # one neighbour, repeated
    rel[12, :3] = -1                       # live, of no relation
    mask[12, :3] = True
    return s_src, s_dst, tid, rel, mask


def test_attention_wrapper_matches_the_definition():
    case = _attention_case()
    before = kops.rgat_attention.launches
    got = kops.rgat_attention(*case)
    assert kops.rgat_attention.launches == before    # the CPU: no kernel
    assert got.shape == (64, 25, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  ref.rgat_attention_ref(*case).numpy())
    want = _alpha_by_definition(*[t.numpy() for t in case])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    s_src, s_dst, tid, rel, mask = case
    assert not got[:4].any() and not got[12, :3].any()
    # each row's weights of each of its relations sum to 1, a head each
    for i in (5, 9, 40):
        for r in set(rel[i][mask[i]].tolist()):
            sel = (rel[i] == r) & mask[i]
            np.testing.assert_allclose(got[i][sel].sum(0).numpy(),
                                       np.ones(4), rtol=1e-6)


def test_attention_wrapper_refuses_bad_shapes():
    s_src, s_dst, tid, rel, mask = _attention_case()
    with pytest.raises(ValueError, match="must be"):
        kops.rgat_attention(s_src, s_dst[:10], tid, rel, mask)
    with pytest.raises(ValueError, match="must be"):
        kops.rgat_attention(s_src[:, :2], s_dst, tid, rel, mask)


def test_rel_rows_counter_is_what_epoch_flops_counts():
    _, _, X, tree, _, lgs = _world(MAG, (25, 15), 5)
    params = gnn_models.params_from_numpy("rgat", tree, "cpu")
    tel = obs.Telemetry(enabled=True)
    with obs.use(tel):
        LOCAL_ENGINES["rgat"](lgs, X, params, executor="cuda", device="cpu")
    rows = rgat_ref.relation_rows(MAG, X.shape[0])
    assert tel.counters["ops.rel_rows"] == 2 * rows
    # the projected table is each relation's source rows: about 2N here
    assert X.shape[0] < rows < 2 * X.shape[0] + 10
    names = {n for n, *_ in tel.tracer.events_in_order()}
    assert {"io.rel", "ops.rel_project", "ops.rel_softmax",
            "ops.rel_attend", "ops.affine", "ops.elu",
            "ops.relu"} <= names
    # epoch_flops' relation GEMMs and source dots are over the same rows
    typing = gnn_models.node_typing(tree["node_offsets"],
                                    tree["relation_table"], 5)
    off = typing.offsets
    dst_pairs = sum((off[dt + 1] - off[dt]) * len(typing.sources(dt))
                    for dt in range(3))
    stats = [yardstick.layer_stats(lg.nbr, lg.mask) for lg in lgs]
    widths = rgat_ref.layer_widths(MAG)
    N, counted = X.shape[0], tel.counters["ops.rel_rows"] / 2
    want = sum(2 * N * di * do + 2 * counted * di * do
               + 2 * (counted + dst_pairs) * do + 2 * st["nnz"] * do
               for (di, do), st in zip(widths, stats))
    want += 2 * N * 32 * 32 + 2 * N * 32 * 8
    assert rgat_ref.epoch_flops(MAG, N, widths, stats) == want


@pytest.mark.parametrize("where", ["layer", "head", "top"])
def test_params_from_numpy_refuses_a_missing_leaf(where):
    _, _, _, tree, _, _ = _world(MAG, (6, 4), 2)
    gnn_models.params_from_numpy("rgat", tree, "cpu")       # whole: takes
    if where == "layer":
        del tree["layers"][1]["a_dst"]
    elif where == "head":
        del tree["head"]["bn_var"]
    else:
        del tree["relation_table"]
    with pytest.raises(ValueError, match="rgat params need"):
        gnn_models.params_from_numpy("rgat", tree, "cpu")


def test_params_keep_the_typing_as_ints():
    _, _, _, tree, _, _ = _world(MAG, (6, 4), 2)
    p = gnn_models.params_from_numpy("rgat", tree, "cpu")
    assert all(type(x) is int for x in p["node_offsets"])
    assert p["relation_table"] == [[0, 1, -1], [2, -1, 4], [-1, 3, -1]]
    assert p["heads"] == 4 and p["layers"][0]["w_rel"].shape == (5, 24, 32)


@pytest.mark.parametrize("name", ["rgat_attention_kernel",
                                  "void rgat_attention_kernel(float4 const*)"])
def test_rgat_attention_roofline_reads_the_kernels_launches(name):
    """The metric finds the kernel under the name the profiler gives it,
    launch i at layer i mod L, and nothing in a trace without it."""
    from types import SimpleNamespace
    from gnnbench.metrics import rgat_attention_roofline as metric
    stats = [{"R": 4096, "F": 25, "nnz": 15000, "uniq": 1200,
              "live_rows": 2000},
             {"R": 4096, "F": 15, "nnz": 12000, "uniq": 1100,
              "live_rows": 2000}]
    need = [yardstick.bound_s(metric.attention_bytes(st, 4),
                              metric.attention_ops(st, 4)) for st in stats]
    others = [("scores_kernel<float, float4, 4, true>", 1.0),
              ("spmm_kernel<float, 4>", 1.0)]
    ctx = SimpleNamespace(
        trace={"kernels": others + [(name, 2e-3), (name, 1e-3)] * 2},
        layer_stats=stats, cell=SimpleNamespace(cfg={"heads": 4}))
    assert metric.read(ctx) == pytest.approx(100 * 2 * sum(need) / 6e-3)
    ctx.trace = {"kernels": others}
    assert metric.read(ctx) is None


def test_rgat_engine_refuses_a_second_activation():
    _, _, X, tree, _, lgs = _world(MAG, (6, 4), 2)
    params = gnn_models.params_from_numpy("rgat", tree, "cpu")
    with pytest.raises(ValueError, match="activation must be None"):
        LOCAL_ENGINES["rgat"](lgs, X, params, torch.relu, executor="ref",
                              device="cpu")


def test_rgat_runs_on_one_card_only():
    from repro_torch.core.layerwise import DistributedLayerwise
    _, _, _, tree, _, lgs = _world(MAG, (6, 4), 2)
    params = gnn_models.params_from_numpy("rgat", tree, "cpu")
    with pytest.raises(ValueError, match="one card only"):
        DistributedLayerwise(None, lgs, "rgat", params)
    with pytest.raises(ValueError, match="typed graph"):
        gnn_models.MODELS.get("rgat").init(torch.Generator(), [8, 8], 4)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cell_world(dev, fanout, seed):
    """The cell's typing and in-degree at 2^16 nodes, one layer graph at
    ``fanout``, and source and target scores of 4 heads over its 5
    relations (the widths of 256 a head enter through the scores)."""
    import json
    cfg = json.loads((ROOT / "gnnbench" / "configs"
                      / "rgat-mag240m.json").read_text())
    n = 1 << 16
    cfg.update(n_nodes=n, n_edges=cfg["n_edges"] * n // cfg["n_nodes"])
    src, dst = inputs.edges(cfg, seed, "cpu")
    g, _ = csr_from_edges_distributed(src, dst, n)
    lg = sample_layer_graphs(g, fanout, 1, seed)[0]
    b = inputs.typed_blocks(cfg)
    typing = gnn_models.node_typing(b["node_offsets"], b["relation_table"],
                                    5)
    nbr = torch.as_tensor(lg.nbr, device=dev)
    mask = torch.as_tensor(lg.mask, device=dev)
    rel, tid = slot_relations(nbr, mask, typing)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_src = torch.randn((typing.rows, 4), generator=gen, device=dev) * 2
    s_dst = torch.randn((n, 5, 4), generator=gen, device=dev) * 2
    return s_src, s_dst, tid, rel, mask


@pytest.mark.gpu
@pytest.mark.parametrize("fanout", [25, 15])
def test_rgat_attention_kernel_matches_plain_at_the_cells_shapes(card,
                                                                 fanout):
    case = _cell_world(card, fanout, 7)
    before = kops.rgat_attention.launches
    got = kops.rgat_attention(*case)
    torch.cuda.synchronize()
    assert kops.rgat_attention.launches == before + 1
    want = ref.rgat_attention_ref(*case)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    live = (case[3] >= 0).cpu().numpy()
    assert not got.cpu().numpy()[~live].any()
    # a source table off the 16-byte boundary: refused, not read narrow
    s_src = case[0]
    flat = torch.empty(s_src.numel() + 1, device=card)
    view = flat[1:].view(s_src.shape)
    view.copy_(s_src)
    with pytest.raises(ValueError, match="16-byte"):
        kops.rgat_attention(view, *case[1:])
    assert kops.rgat_attention.launches == before + 1


@pytest.mark.gpu
def test_rgat_engine_through_the_kernels_matches_ref_on_the_card(card):
    src, dst, X, tree, draws, lgs = _world(dict(MAG, hidden_size=1024,
                                                d_feature=768), (25, 15), 4)
    params = gnn_models.params_from_numpy("rgat", tree, card)
    kops.reset_launch_counts()
    got = LOCAL_ENGINES["rgat"](lgs, X, params, device=card)
    counts = {"rgat": kops.rgat_attention.launches,
              "spmm": kops.spmm.launches}
    want = LOCAL_ENGINES["rgat"](lgs, X, params, executor="ref",
                                 device=card)
    assert counts == {"rgat": 2, "spmm": 2}, counts
    err = yardstick.errors(got, want)
    assert err["rel_l2"] < 1e-5 and err["max_err"] < 1e-4, err
    plain = reference.embed_all("rgat", src, dst, X, tree, draws, card)
    err = yardstick.errors(got, plain)
    assert err["rel_l2"] < 3e-5 and err["max_err"] < 1e-3, err
