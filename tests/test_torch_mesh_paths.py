"""The mesh paths against the port's baselines and the JAX package's:
``moe_block``'s expert-parallel path (``tuning.on("moe_ep")``) and
``cp_decode_attention`` (the sequence-parallel decode of
``tuning.on("cp_decode")``), as ``tests/helpers/tuned_check.py`` holds
JAX's (deepseek-v2 reduced in f32 at capacity factor 64 on a 4 x 2 mesh,
within 1e-4; B=1, S=64, H=4, K=2, hd=16 at cache_len 49 on 8 x 1, plain
and with window 7, within 2e-5); the decode step under ``cp_decode``;
and the placed paths (``sharding.placement``) on meshes whose shards are
all ``cpu``: cp_decode on a placed cache, zamba2's decode and
deepseek-v2's prefill on placed params and caches, ``launch.train.run``
data parallel on placed params and AdamW state, and checkpoints across
meshes."""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro import tuning as jtuning  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import tuning as ttuning  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.mesh import (AbstractMesh, Mesh,  # noqa: E402
                                     make_host_mesh, make_production_mesh)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import step as tserve  # noqa: E402
from repro_torch.sharding import placement  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.sharding.context import (current_mesh,  # noqa: E402
                                          sharding_context)

TWO_CARDS = [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the tests share the CPU with other
    pytest workers, where PyTorch's OpenMP threads spin while they
    wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32)))


def _moe_cfgs(capacity):
    return [dataclasses.replace(
        c, dtype="float32", moe=dataclasses.replace(
            c.moe, capacity_factor=capacity))
        for c in (jconfigs.get_config("deepseek-v2-236b").reduced(),
                  tconfigs.get_config("deepseek-v2-236b").reduced())]


def _moe_inputs(jc, B, S, seed=0):
    rng = np.random.default_rng(seed)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = tmoe.MoE(**{k: _t(v) for k, v in jp.items()})
    x = (rng.standard_normal((B, S, jc.d_model)) * 0.5).astype(np.float32)
    return jp, tp, x


@pytest.mark.parametrize("B", [4, 3])
def test_moe_ep_matches_moe_block_and_jax(B, monkeypatch):
    """On a 4 x 2 mesh: B=4 splits over the 4 data shards, B=3 does not
    divide and stays whole (every shard sees all tokens).  The aux loss
    is each data shard's Switch loss averaged over them, as JAX's pmean
    takes it: the whole batch's when it stays whole."""
    jc, tc = _moe_cfgs(64.0)
    jp, tp, x = _moe_inputs(jc, B, 8)
    want, want_aux = jmoe.moe_block(jnp.asarray(x), jp, jc)
    base, base_aux = tmoe.moe_block(torch.from_numpy(x), tp, tc)
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    mesh = make_host_mesh(4, 2, device="cpu")
    calls = []
    real = tmoe._moe_block_ep
    with sharding_context(mesh), mock.patch.object(
            tmoe, "_moe_block_ep",
            side_effect=lambda *a: calls.append(1) or real(*a)):
        got, aux = tmoe.moe_block(torch.from_numpy(x), tp, tc)
    assert calls == [1]
    assert got.shape == base.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if B == 4:     # JAX's pmean of each data shard's Switch loss
        base_aux = np.mean([float(tmoe.moe_block(
            torch.from_numpy(x[i:i + 1]), tp, tc)[1]) for i in range(4)])
        want_aux = np.mean([float(jmoe.moe_block(
            jnp.asarray(x[i:i + 1]), jp, jc)[1]) for i in range(4)])
    np.testing.assert_allclose(float(aux), float(base_aux), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)


def test_moe_ep_drops_what_the_baseline_drops(monkeypatch):
    """With capacity drops and the tokens whole (a 1 x 2 mesh), each
    model shard buckets its experts' tokens as the baseline buckets
    them: the same slots are kept and dropped."""
    jc, tc = _moe_cfgs(0.5)
    _, tp, x = _moe_inputs(jc, 2, 16, seed=3)
    xt = torch.from_numpy(x)
    base, _ = tmoe.moe_block(xt, tp, tc)
    m = tc.moe
    C = tmoe._capacity(32, m.n_experts, m.top_k, 0.5)
    full = tmoe.route(xt.reshape(32, -1), tp.router, m.n_experts, m.top_k,
                      C)
    assert int((~full.keep).sum()) > 0
    kept = 0
    for lo in range(0, m.n_experts, 2):
        r = tmoe.route(xt.reshape(32, -1), tp.router, 2, m.top_k, C,
                       expert_offset=lo)
        kept += int(r.keep.sum())
    assert kept == int(full.keep.sum())
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    with sharding_context(make_host_mesh(1, 2, device="cpu")):
        got, _ = tmoe.moe_block(xt, tp, tc)
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-5)


@pytest.mark.parametrize("window", [None, 7])
def test_cp_decode_matches_decode_and_jax(window):
    rng = np.random.default_rng(0)
    B, S, H, K, hd = 1, 64, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), cache_len=49,
                                  window=window)
    tq, tk, tv = map(torch.from_numpy, (q, kc, vc))
    base = tattn.decode_attention(tq, tk, tv, cache_len=49, window=window)
    got = tattn.cp_decode_attention(tq, tk, tv, cache_len=49,
                                    mesh=make_host_mesh(8, 1, device="cpu"),
                                    window=window)
    assert got.shape == (B, 1, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    with pytest.raises(ValueError, match="divide"):
        tattn.cp_decode_attention(tq, tk[:, :60], tv[:, :60], cache_len=49,
                                  mesh=make_host_mesh(8, 1, device="cpu"))


def test_decode_step_under_cp_decode_equals_it_without(monkeypatch):
    """gemma3-4b reduced (its local layers have a window), B=1: each GQA
    layer's decode goes through cp_decode_attention on a 4 x 1 mesh,
    and the logits and caches agree with the plain decode's."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3-4b").reduced(),
                              dtype="float32")
    params = ttf.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 9)))
    _, _, pre = ttf.forward(cfg, params, {"tokens": tokens},
                            return_cache=True)
    outs = {}
    calls = []
    real = ttf.cp_decode_attention
    for flag in ("", "cp_decode"):
        monkeypatch.setenv("REPRO_TUNING", flag)
        cache = ttf.init_cache(cfg, 1, 16, device="cpu")
        for n in ("k", "v"):
            cache[n][:, :, :9] = pre[n]
        tok = tokens[:, -1:]
        logits = []
        with sharding_context(make_host_mesh(4, 1, device="cpu")), \
                mock.patch.object(ttf, "cp_decode_attention", side_effect=(
                    lambda *a, **k: calls.append(flag) or real(*a, **k))):
            for t in range(3):
                lg, cache = ttf.decode_step(cfg, params, cache,
                                            {"token": tok, "pos": 9 + t})
                tok = lg[:, -1].argmax(-1, keepdim=True)
                logits.append(lg)
        outs[flag] = (torch.cat(logits), cache)
    assert calls == ["cp_decode"] * (3 * cfg.n_layers)
    np.testing.assert_allclose(outs["cp_decode"][0].numpy(),
                               outs[""][0].numpy(), atol=2e-5, rtol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(outs["cp_decode"][1][n].numpy(),
                                   outs[""][1][n].numpy(), atol=2e-5)


LOSS_TOL = dict(atol=1e-5, rtol=1e-4)   # tests/test_torch_train.py's
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)


def _f32(arch):
    return dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               dtype="float32")


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_train_run_on_a_one_device_mesh_equals_no_mesh(shape):
    """(1, 1): placed on one shard, the run is bitwise the run without a
    mesh.  (2, 2): data parallel over two data shards, as JAX's is under
    GSPMD, so the sums split: in f32 the losses within LOSS_TOL and the
    first step's gradients within GRAD_TOL of no mesh."""
    cfg = (tconfigs.get_config("smollm-360m").reduced() if shape == (1, 1)
           else _f32("smollm-360m"))
    kw = dict(steps=3, batch=2, seq=16, log_every=10, device="cpu", cfg=cfg)
    _, want = tlaunch.run("smollm-360m", **kw)
    seen = []
    real = tlaunch.train_step

    def step(*a, **k):
        seen.append(current_mesh())
        return real(*a, **k)

    mesh = make_host_mesh(*shape, device="cpu")
    with mock.patch.object(tlaunch, "train_step", side_effect=step):
        _, got = tlaunch.run("smollm-360m", mesh=mesh, **kw)
    assert seen == [mesh] * 3 and current_mesh() is None
    if shape == (1, 1):
        assert got == want
        return
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    batch = next(tdata.synthetic_batches(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, batch_size=2, seed=0)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = ttf.init_params(cfg, 0, device="cpu")
    params.requires_grad_(True)
    (_, (ce, _)), grads = tstep.loss_and_grads(cfg, params, batch,
                                               attn_backend="ref")
    placed = placement.place_module(params, tspecs.param_specs(
        cfg, params, mesh), mesh)
    with sharding_context(mesh):
        (_, (pce, _)), pgrads = tstep.placed_loss_and_grads(
            cfg, placed, batch, attn_backend="ref")
    np.testing.assert_allclose(float(pce), float(ce), **LOSS_TOL)
    for n, g in grads.items():
        np.testing.assert_allclose(placement.gather(pgrads[n]).numpy(),
                                   g.detach().numpy(), **GRAD_TOL,
                                   err_msg=n)


def test_train_run_with_moe_ep_on_a_one_device_mesh(monkeypatch):
    """deepseek-v2 reduced in f32 trains through the expert-parallel MoE
    (its backward through the experts' blocks) on a 1 x 2 mesh within
    1e-5 of the baseline (the tokens stay whole: the same capacity and
    aux loss)."""
    cfg = _f32("deepseek-v2-236b")
    kw = dict(steps=2, batch=2, seq=16, log_every=10, device="cpu", cfg=cfg)
    _, want = tlaunch.run("deepseek-v2-236b", **kw)
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    _, got = tlaunch.run("deepseek-v2-236b",
                         mesh=make_host_mesh(1, 2, device="cpu"), **kw)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _ds_batch(cfg, B=4, S=16):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_moe_ep_train_grads_land_on_the_expert_blocks(shape, monkeypatch):
    """Data parallel under moe_ep: each data shard's loss and capacity
    are those of its own rows, with JAX's pmean of the aux loss, so the
    step's loss and gradients are the mean over the data shards of the
    baseline's on each shard's rows (within LOSS_TOL and GRAD_TOL).
    Each expert block's gradient is a tensor of the block's shape,
    computed from the data shards' copies of that model shard's experts
    only."""
    cfg = _f32("deepseek-v2-236b")
    batch = _ds_batch(cfg)
    params = ttf.init_params(cfg, 0, device="cpu")
    params.requires_grad_(True)
    P = shape[0]
    n = 4 // P
    refs = [tstep.loss_and_grads(cfg, params, {k: v[i * n:(i + 1) * n]
                                               for k, v in batch.items()},
                                 attn_backend="ref") for i in range(P)]
    mesh = make_host_mesh(*shape, device="cpu")
    placed = placement.place_module(params, tspecs.param_specs(
        cfg, params, mesh), mesh)
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    calls = []
    real = tmoe._moe_block_ep
    with sharding_context(mesh), mock.patch.object(
            tmoe, "_moe_block_ep", side_effect=lambda *a: calls.append(
                a[3].shape) or real(*a)):
        (total, _), grads = tstep.placed_loss_and_grads(
            cfg, placed, batch, attn_backend="ref")
    # one call a MoE layer a data shard, each on its row of the mesh
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert calls[:P * n_moe] == [{"data": 1, "model": shape[1]}] * (
        P * n_moe)
    np.testing.assert_allclose(
        float(total), np.mean([float(r[0][0]) for r in refs]), **LOSS_TOL)
    for name, g in grads.items():
        want = sum(r[1][name] for r in refs) / P
        np.testing.assert_allclose(placement.gather(g).numpy(),
                                   want.detach().numpy(), **GRAD_TOL,
                                   err_msg=name)
        for blk, rng in zip(g.blocks, g.ranges):
            assert tuple(blk.shape) == tuple(b - a for a, b in rng)
    # each (p, m) assembles model shard m's experts from the P data
    # shards' blocks (its own included); on 1 x M its block is the slab
    assert mesh.sent["experts"] == (
        0 if P == 1 else sum(x.blocks[0].numel() * 4 * P * P * shape[1]
                             for n_, x in placed.named_parameters()
                             if n_.split(".")[-2:] in (
                                 ["moe", "w_gate"], ["moe", "w_up"],
                                 ["moe", "w_down"])))


def test_baseline_moe_train_on_a_mesh_keeps_the_whole_batch_aux():
    """Without moe_ep, a data-parallel step builds the Switch aux loss
    from the whole batch's mean router probabilities and top-1 shares,
    as GSPMD computes it: loss, aux and gradients within LOSS_TOL and
    GRAD_TOL of no mesh on 2 x 2 and 4 x 1."""
    cfg = _f32("deepseek-v2-236b")
    batch = _ds_batch(cfg)
    params = ttf.init_params(cfg, 0, device="cpu")
    params.requires_grad_(True)
    (total, (_, aux)), grads = tstep.loss_and_grads(cfg, params, batch,
                                                    attn_backend="ref")
    for shape in ((2, 2), (4, 1)):
        mesh = make_host_mesh(*shape, device="cpu")
        placed = placement.place_module(params, tspecs.param_specs(
            cfg, params, mesh), mesh)
        with sharding_context(mesh):
            (ptotal, (_, paux)), pgrads = tstep.placed_loss_and_grads(
                cfg, placed, batch, attn_backend="ref")
        np.testing.assert_allclose(float(ptotal), float(total), **LOSS_TOL)
        np.testing.assert_allclose(float(paux), float(aux), **LOSS_TOL)
        for n, g in grads.items():
            np.testing.assert_allclose(placement.gather(pgrads[n]).numpy(),
                                       g.detach().numpy(), **GRAD_TOL,
                                       err_msg=f"{shape} {n}")


def test_a_mesh_over_several_devices_raises(monkeypatch):
    """An abstract production mesh holds no devices: outside a trace on
    the meta device every mesh path and the launcher refuse it.  Tensors
    that are not on a mesh's home are refused with ValueError: plain
    inputs run on the home."""
    mesh = make_production_mesh()
    with pytest.raises(NotImplementedError, match="256 devices"):
        tattn.cp_decode_attention(torch.zeros((1, 1, 4, 16)),
                                  torch.zeros((1, 32, 2, 16)),
                                  torch.zeros((1, 32, 2, 16)),
                                  cache_len=5, mesh=mesh)
    with pytest.raises(NotImplementedError, match="256 devices"):
        tlaunch.run("smollm-360m", steps=1, mesh=mesh, device="cpu")
    jc, tc = _moe_cfgs(64.0)
    _, tp, _ = _moe_inputs(jc, 1, 1)
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    with sharding_context(make_production_mesh(multi_pod=True)):
        with pytest.raises(NotImplementedError, match="512 devices"):
            tmoe.moe_block(torch.zeros((1, 4, tc.d_model)), tp, tc)
    with sharding_context(Mesh(1, 2, TWO_CARDS)):
        with pytest.raises(ValueError, match="home on cuda:0, the tensors "
                                             "are on cpu"):
            tmoe.moe_block(torch.zeros((1, 4, tc.d_model)), tp, tc)
    for m in (Mesh(2, 1, TWO_CARDS), Mesh(1, 1, TWO_CARDS[:1])):
        with pytest.raises(ValueError, match="home on cuda:0"):
            tattn.cp_decode_attention(
                torch.zeros((1, 1, 4, 16)), torch.zeros((1, 32, 2, 16)),
                torch.zeros((1, 32, 2, 16)), cache_len=5, mesh=m)
        with pytest.raises(ValueError, match="home on cuda:0"):
            tlaunch.run("smollm-360m", steps=1, mesh=m, device="cpu")
    assert isinstance(make_production_mesh(multi_pod=True), AbstractMesh)
    # a placed cache must have both halves placed
    cpu = make_host_mesh(2, 1, device="cpu")
    kc = placement.place(torch.zeros((1, 32, 2, 16)),
                         (None, "data", None, None), cpu)
    with pytest.raises(ValueError, match="both caches"):
        tattn.cp_decode_attention(torch.zeros((1, 1, 4, 16)), kc,
                                  torch.zeros((1, 32, 2, 16)), cache_len=5,
                                  mesh=cpu)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_cp_decode_on_a_placed_cache_is_bitwise_the_view_split(window,
                                                                shape):
    """The caches placed by ``cache_specs``' B = 1 rule (the sequence
    over ``data``; on 4 x 2 the head dim over ``model`` too, gathered
    over ``model`` on each data shard's card): bitwise the result on
    whole caches split by views, and only the softmax messages cross
    (q and the length out, the maxima in, the max out, sums and
    accumulators in: nothing of the size of the cache)."""
    rng = np.random.default_rng(0)
    B, S, H, K, hd = 1, 64, 4, 2, 16
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, 1, H, hd), (B, S, K, hd), (B, S, K, hd)))
    mesh = make_host_mesh(*shape, device="cpu")
    want = tattn.cp_decode_attention(q, kc, vc, cache_len=49, window=window,
                                     mesh=mesh)
    spec = (None, "data", None, "model")
    pk, pv = (placement.place(c, spec, mesh) for c in (kc, vc))
    sent = dict(mesh.sent)
    got = tattn.cp_decode_attention(q, pk, pv, cache_len=49, window=window,
                                    mesh=mesh)
    assert torch.equal(got, want)
    P, G = shape[0], H // K
    # q (f32) and the length out; maxima in, the max out; sums and
    # accumulators in: to and from the P - 1 other data shards
    want_bytes = (P - 1) * (B * H * hd * 4 + B * 8 + 2 * B * K * G * 4
                            + B * K * G * 4 + B * K * G * hd * 4)
    assert mesh.sent["softmax"] - sent.get("softmax", 0) == want_bytes
    # on 4 x 2 each data shard assembles its (S / P, hd) slab from its
    # two model shards' halves on its card
    assert mesh.sent["cache"] == (0 if shape[1] == 1 else
                                  2 * P * B * (S // P) * K * hd * 4)


def _zamba2_cache(cfg, S, fill):
    cache = ttf.init_cache(cfg, 1, S, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for n in ("k", "v"):
        cache[n][:, :, :fill] = torch.randn(cache[n][:, :, :fill].shape,
                                            generator=gen)
    for t in (*cache["mamba"], *cache["tail"]):
        t.copy_(torch.randn(t.shape, generator=gen))
    return cache


def _replicas_equal(tree):
    for x in placement._leaves(tree):
        home = {}
        for blk, rng in zip(x.blocks, x.ranges):
            assert torch.equal(blk, home.setdefault(rng, blk)), x


@pytest.mark.parametrize("n_layers", [2, 5])
def test_zamba2_decode_on_a_placed_4x1_mesh(n_layers, monkeypatch):
    """zamba2 reduced in f32 (5 layers: two super-blocks and a tail),
    B=1 under cp_decode: params placed by ``param_specs`` (FSDP over
    ``data``), the cache by ``cache_specs`` (k and v's sequence over
    ``data``; the SSM conv and state replicated, as "mamba" and "tail"
    name them).  Three steps from cache_len S - 4: the logits and every
    cache entry within 2e-5 of no mesh, the new k and v entries written
    into the last block, each replicated state equal to the home's."""
    cfg = dataclasses.replace(_f32("zamba2-7b"), n_layers=n_layers)
    params = ttf.init_params(cfg, 0, device="cpu")
    S = 32
    want = _zamba2_cache(cfg, S, S - 4)
    mesh = make_host_mesh(4, 1, device="cpu")
    shape = tconfigs.InputShape("decode", S, 1, "decode")
    placed = placement.place_tree(_zamba2_cache(cfg, S, S - 4),
                                  tspecs.cache_specs(cfg, want, mesh, shape),
                                  mesh)
    pparams = placement.place_module(params, tspecs.param_specs(
        cfg, params, mesh), mesh)
    assert placed["k"].spec[2] == "data" and placed["mamba"].state.spec == (
        None,) * 6
    monkeypatch.setenv("REPRO_TUNING", "cp_decode")
    calls = []
    real = ttf.cp_decode_attention
    for t in range(3):
        batch = {"token": torch.tensor([[5 + t]]), "pos": S - 4 + t}
        lw, _ = ttf.decode_step(cfg, params, want, batch)
        with sharding_context(mesh), mock.patch.object(
                ttf, "cp_decode_attention", side_effect=lambda *a, **k:
                calls.append(1) or real(*a, **k)):
            lg, _ = ttf.decode_step(cfg, pparams, placed, batch)
        np.testing.assert_allclose(lg.numpy(), lw.numpy(), atol=2e-5)
        _replicas_equal(placed)
    assert len(calls) == 3 * ttf._hybrid_layout(cfg)[0]
    got = placement.gather_tree(placed)
    for n, a in tm_leaves(got):
        np.testing.assert_allclose(a.numpy(), dict(tm_leaves(want))[n]
                                   .numpy(), atol=2e-5, err_msg=n)
    last = placed["k"].blocks[-1]       # positions [24, 32): S - 4 ... S - 2
    assert bool((last[:, 0, 4:7] != 0).all())
    assert mesh.sent["entries"] > 0 and "params" in mesh.sent


def test_zamba2_decode_past_the_cache_rewrites_the_last_block(
        monkeypatch):
    """The clamp on a placed cache: zamba2 reduced (2 layers) in f32 on a
    4 x 1 mesh under cp_decode, steps at pos S - 2, S - 1, S and S + 3
    (the last two rewrite entry S - 1, as ``lax.dynamic_update_slice``
    clamps): the logits and every cache entry within 2e-5 of no mesh,
    the blocks before the last one untouched."""
    cfg = dataclasses.replace(_f32("zamba2-7b"), n_layers=2)
    params = ttf.init_params(cfg, 0, device="cpu")
    S = 32
    want = _zamba2_cache(cfg, S, S - 2)
    mesh = make_host_mesh(4, 1, device="cpu")
    shape = tconfigs.InputShape("decode", S, 1, "decode")
    placed = placement.place_tree(_zamba2_cache(cfg, S, S - 2),
                                  tspecs.cache_specs(cfg, want, mesh, shape),
                                  mesh)
    before = [b.clone() for b in placed["k"].blocks[:-1]]
    pparams = placement.place_module(params, tspecs.param_specs(
        cfg, params, mesh), mesh)
    monkeypatch.setenv("REPRO_TUNING", "cp_decode")
    for t, pos in enumerate((S - 2, S - 1, S, S + 3)):
        batch = {"token": torch.tensor([[5 + t]]), "pos": pos}
        lw, _ = ttf.decode_step(cfg, params, want, batch)
        with sharding_context(mesh):
            lg, _ = ttf.decode_step(cfg, pparams, placed, batch)
        np.testing.assert_allclose(lg.numpy(), lw.numpy(), atol=2e-5,
                                   err_msg=str(pos))
        last = placed["k"].blocks[-1][:, 0, -1]
        np.testing.assert_allclose(last.numpy(), want["k"][:, 0, S - 1]
                                   .numpy(), atol=2e-5, err_msg=str(pos))
    got = placement.gather_tree(placed)
    for n, a in tm_leaves(got):
        np.testing.assert_allclose(a.numpy(), dict(tm_leaves(want))[n]
                                   .numpy(), atol=2e-5, err_msg=n)
    for b, a in zip(placed["k"].blocks[:-1], before):
        assert torch.equal(b, a)


def tm_leaves(cache):
    for n, v in cache.items():
        if isinstance(v, tuple):
            yield from ((f"{n}.{f}", getattr(v, f)) for f in v._fields)
        else:
            yield n, v


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_deepseek_prefill_under_moe_ep_on_placed_params(shape, monkeypatch):
    """deepseek-v2 reduced in f32, capacity factor 64, prefill of 2 x 12
    under moe_ep on placed params: logits and cache within 1e-4 of no
    mesh, and bitwise the same mesh's path on plain params.  Only tokens
    go out and partial outputs come back; the experts' blocks stay on
    their cards on 1 x 4 (on 2 x 2 each data shard gathers its model
    shard's experts over ``data``, their FSDP dim, as JAX's shard_map
    in_specs do)."""
    _, cfg = _moe_cfgs(64.0)
    params = ttf.init_params(cfg, 0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    want, wcache = tserve.prefill_step(cfg, params, {"tokens": tok},
                                       attn_backend="ref")
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    with sharding_context(make_host_mesh(*shape, device="cpu")):
        plain, _ = tserve.prefill_step(cfg, params, {"tokens": tok},
                                       attn_backend="ref")
    mesh = make_host_mesh(*shape, device="cpu")
    placed = placement.place_module(params, tspecs.param_specs(
        cfg, params, mesh), mesh)
    mesh.sent.clear()
    with sharding_context(mesh):
        got, cache = tserve.prefill_step(cfg, placed, {"tokens": tok},
                                         attn_backend="ref")
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    for n in wcache:
        np.testing.assert_allclose(cache[n].numpy(), wcache[n].numpy(),
                                   atol=1e-4, err_msg=n)
    P, M = shape
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    T_loc, D = 2 * 12 // P, cfg.d_model
    # tokens out to every shard but the home's; partials back to each data
    # shard's first card, and each data shard's sum and aux loss home
    assert mesh.sent["tokens"] == n_moe * (P * M - 1) * T_loc * D * 4
    assert mesh.sent["partials"] == n_moe * (
        P * (M - 1) * T_loc * D * 4 + (P - 1) * (T_loc * D * 4 + 4))
    if P == 1:
        assert mesh.sent["experts"] == 0


def test_checkpoint_from_a_2x2_run_restores_on_4x1_and_without_a_mesh(
        tmp_path):
    cfg = _f32("smollm-360m")
    path = tmp_path / "ck.npz"
    params, _ = tlaunch.run("smollm-360m", steps=2, batch=2, seq=16,
                            log_every=10, device="cpu", cfg=cfg,
                            mesh=make_host_mesh(2, 2, device="cpu"),
                            checkpoint_path=path)
    final = placement.gather_tree(params)
    plain = ttf.init_params(cfg, 1, device="cpu")
    opt = toptim.init_opt_state(plain, toptim.AdamWConfig())
    plain, opt, step = tckpt.restore_checkpoint(path, plain, opt, cfg=cfg)
    assert step == 2 and int(opt.step) == 2
    mesh = make_host_mesh(4, 1, device="cpu")
    again = ttf.init_params(cfg, 2, device="cpu")
    popt = toptim.init_opt_state(again, toptim.AdamWConfig())
    placed, popt, _ = tckpt.restore_checkpoint(path, again, popt, cfg=cfg,
                                               mesh=mesh)
    assert placement.has_placed(placed)
    gathered = placement.gather_tree(placed)
    for (n, a), (_, b), (_, c) in zip(final.named_parameters(),
                                      plain.named_parameters(),
                                      gathered.named_parameters()):
        assert torch.equal(a, b) and torch.equal(b, c), n
    for n in opt.m:
        assert torch.equal(placement.gather(popt.m[n]), opt.m[n]), n
        assert torch.equal(placement.gather(popt.v[n]), opt.v[n]), n
    assert int(placement.gather(popt.step)) == 2


@pytest.mark.parametrize("value", ["", "moe_ep", "cp_decode,serve_tp",
                                   "autotune", ",mla_cache_seq,,moe_ep"])
def test_tuning_flags_agree_with_jax(value, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING", value)
    assert ttuning.flags() == jtuning.flags()
    for name in ("serve_tp", "gqa_cache_seq", "mla_cache_seq", "moe_ep",
                 "cp_decode", "autotune", ""):
        assert ttuning.on(name) == jtuning.on(name), name
    assert ttuning.autotune_forced() == jtuning.autotune_forced()
