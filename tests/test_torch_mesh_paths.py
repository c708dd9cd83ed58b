"""The mesh paths on a mesh whose shards share the CPU, against the
port's baselines and the JAX package's: ``moe_block``'s expert-parallel
path (``tuning.on("moe_ep")``) and ``cp_decode_attention`` (the
sequence-parallel decode of ``tuning.on("cp_decode")``), as
``tests/helpers/tuned_check.py`` holds JAX's (deepseek-v2 reduced in f32
at capacity factor 64 on a 4 x 2 mesh, within 1e-4; B=1, S=64, H=4, K=2,
hd=16 at cache_len 49 on 8 x 1, plain and with window 7, within 2e-5);
the decode step under ``cp_decode``; ``launch.train.run`` on one-device
meshes; and the refusal of a mesh over several cards."""
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


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_train_run_on_a_one_device_mesh_equals_no_mesh(shape):
    kw = dict(steps=3, batch=2, seq=16, log_every=10, device="cpu")
    _, want = tlaunch.run("smollm-360m", **kw)
    seen = []
    real = tlaunch.train_step

    def step(*a, **k):
        seen.append(current_mesh())
        return real(*a, **k)

    mesh = make_host_mesh(*shape, device="cpu")
    with mock.patch.object(tlaunch, "train_step", side_effect=step):
        _, got = tlaunch.run("smollm-360m", mesh=mesh, **kw)
    assert got == want
    assert seen == [mesh] * 3 and current_mesh() is None


def test_train_run_with_moe_ep_on_a_one_device_mesh(monkeypatch):
    """deepseek-v2 reduced in f32 trains through the expert-parallel MoE
    (its backward through the experts' views) on a 1 x 2 mesh within
    1e-5 of the baseline (the tokens stay whole: the same capacity and
    aux loss)."""
    cfg = dataclasses.replace(
        tconfigs.get_config("deepseek-v2-236b").reduced(), dtype="float32")
    kw = dict(steps=2, batch=2, seq=16, log_every=10, device="cpu", cfg=cfg)
    _, want = tlaunch.run("deepseek-v2-236b", **kw)
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    _, got = tlaunch.run("deepseek-v2-236b",
                         mesh=make_host_mesh(1, 2, device="cpu"), **kw)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_a_mesh_over_several_devices_raises(monkeypatch):
    for mesh in (Mesh(2, 1, TWO_CARDS), make_production_mesh()):
        with pytest.raises(NotImplementedError, match="item 19"):
            tattn.cp_decode_attention(torch.zeros((1, 1, 4, 16)),
                                      torch.zeros((1, 32, 2, 16)),
                                      torch.zeros((1, 32, 2, 16)),
                                      cache_len=5, mesh=mesh)
        with pytest.raises(NotImplementedError, match="item 19"):
            tlaunch.run("smollm-360m", steps=1, mesh=mesh, device="cpu")
    jc, tc = _moe_cfgs(64.0)
    _, tp, _ = _moe_inputs(jc, 1, 1)
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    with sharding_context(Mesh(1, 2, TWO_CARDS)):
        with pytest.raises(NotImplementedError, match="item 19"):
            tmoe.moe_block(torch.zeros((1, 4, tc.d_model)), tp, tc)
    with pytest.raises(ValueError, match="holds cuda"):
        tattn.cp_decode_attention(
            torch.zeros((1, 1, 4, 16)), torch.zeros((1, 32, 2, 16)),
            torch.zeros((1, 32, 2, 16)), cache_len=5,
            mesh=Mesh(1, 1, TWO_CARDS[:1]))
    assert isinstance(make_production_mesh(multi_pod=True), AbstractMesh)


@pytest.mark.parametrize("value", ["", "moe_ep", "cp_decode,serve_tp",
                                   "autotune", ",mla_cache_seq,,moe_ep"])
def test_tuning_flags_agree_with_jax(value, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING", value)
    assert ttuning.flags() == jtuning.flags()
    for name in ("serve_tp", "gqa_cache_seq", "mla_cache_seq", "moe_ep",
                 "cp_decode", "autotune", ""):
        assert ttuning.on(name) == jtuning.on(name), name
    assert ttuning.autotune_forced() == jtuning.autotune_forced()
