"""The port's audio family (whisper-base: a LayerNorm encoder over the
stub frontend's frames, a decoder with causal self-attention and
non-causal cross-attention, biased attention, GELU MLPs) against the JAX
package: its layers (``layer_norm``, ``gelu_mlp``,
``sinusoidal_positions``), ``params_from_numpy``, the encoder, the
prefill's logits, hidden states and every cache entry (k, v, cross_k,
cross_v) over ragged frames (13 frames, against the 16-key blocks of
``reduced()``), decode against teacher forcing and at ragged slots
through both attention backends, and the serving layer's refusal.
Every parameter is drawn from a numpy seed at a non-trivial value
(``helpers/torch_parity.py``): the qkv and MLP biases are zero in the
JAX init."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.step import prefill_step  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
from torch_parity import (TOL, assert_tree_close, configs,  # noqa: E402
                          random_params, to_np)

ARCH = "whisper-base"
N_FRAMES = 13           # ragged against reduced()'s 16 frontend tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def pair(*shape, scale=1.0, loc=0.0):
        j = jnp.asarray(loc + rng.standard_normal(shape) * scale, jdt)
        return j, torch.tensor(to_np(j)).to(tdt)

    (xj, xt), (sj, st), (bj, bt) = (pair(2, 6, 64), pair(64, scale=0.1,
                                                         loc=1.0),
                                    pair(64, scale=0.1))
    got = tlayers.layer_norm(xt, st, bt)
    assert got.dtype == tdt
    np.testing.assert_allclose(to_np(got), to_np(jlayers.layer_norm(
        xj, sj, bj)), **TOL[dtype])
    (wi, wit), (bi, bit), (wo, wot), (bo, bot) = (
        pair(64, 96, scale=0.2), pair(96, scale=0.1), pair(96, 64, scale=0.2),
        pair(64, scale=0.1))
    np.testing.assert_allclose(
        to_np(tlayers.gelu_mlp(xt, wit, bit, wot, bot)),
        to_np(jlayers.gelu_mlp(xj, wi, bi, wo, bo)), **TOL[dtype])
    for n, d in ((16, 64), (1500, 512), (7, 10)):
        got = tlayers.sinusoidal_positions(n, d)
        assert got.dtype == torch.float32 and got.shape == (n, d)
        np.testing.assert_allclose(to_np(got), to_np(
            jlayers.sinusoidal_positions(n, d)), **TOL["float32"])
    # [sin | cos], not interleaved
    table = tlayers.sinusoidal_positions(3, 8).numpy()
    np.testing.assert_array_equal(table[0], [0, 0, 0, 0, 1, 1, 1, 1])


def test_gelu_is_the_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh form, ``F.gelu`` to erf:
    ``gelu_mlp`` with identity projections and no biases is the tanh
    gelu."""
    x = torch.linspace(-4, 4, 401)[None]
    want = to_np(jax.nn.gelu(jnp.asarray(x.numpy())))
    eye, zero = torch.eye(401), torch.zeros(401)
    np.testing.assert_allclose(
        to_np(tlayers.gelu_mlp(x, eye, zero, eye, zero)), want,
        **TOL["float32"])
    erf = to_np(torch.nn.functional.gelu(x))
    assert np.abs(erf - want).max() > 1e-4


def _model(dtype="float32", seed=0):
    jc, tc = configs(jconfigs, tconfigs, ARCH, dtype)
    jp, tree = random_params(jtf.init_params(jc, jax.random.PRNGKey(0)),
                             seed)
    return jc, tc, jp, tree, ttf.params_from_numpy(tc, tree, device="cpu")


def _batch(tc, dtype, B=2, S=10, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, N_FRAMES, tc.frontend_dim))
    tokens = rng.integers(0, tc.vocab_size, (B, S))
    jb = {"frames": jnp.asarray(frames, getattr(jnp, dtype)),
          "tokens": jnp.asarray(tokens)}
    tb = {"frames": torch.tensor(to_np(jb["frames"])).to(
        getattr(torch, dtype)), "tokens": torch.from_numpy(tokens)}
    return jb, tb


def test_params_from_numpy_takes_every_leaf():
    jc, tc, jp, tree, tp = _model("bfloat16")
    assert len(tp.enc_blocks) == tc.n_encoder_layers
    assert len(tp.dec_blocks) == tc.n_layers
    for name, t in tp.named_parameters():
        parts = name.split(".")
        leaf = tree[parts[0]]
        idx, keys = ((int(parts[1]), parts[2:]) if parts[0] in (
            "enc_blocks", "dec_blocks") else ((), parts[1:]))
        for k in keys:
            leaf = leaf[k]
        np.testing.assert_array_equal(to_np(t), to_np(np.asarray(leaf)[idx]),
                                      err_msg=name)
        assert float(t.abs().min()) > 0.0, name
    n = sum(np.asarray(a).size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in tp.parameters()) == n
    assert tp.projector.shape == (tc.frontend_dim, tc.d_model)
    assert tp.dec_blocks[0].cross_attn.bq is not None
    with pytest.raises(ValueError, match="keys"):
        ttf.params_from_numpy(tc, {k: v for k, v in tree.items()
                                   if k != "projector"}, device="cpu")


def test_init_params_draws_the_jax_shapes_from_a_seed():
    jc, tc = configs(jconfigs, tconfigs, ARCH, "bfloat16")
    shapes = jax.eval_shape(lambda: jtf.init_params(jc,
                                                    jax.random.PRNGKey(0)))
    a = ttf.init_params(tc, 1, device="cpu")
    b = ttf.init_params(tc, 1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in a.parameters()) == n
    assert tuple(a.projector.shape) == shapes["projector"].shape
    assert float(a.dec_blocks[0].ln1.scale.min()) == 1.0
    assert float(a.enc_blocks[0].attn.bq.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    jc, tc, jp, _, tp = _model(dtype, seed=1)
    jb, tb = _batch(tc, dtype)
    want = jtf.encode_audio(jc, jp, jb["frames"])
    got = ttf.encode_audio(tc, tp, tb["frames"])
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, N_FRAMES, tc.d_model)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_forward_and_cache_match_jax(dtype):
    """Logits, hidden states and every cache entry (self k, v over the
    tokens; cross k, v over the 13 frames) against ``repro.forward``; no
    flash launch on the CPU (the wrapper's plain version)."""
    jc, tc, jp, _, tp = _model(dtype, seed=2)
    jb, tb = _batch(tc, dtype)
    want, jaux, jcache = jtf.forward(jc, jp, jb, mode="prefill",
                                     return_cache=True, remat=False)
    kops.reset_launch_counts()
    got, aux, cache = ttf.forward(tc, tp, tb, return_cache=True)
    assert kops.launch_counts()["flash_attention"] == 0
    assert float(aux) == 0.0 and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])
    assert_tree_close(cache, jcache, TOL[dtype], "cache")
    assert cache["cross_k"].shape[2] == N_FRAMES
    hidden, _ = ttf.forward(tc, tp, tb, return_hidden=True,
                            attn_backend="ref")
    jh, _ = jtf.forward(jc, jp, jb, mode="prefill", return_hidden=True,
                        remat=False)
    np.testing.assert_allclose(to_np(hidden), to_np(jh), **TOL[dtype])


def test_prefill_step_takes_the_audio_batch():
    jc, tc, jp, _, tp = _model(seed=3)
    jb, tb = _batch(tc, "float32")
    logits, cache = prefill_step(tc, tp, tb)
    want, _ = jtf.forward(jc, jp, jb, mode="prefill", remat=False)
    assert logits.shape == (2, 1, tc.vocab_size)
    np.testing.assert_allclose(to_np(logits), to_np(want)[:, -1:],
                               **TOL["float32"])
    assert set(cache) == {"k", "v", "cross_k", "cross_v"}


def _prefilled_cache(tc, tp, tb, S):
    """init_cache for S decode positions, with the cross k, v of the
    encoder filled by a prefill of the first token."""
    cache = ttf.init_cache(tc, tb["tokens"].shape[0], S, enc_len=N_FRAMES,
                           device="cpu")
    _, _, pre = ttf.forward(tc, tp, {"frames": tb["frames"],
                                     "tokens": tb["tokens"][:, :1]},
                            return_cache=True)
    cache["cross_k"].copy_(pre["cross_k"])
    cache["cross_v"].copy_(pre["cross_v"])
    return cache


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_decode_matches_teacher_forcing(backend):
    """Step-by-step decode logits, the cross-attention through either
    backend (on the CPU both run the plain version), equal the full
    forward's at the same positions (tests/test_models_smoke.py's
    tolerance), which equals JAX's."""
    jc, tc, jp, _, tp = _model(seed=4)
    jb, tb = _batch(tc, "float32", S=12)
    S = tb["tokens"].shape[1]
    full, _ = ttf.forward(tc, tp, tb)
    cache = _prefilled_cache(tc, tp, tb, S)
    outs = []
    for t in range(S):
        lg, cache = ttf.decode_step(tc, tp, cache, {
            "token": tb["tokens"][:, t:t + 1], "pos": t},
            attn_backend=backend)
        outs.append(to_np(lg)[:, 0])
    np.testing.assert_allclose(np.stack(outs, axis=1), to_np(full),
                               atol=2e-3, rtol=2e-3)
    want, _ = jtf.forward(jc, jp, jb, mode="prefill", remat=False)
    np.testing.assert_allclose(to_np(full), to_np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax_with_ragged_slots(dtype):
    """Five decode steps with the slots at different positions (a (B,)
    ``pos``) against the same cross caches: logits every step and every
    cache entry (the cross ones read, never written) against JAX's."""
    jc, tc, jp, _, tp = _model(dtype, seed=5)
    jb, tb = _batch(tc, dtype, B=3, S=4)
    S = 24
    tcache = _prefilled_cache(tc, tp, tb, S)
    jcache = {**jtf.init_cache(jc, 3, S, enc_len=N_FRAMES),
              "cross_k": jnp.asarray(to_np(tcache["cross_k"]),
                                     getattr(jnp, dtype)),
              "cross_v": jnp.asarray(to_np(tcache["cross_v"]),
                                     getattr(jnp, dtype))}
    cross = tcache["cross_k"].clone()
    rng = np.random.default_rng(6)
    start = np.array([0, 3, 17])
    for t in range(5):
        tok = rng.integers(0, tc.vocab_size, (3, 1))
        pos = (start + t).astype(np.int32)
        jl, jcache = jtf.decode_step(jc, jp, jcache, {
            "token": jnp.asarray(tok, jnp.int32), "pos": jnp.asarray(pos)})
        tl, tcache = ttf.decode_step(tc, tp, tcache, {
            "token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL[dtype])
    assert torch.equal(tcache["cross_k"], cross)
    assert_tree_close(tcache, jcache, TOL[dtype], "cache")


def test_cache_shapes_match_jax():
    jc, tc = configs(jconfigs, tconfigs, ARCH, "bfloat16")
    for enc_len in (None, N_FRAMES):
        assert_tree_close(ttf.init_cache(tc, 3, 8, enc_len, device="cpu"),
                          jtf.init_cache(jc, 3, 8, enc_len),
                          TOL["bfloat16"], f"enc_len {enc_len}")


def test_backends_are_named_and_the_engine_refuses_audio():
    jc, tc, jp, _, tp = _model(seed=6)
    cache = ttf.init_cache(tc, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        ttf.decode_step(tc, tp, cache, {"token": torch.zeros(1, 1,
                                                             dtype=torch.long),
                                        "pos": 0}, attn_backend="triton")
    with pytest.raises(ValueError, match="text decoders"):
        ServeEngine(tc, tp, device="cpu")
    vlm = tconfigs.get_config("llava-next-34b").reduced()
    with pytest.raises(NotImplementedError, match="item 15"):
        ttf.init_params(vlm, 0, device="cpu")
