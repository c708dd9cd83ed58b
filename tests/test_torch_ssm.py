"""The port's Mamba-2 SSD (``repro_torch.models.ssm``) and the ssm family
(mamba2-1.3b) against the JAX package: ``ssd_chunked`` against the naive
recurrence (tests/test_ssm.py's oracle) and against ``repro``'s, the
block's prefill and decode, the cache shapes, the model's prefill with
its cache, decode against teacher forcing and at ragged slots, and the
serving engine token for token.  Every parameter is drawn from a numpy
seed at a non-trivial value (``helpers/torch_parity.py``); configs are
``reduced()``."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent / "helpers"))
from torch_parity import (TOL, assert_tree_close, configs,  # noqa: E402
                          random_params, to_np)

ARCH = "mamba2-1.3b"


def naive_ssd(x, dt, A, B_, C_):
    """Token-by-token linear recurrence oracle, in f64 (tests/test_ssm.py)."""
    Bsz, S, H, P = x.shape
    N = B_.shape[3]
    rep = H // B_.shape[2]
    state = np.zeros((Bsz, H, N, P), np.float64)
    y = np.zeros((Bsz, S, H, P), np.float64)
    Bf = np.repeat(np.asarray(B_, np.float64), rep, axis=2)
    Cf = np.repeat(np.asarray(C_, np.float64), rep, axis=2)
    for t in range(S):
        dA = np.exp(dt[:, t] * A)
        upd = np.einsum("bhn,bhp->bhnp", Bf[:, t] * dt[:, t][..., None],
                        x[:, t])
        state = state * dA[..., None, None] + upd
        y[:, t] = np.einsum("bhn,bhnp->bhp", Cf[:, t], state)
    return y, state


def _ssd_inputs(S, seed=0, Bsz=2, H=4, P=8, G=1, N=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bsz, S, H, P)).astype(np.float32),
            (rng.random((Bsz, S, H)) * 0.5 + 0.1).astype(np.float32),
            -(rng.random(H) + 0.5).astype(np.float32),
            rng.standard_normal((Bsz, S, G, N)).astype(np.float32),
            rng.standard_normal((Bsz, S, G, N)).astype(np.float32))


@pytest.mark.parametrize("S,chunk", [(32, 8), (48, 16), (16, 16), (40, 16)])
def test_ssd_chunked_vs_naive(S, chunk):
    """The chunked scan against the recurrence; S = 40 at chunk 16 is
    ragged (padded with dt = 0 steps)."""
    args = _ssd_inputs(S)
    y, final = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    y_ref, final_ref = naive_ssd(*[a.astype(np.float64) for a in args])
    assert y.dtype == torch.float32 and final.dtype == torch.float32
    np.testing.assert_allclose(y.double().numpy(), y_ref, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(final.double().numpy(), final_ref, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(48, 16), (40, 16)])
def test_ssd_chunked_matches_jax(S, chunk, dtype):
    """y (in x's dtype) and the f32 final state against ``repro``'s."""
    x, dt, A, B_, C_ = _ssd_inputs(S, seed=1, H=8, G=2)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, jfinal = jssm.ssd_chunked(jx, *map(jnp.asarray, (dt, A, B_, C_)),
                                  chunk)
    ty, tfinal = tssm.ssd_chunked(tx, *map(torch.from_numpy, (dt, A, B_, C_)),
                                  chunk)
    assert ty.dtype == tx.dtype and tfinal.dtype == torch.float32
    np.testing.assert_allclose(to_np(ty), to_np(jy), **TOL[dtype])
    np.testing.assert_allclose(to_np(tfinal), to_np(jfinal),
                               **TOL["float32"])


def _block(dtype, seed=0):
    """One Mamba-2 block's params (``repro``'s shapes, every leaf drawn),
    for both packages, and inputs (B, S + 1, D)."""
    jc, tc = configs(jconfigs, tconfigs, ARCH, dtype)
    shapes = jssm.init_ssm_params(jax.random.PRNGKey(0), jc,
                                  jnp.dtype(jc.dtype))
    jp, tree = random_params(shapes, seed)
    tp = tssm.SSM(**{k: torch.tensor(np.asarray(v, np.float32)).to(
        getattr(torch, str(v.dtype))) for k, v in tree.items()})
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 17, jc.d_model)).astype(np.float32) * 0.5
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jc, tc, jp, tp, jx, torch.from_numpy(x).to(getattr(torch, dtype))


def test_block_params_are_drawn_non_zero():
    _, _, _, tp, _, _ = _block("float32")
    for name, t in tp.named_parameters():
        assert float(t.abs().min()) > 0.0, name


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_jax(dtype, return_state):
    """The output and the cache (the last conv inputs, the f32 state)."""
    jc, tc, jp, tp, jx, tx = _block(dtype)
    want = jssm.mamba2_block(jx, jp, jc, return_state=return_state)
    got = tssm.mamba2_block(tx, tp, tc, return_state=return_state)
    if return_state:
        (want, jcache), (got, tcache) = want, got
        assert_tree_close(tcache, jcache, TOL[dtype], "cache")
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_jax(dtype):
    """Three decode steps from the prefill's cache: outputs and the new
    cache (conv window in the model dtype, state in f32)."""
    jc, tc, jp, tp, jx, tx = _block(dtype, seed=3)
    _, jcache = jssm.mamba2_block(jx[:, :14], jp, jc, return_state=True)
    _, tcache = tssm.mamba2_block(tx[:, :14], tp, tc, return_state=True)
    for t in range(14, 17):
        jo, jcache = jssm.mamba2_decode(jx[:, t:t + 1], jp, jc, jcache)
        to, tcache = tssm.mamba2_decode(tx[:, t:t + 1], tp, tc, tcache)
        np.testing.assert_allclose(to_np(to), to_np(jo), **TOL[dtype])
        assert_tree_close(tcache, jcache, TOL[dtype], f"step {t}")


def test_block_decode_continues_prefill():
    """Prefill S tokens with their state, decode token S: equal to the
    full S + 1 prefill (tests/test_ssm.py)."""
    _, tc, _, tp, _, tx = _block("float32", seed=5)
    S = 16
    full = tssm.mamba2_block(tx, tp, tc)
    out_pre, cache = tssm.mamba2_block(tx[:, :S], tp, tc, return_state=True)
    np.testing.assert_allclose(to_np(out_pre), to_np(full[:, :S]),
                               atol=1e-4, rtol=1e-4)
    out_dec, _ = tssm.mamba2_decode(tx[:, S:S + 1], tp, tc, cache)
    np.testing.assert_allclose(to_np(out_dec[:, 0]), to_np(full[:, S]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_shapes(dtype):
    jc, tc = configs(jconfigs, tconfigs, ARCH, dtype)
    want = jssm.init_ssm_cache(3, jc, jnp.dtype(dtype))
    got = tssm.init_ssm_cache(3, tc, getattr(torch, dtype), device="cpu")
    s = tc.ssm
    assert got.conv.shape == (3, s.d_conv - 1,
                              s.d_inner + 2 * s.n_groups * s.d_state)
    assert got.state.shape == (3, s.n_heads, s.d_state, s.head_dim)
    assert_tree_close(got, want, TOL[dtype], "init_ssm_cache")
    jm = jtf.init_cache(jc, 3, 8)
    tm = ttf.init_cache(tc, 3, 8, device="cpu")
    assert_tree_close(tm, jm, TOL[dtype], "init_cache")
    assert tm["ssm"].state.dtype == torch.float32


# ----------------------------------------------------------------------
# the model: mamba2-1.3b reduced
# ----------------------------------------------------------------------

def _model(dtype="float32", seed=0):
    jc, tc = configs(jconfigs, tconfigs, ARCH, dtype)
    jp, tree = random_params(jtf.init_params(jc, jax.random.PRNGKey(0)),
                             seed)
    return jc, tc, jp, ttf.params_from_numpy(tc, tree, device="cpu")


def test_params_from_numpy_takes_every_leaf():
    jc, tc, jp, tp = _model("bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    n = sum(np.asarray(a).size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in tp.parameters()) == n
    assert len(tp.blocks) == tc.n_layers
    for l, blk in enumerate(tp.blocks):
        for name in ("w_xz", "conv", "A_log", "dt_bias", "D_skip", "norm"):
            got = getattr(blk.ssm, name)
            want = tree["blocks"]["ssm"][name][l]
            assert str(got.dtype).split(".")[-1] == str(want.dtype), name
            np.testing.assert_array_equal(to_np(got), to_np(want))
            assert float(got.abs().min()) > 0.0, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_forward_and_cache_match_jax(dtype):
    """Logits, hidden states and the cache (conv and state) against
    ``repro.forward``; a ragged S = 40 over chunks of 16."""
    jc, tc, jp, tp = _model(dtype, seed=2)
    tokens = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 40))
    want, jaux, jcache = jtf.forward(jc, jp, {"tokens": jnp.asarray(tokens)},
                                     mode="prefill", return_cache=True,
                                     remat=False)
    kops.reset_launch_counts()
    got, aux, cache = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)},
                                  return_cache=True)
    assert kops.launch_counts()["flash_attention"] == 0
    assert float(aux) == 0.0 and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])
    assert_tree_close(cache, jcache, TOL[dtype], "cache")
    assert cache["ssm"].state.dtype == torch.float32


def test_decode_matches_teacher_forcing():
    """tests/test_models_smoke.py's ssm row: step-by-step decode logits
    equal the full forward's at the same positions (that test's
    tolerance), and the full forward equals JAX's."""
    jc, tc, jp, tp = _model(seed=1)
    B, S = 2, 12
    tokens = np.random.default_rng(7).integers(0, tc.vocab_size, (B, S))
    full, _ = ttf.forward(tc, tp, {"tokens": torch.from_numpy(tokens)})
    cache = ttf.init_cache(tc, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = ttf.decode_step(tc, tp, cache, {
            "token": torch.from_numpy(tokens[:, t:t + 1]), "pos": t})
        outs.append(to_np(lg)[:, 0])
    np.testing.assert_allclose(np.stack(outs, axis=1), to_np(full),
                               atol=2e-3, rtol=2e-3)
    want, _ = jtf.forward(jc, jp, {"tokens": jnp.asarray(tokens)},
                          mode="prefill", remat=False)
    np.testing.assert_allclose(to_np(full), to_np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax_with_ragged_slots(dtype):
    """Six decode steps with a (B,) ``pos`` (slots at different
    positions; the recurrence ignores it) from a prefilled cache: logits
    and the cache, written in place, against JAX's."""
    jc, tc, jp, tp = _model(dtype, seed=4)
    rng = np.random.default_rng(6)
    B = 3
    prompt = rng.integers(0, tc.vocab_size, (B, 9))
    _, _, jcache = jtf.forward(jc, jp, {"tokens": jnp.asarray(prompt)},
                               mode="prefill", return_cache=True, remat=False)
    _, _, tcache = ttf.forward(tc, tp, {"tokens": torch.from_numpy(prompt)},
                               return_cache=True)
    state = tcache["ssm"].state
    start = np.array([9, 2, 30])
    for t in range(6):
        tok = rng.integers(0, tc.vocab_size, (B, 1))
        pos = (start + t).astype(np.int32)
        jl, jcache = jtf.decode_step(jc, jp, jcache, {
            "token": jnp.asarray(tok, jnp.int32), "pos": jnp.asarray(pos)})
        tl, tcache = ttf.decode_step(tc, tp, tcache, {
            "token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(to_np(tl), to_np(jl), **TOL[dtype])
    assert tcache["ssm"].state is state          # written in place
    assert_tree_close(tcache, jcache, TOL[dtype], "cache")


def test_serve_engine_matches_jax_token_for_token():
    """6 requests over 2 slots (slots reused) through both engines:
    the same greedy tokens.  Admission replays a prompt through
    lock-step decode steps over every slot, so the other slots' SSM
    state advances on their pending token and a reused slot starts from
    its last request's state: a behaviour of the reference that the port
    mirrors (ROADMAP.md Queue 3)."""
    jc, tc, jp, tp = _model(seed=8)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tc.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 9, 6)]
    outs = []
    for Eng, Req, params, kw in (
            (JEngine, JRequest, jp, {}),
            (ServeEngine, Request, tp, {"device": "cpu"})):
        eng = Eng(tc if Eng is ServeEngine else jc, params, batch_slots=2,
                  max_seq=32, **kw)
        reqs = [Req(uid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[1] == outs[0]


def test_engine_slot_state_carries_over_like_the_reference():
    """The behaviour the test above inherits, shown on the cache: after a
    request served in a reused slot the slot's SSM state is not the state
    the same request leaves in a fresh engine (the first request's state
    carries over into the replay), in both packages alike."""
    jc, tc, jp, tp = _model(seed=8)
    rng = np.random.default_rng(10)
    first, second = (rng.integers(0, tc.vocab_size, 5).astype(np.int32)
                     for _ in range(2))

    def serve(Eng, Req, cfg, params, prompts, **kw):
        eng = Eng(cfg, params, batch_slots=1, max_seq=32, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Req(uid=i, prompt=p, max_new_tokens=3))
        eng.run()
        return eng.cache["ssm"]

    states = {}
    for name, prompts in (("alone", [second]), ("reused", [first, second])):
        want = serve(JEngine, JRequest, jc, jp, prompts)
        got = serve(ServeEngine, Request, tc, tp, prompts, device="cpu")
        assert_tree_close(got, want, TOL["float32"], name)
        states[name] = to_np(got.state)
    assert np.abs(states["reused"] - states["alone"]).max() > 1e-3


def test_launch_serve_runs_on_the_cpu():
    """``launch.serve.run`` serves the reduced mamba2 through the engine,
    with no kernel launch (the ssm family has no attention)."""
    kops.reset_launch_counts()
    reqs, stats = launch_serve.run(ARCH, n_requests=3, max_new=4,
                                   batch_slots=2, max_seq=32, device="cpu")
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert stats["tokens"] == 12
    assert set(kops.launch_counts().values()) == {0}
