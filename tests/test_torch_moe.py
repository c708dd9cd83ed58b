"""The port's MoE (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe``: ``moe_block`` with nothing dropped and with
capacity drops (out and the aux loss), the per-token dense oracle of
``tests/test_moe.py``, top-k's tie rule, the combine's add order, and
the params' shapes.  Params are JAX's, carried over as numpy; inputs come
from numpy seeds.

Tolerances.  f32: the expert FFN is three matmuls summed in another
order than XLA's, and the router's f32 softmax agrees to an ulp, so
atol 1e-5, rtol 1e-4 (the aux loss: 1e-6).  bf16: both packages round
every product and the combine's adds to bf16 at the same points; one
bf16 ulp is 2^-8 relative, so atol 2e-2, rtol 2e-2 as
``tests/test_torch_transformer.py``'s bf16 rows."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
MOE = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]


def _cfgs(arch, dtype="float32", top_k=None, capacity=None):
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = dataclasses.replace(mod.get_config(arch).reduced(),
                                  dtype=dtype)
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, top_k=top_k or m.top_k,
            capacity_factor=capacity or m.capacity_factor))
        out.append(cfg)
    return out


def _params(jc, dtype, seed=0):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), jc,
                              getattr(jnp, dtype))
    return jp, _torch_moe(jp)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _torch_moe(jp):
    return tmoe.MoE(**{k: _t(v) for k, v in jp.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _x(shape, dtype, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity", [64.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(arch, capacity, dtype):
    """Out and aux against JAX, with nothing dropped (capacity 64) and
    with drops (0.5)."""
    jc, tc = _cfgs(arch, dtype, capacity=capacity)
    jp, tp = _params(jc, dtype, seed=1)
    xj, xt = _x((2, 16, jc.d_model), dtype, seed=2)
    want, want_aux = jmoe.moe_block(xj, jp, jc)
    got, aux = tmoe.moe_block(xt, tp, tc)
    assert got.dtype == getattr(torch, dtype) and got.shape == xt.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)
    T, m = 32, tc.moe
    C = tmoe._capacity(T, m.n_experts, m.top_k, capacity)
    assert C == jmoe._capacity(T, m.n_experts, m.top_k, capacity)
    r = tmoe.route(xt.reshape(T, -1), tp.router, m.n_experts, m.top_k, C)
    dropped = int((~r.keep).sum())
    assert (dropped == 0) == (capacity == 64.0)


def dense_oracle(x, p, cfg):
    """tests/test_moe.py's oracle: every token through its top-k experts,
    no capacity, in f64 (numpy)."""
    m = cfg.moe
    flat = np.asarray(x, np.float64).reshape(-1, cfg.d_model)
    w = {k: np.asarray(v, np.float64) for k, v in p.items()}
    logits = flat @ w["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(flat)
    for t in range(flat.shape[0]):
        top = np.argsort(-probs[t])[:m.top_k]
        gates = probs[t][top] / probs[t][top].sum()
        for e, g in zip(top, gates):
            h = flat[t] @ w["w_gate"][e]
            h = h / (1 + np.exp(-h)) * (flat[t] @ w["w_up"][e])
            out[t] += g * (h @ w["w_down"][e])
    if m.n_shared_experts:
        g = flat @ w["shared_w_gate"]
        out += (g / (1 + np.exp(-g)) * (flat @ w["shared_w_up"])) @ w[
            "shared_w_down"]
    return out.reshape(np.shape(x))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_matches_dense_oracle(top_k):
    jc, tc = _cfgs("deepseek-v2-236b", top_k=top_k, capacity=64.0)
    jp, tp = _params(jc, "float32")
    xj, xt = _x((2, 8, jc.d_model), "float32", seed=3, scale=0.5)
    got, aux = tmoe.moe_block(xt, tp, tc)
    np.testing.assert_allclose(got.double().numpy(),
                               dense_oracle(xj, jp, jc), atol=1e-4,
                               rtol=1e-3)
    assert np.isfinite(float(aux))


def test_moe_capacity_drops_are_partial():
    """tests/test_moe.py's drop test: with capacity 0.5 some slots drop,
    the output stays finite and nonzero (the shared expert covers every
    token), and a dropped slot adds nothing."""
    jc, tc = _cfgs("deepseek-v2-236b", capacity=0.5)
    _, tp = _params(jc, "float32")
    _, xt = _x((2, 16, tc.d_model), "float32", seed=4)
    out, aux = tmoe.moe_block(xt, tp, tc)
    assert bool(torch.isfinite(out).all()) and float(out.abs().sum()) > 0
    m = tc.moe
    T = 32
    C = tmoe._capacity(T, m.n_experts, m.top_k, 0.5)
    r = tmoe.route(xt.reshape(T, -1), tp.router, m.n_experts, m.top_k, C)
    assert 0 < int((~r.keep).sum()) < T * m.top_k
    assert bool((r.gate[~r.keep] == 0).all())
    assert bool((r.slot[~r.keep] == m.n_experts * C).all())
    # each expert keeps its first C slots in token order
    for e in range(m.n_experts):
        toks = r.tok[(r.slot // C == e) & r.keep]
        assert len(toks) <= C
        assert bool((toks[1:] >= toks[:-1]).all())


def test_top_k_takes_ties_toward_the_lower_expert_like_jax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    _, jexp = jax.lax.top_k(jnp.asarray(probs), 2)
    _, texp = torch.sort(torch.from_numpy(probs), dim=-1, descending=True,
                         stable=True)
    np.testing.assert_array_equal(texp[:, :2].numpy(), np.asarray(jexp))
    # and route() itself on logits that tie exactly
    flat = torch.zeros((3, 4))
    r = tmoe.route(flat, torch.zeros((4, 4)), 4, 2, 8)
    np.testing.assert_array_equal(r.expert.numpy(), [[0, 1]] * 3)


def test_combine_adds_in_ascending_expert_id_like_xla_bitwise():
    """The combine against JAX's scatter-add ``.at[ts].add`` on the same
    rows, in bf16, bitwise: a token's K rows are added from zero in
    ascending expert id, rounding to bf16 after each add."""
    rng = np.random.default_rng(7)
    T, E, K, C, D = 24, 6, 3, 16, 32
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((D, E)).astype(
        np.float32))
    r = tmoe.route(x, router, E, K, C)
    out_buf = torch.from_numpy(rng.standard_normal((E, C, D)).astype(
        np.float32) * 3).to(torch.bfloat16)
    got = tmoe.combine(out_buf, r)
    ob = jnp.asarray(np.asarray(out_buf.float()), jnp.bfloat16)
    out_flat = jnp.concatenate([ob.reshape(E * C, D),
                                jnp.zeros((1, D), jnp.bfloat16)])
    gathered = out_flat[r.slot.numpy()] * jnp.asarray(
        r.gate.numpy())[:, None].astype(jnp.bfloat16)
    want = jnp.zeros((T, D), jnp.bfloat16).at[r.tok.numpy()].add(gathered)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_dispatch_buffer_matches_jax():
    jc, tc = _cfgs("llama4-maverick-400b-a17b", capacity=0.5)
    m = tc.moe
    _, xt = _x((32, tc.d_model), "float32", seed=8)
    router = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (tc.d_model, m.n_experts)).astype(np.float32))
    C = tmoe._capacity(32, m.n_experts, m.top_k, 0.5)
    r = tmoe.route(xt, router, m.n_experts, m.top_k, C)
    buf = tmoe.dispatch(xt, r, m.n_experts, C)
    # the JAX package's dispatch on the same routing
    eflat = jnp.asarray(r.expert.numpy().reshape(-1))
    order = jnp.argsort(eflat)
    es = eflat[order]
    ts = jnp.arange(32 * m.top_k)[order] // m.top_k
    starts = jnp.searchsorted(es, jnp.arange(m.n_experts))
    pos = jnp.arange(32 * m.top_k) - starts[es]
    keep = pos < C
    slot = jnp.where(keep, es * C + pos, m.n_experts * C)
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(r.tok.numpy(), np.asarray(ts))
    flat = jnp.asarray(xt.numpy())
    want = jnp.zeros((m.n_experts * C + 1, tc.d_model)).at[slot].set(
        flat[ts] * keep[:, None])
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(want[:-1]).reshape(m.n_experts, C, -1))


@pytest.mark.parametrize("arch", MOE)
def test_init_moe_params_draws_the_jax_shapes(arch):
    jc, tc = _cfgs(arch, "bfloat16")
    want = jax.eval_shape(lambda: jmoe.init_moe_params(
        jax.random.PRNGKey(0), jc, jnp.bfloat16))
    gen = torch.Generator().manual_seed(3)
    p = tmoe.init_moe_params(gen, tc, torch.bfloat16)
    names = {n for n, _ in p.named_parameters()}
    assert names == set(want)
    for n, t in p.named_parameters():
        assert tuple(t.shape) == want[n].shape, n
        assert t.dtype == (torch.float32 if n == "router"
                           else torch.bfloat16)
    assert float(p.w_up.float().std()) == pytest.approx(0.02, rel=0.1)
    again = tmoe.init_moe_params(torch.Generator().manual_seed(3), tc,
                                 torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                  again.parameters()))
