"""The port's MLA (``repro_torch.models.attention``: ``mla_prefill``,
``mla_decode``, ``mla_new_cache_entries``) against the JAX package's, and
the flash wrapper's CPU route with v's head dim unlike q's against
``flash_attention_jnp``.  Mirrors ``tests/test_attention.py:79-110``
(absorbed decode equals the prefill's last row; new cache entries equal
the prefill's).  Params are JAX's ``_init_mla``, carried over as numpy;
inputs come from numpy seeds; the config is deepseek-v2's ``reduced()``
(nope 32 + rope 16 = 48 against v 32).

Tolerances.  f32 against JAX: the same projections, norms and rotations
summed in another order, 1e-5 (prefill, cache entries) and 2e-5 (decode,
whose scores go through the latent space); absorbed decode against the
prefill: tests/test_attention.py's 3e-4.  bf16: atol 2e-2, rtol 2e-2, as
``tests/test_torch_transformer.py``'s bf16 rows."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _setup(dtype="float32", seed=0):
    jc, tc = (dataclasses.replace(m.get_config("deepseek-v2-236b").reduced(),
                                  dtype=dtype) for m in (jconfigs, tconfigs))
    jp = jtf._init_mla(jax.random.PRNGKey(seed), jc, getattr(jnp, dtype))
    tree = {k: np.asarray(v) for k, v in jp.items()}
    tp = ttf.MLA(**{k: ttf._from_numpy(v, "cpu") for k, v in tree.items()})
    return jc, tc, jp, tp


def _x(shape, dtype, seed, scale=0.3):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_jax(dtype):
    jc, tc, jp, tp = _setup(dtype)
    B, S = 2, 12
    xj, xt = _x((B, S, jc.d_model), dtype, seed=1)
    want = jattn.mla_prefill(xj, jp, jc, jnp.arange(S))
    got = tattn.mla_prefill(xt, tp, tc, torch.arange(S))
    a = tc.mla
    shapes = [(B, S, tc.d_model), (B, S, a.kv_lora_rank),
              (B, S, a.rope_head_dim)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape and g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_mla_prefill_backends_agree_on_the_cpu(backend):
    """Both attention backends run the plain version on CPU tensors."""
    _, tc, _, tp = _setup()
    _, xt = _x((1, 9, tc.d_model), "float32", seed=2)
    got = tattn.mla_prefill(xt, tp, tc, torch.arange(9), backend=backend)
    want = tattn.mla_prefill(xt, tp, tc, torch.arange(9), backend="ref")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax_at_ragged_lengths(dtype):
    """The absorbed decode over caches of per-sequence lengths (a (B,)
    ``cache_len`` and ``position``) against JAX's."""
    jc, tc, jp, tp = _setup(dtype, seed=3)
    a = tc.mla
    B, S = 3, 10
    xj, xt = _x((B, 1, jc.d_model), dtype, seed=4)
    cj, ct = _x((B, S, a.kv_lora_rank), dtype, seed=5, scale=1.0)
    rj, rt = _x((B, S, a.rope_head_dim), dtype, seed=6, scale=1.0)
    lens = np.array([3, 7, 10])
    want = jattn.mla_decode(xj, jp, jc, cj, rj, jnp.asarray(lens),
                            jnp.asarray(lens - 1))
    got = tattn.mla_decode(xt, tp, tc, ct, rt, torch.from_numpy(lens),
                           torch.from_numpy(lens - 1))
    assert tuple(got.shape) == (B, 1, tc.d_model)
    assert got.dtype == getattr(torch, dtype)
    tol = TOL[dtype] if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_mla_absorbed_decode_matches_prefill():
    """tests/test_attention.py's check, on the port: decoding the last
    token against the prefill's caches gives the prefill's last row."""
    _, tc, _, tp = _setup()
    B, S = 2, 12
    _, xt = _x((B, S, tc.d_model), "float32", seed=7)
    out, c_kv, k_rope = tattn.mla_prefill(xt, tp, tc, torch.arange(S))
    dec = tattn.mla_decode(xt[:, -1:], tp, tc, c_kv, k_rope, S, S - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), out[:, -1].numpy(),
                               atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_new_cache_entries_match_jax_and_the_prefill(dtype):
    jc, tc, jp, tp = _setup(dtype, seed=1)
    B, S = 2, 8
    xj, xt = _x((B, S, jc.d_model), dtype, seed=8)
    pos = np.array([S - 1, 3])
    want = jattn.mla_new_cache_entries(xj[:, -1:], jp, jc, jnp.asarray(pos))
    got = tattn.mla_new_cache_entries(xt[:, -1:], tp, tc,
                                      torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])
    if dtype == "float32":   # tests/test_attention.py's prefill check
        _, c_kv, k_rope = tattn.mla_prefill(xt, tp, tc, torch.arange(S))
        ck, kr = tattn.mla_new_cache_entries(xt[:, -1:], tp, tc, S - 1)
        np.testing.assert_allclose(ck[:, 0].numpy(), c_kv[:, -1].numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(kr[:, 0].numpy(), k_rope[:, -1].numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd,vd,K,causal,window", [
    (192, 128, 4, True, None), (48, 32, 2, True, None),
    (64, 100, 1, False, None), (40, 24, 2, True, 5)])
def test_flash_wrapper_cpu_route_with_vd_unlike_hd_matches_jax(hd, vd, K,
                                                              causal,
                                                              window):
    """The wrapper's CPU route (the plain version) against
    ``flash_attention_jnp`` with v's head dim unlike q's: output (B, Sq, H,
    vd); f32 atol 1e-5, rtol 1e-5 (the chunked online softmax against the
    unchunked one)."""
    rng = np.random.default_rng(hd + vd)
    B, Sq, H = 2, 20, 4
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, hd), (B, Sq, K, hd), (B, Sq, K, vd)))
    scale = 1.0 / np.sqrt(hd + 5)
    want = jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, q_block=8, kv_block=8,
                                     scale=scale)
    got = kflash.flash_attention_gqa(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     window=window, scale=scale)
    assert tuple(got.shape) == (B, Sq, H, vd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    via = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window, scale=scale, backend="ref")
    assert torch.equal(via, got)


@pytest.mark.parametrize("vd", [0, 257])
def test_flash_wrapper_bounds_v_head_dim(vd):
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match=f"v head dim {vd} outside"):
        kflash.flash_attention_gqa(q, q, torch.zeros((1, 4, 2, vd)))


@pytest.mark.parametrize("hd,vd,want_smem", [
    (192, 128, 4 * ((64 + 64) * 260 + 64 * 132 + 64 * 68)),
    (64, 128, 4 * ((64 + 32) * 132 + 32 * 132 + 32 * 68)),
    (128, 64, 4 * ((64 + 32) * 132 + 32 * 132 + 32 * 68))])
def test_simt_tiling_with_v_head_dim(hd, vd, want_smem):
    """The f32 kernel's tile for vd != hd: by max(hd, vd), V at 128
    columns for MLA's hd > 128 with vd <= 128 (Tile256v128), else as wide
    as q and k; the shared memory as the kernel lays it out."""
    t = kflash.simt_tiling(hd, vd)
    assert t.smem == want_smem <= 232448
    assert kflash.max_query_rows(hd, vd) == 65535 * t.rows
