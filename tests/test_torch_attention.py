"""The port's attention on CPU tensors against the JAX package on the same
inputs: the flash kernel's wrapper in the Pallas signature against the
Pallas kernel (interpret mode) and ``repro.kernels.ref``, at
``tests/test_kernels.py::test_flash_sweep``'s shapes and tolerances; the
model-level ``flash_attention`` against ``flash_attention_jnp`` (GQA,
ragged S, window, q_offset, explicit scale); ``decode_attention`` with a
per-slot cache length; and ``simple_attention``.  On the CPU the
wrappers run their plain versions: the CUDA kernel itself is held
against them on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

# tests/test_kernels.py:19 (the flash sweep's tolerances)
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype`` (bf16
    rounded once, by JAX, and carried bit for bit)."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("BH,S,hd,bq,bk", [
    (2, 128, 64, 64, 64),
    (4, 256, 64, 128, 128),
    (2, 128, 128, 32, 64),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_wrapper_matches_pallas_and_ref(BH, S, hd, bq, bk, causal,
                                              dtype):
    rng = np.random.default_rng(BH * S + hd)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal((BH, S, hd)), dtype) for _ in range(3))
    got = kops.flash_attention(qt, kt, vt, causal=causal, block_q=bq,
                               block_k=bk)
    assert got.dtype == qt.dtype and got.shape == (BH, S, hd)
    pallas = jflash(qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    oracle = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                                   rtol=3e-2)


# (Sq, Skv, q_offset, causal, window, scale): GQA H=4 over K=2 throughout
GQA_CASES = [
    (37, 37, 0, True, None, None),       # ragged: a multiple of no block
    (37, 37, 0, True, 8, None),          # sliding window
    (37, 37, 0, True, 1 << 30, None),    # a global layer's window
    (21, 37, 16, True, 8, None),         # continuing at q_offset
    (37, 29, 0, False, None, 0.3),       # cross attention, explicit scale
]


@pytest.mark.parametrize("Sq,Skv,q_offset,causal,window,scale", GQA_CASES)
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_model_flash_matches_flash_attention_jnp(Sq, Skv, q_offset, causal,
                                                 window, scale, backend):
    rng = np.random.default_rng(Sq + Skv + q_offset)
    B, H, K, hd = 2, 4, 2, 64
    qj, qt = _pair(rng.standard_normal((B, Sq, H, hd)), "float32")
    kj, kt = _pair(rng.standard_normal((B, Skv, K, hd)), "float32")
    vj, vt = _pair(rng.standard_normal((B, Skv, K, hd)), "float32")
    kw = dict(q_offset=q_offset, causal=causal, window=window, scale=scale)
    kops.reset_launch_counts()
    got = tattn.flash_attention(qt, kt, vt, backend=backend, **kw)
    assert kops.launch_counts()["flash_attention"] == 0   # CPU: plain
    want = jattn.flash_attention_jnp(qj, kj, vj, q_block=16, kv_block=16,
                                     **kw)
    assert got.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


def test_model_flash_heads_read_kv_head_h_over_g():
    """Query head h reads kv head h // G (attention.py:89 splits H into
    (K, G)), not h % K: with one distinct value per kv head, the output
    of each query head is that head's value."""
    B, S, H, K, hd = 1, 5, 6, 2, 8
    q = torch.zeros(B, S, H, hd)
    k = torch.zeros(B, S, K, hd)
    v = torch.arange(K, dtype=torch.float32)[None, None, :, None].expand(
        B, S, K, hd).contiguous()
    out = tattn.flash_attention(q, k, v)
    np.testing.assert_array_equal(out[0, :, :, 0].numpy(),
                                  np.tile([0, 0, 0, 1, 1, 1], (S, 1)))


def test_model_flash_rejects_an_unknown_backend():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="unknown attention backend"):
        tattn.flash_attention(q, q, q, backend="pallas")
    with pytest.raises(ValueError, match="not a multiple"):
        kflash.flash_attention_gqa(q, torch.zeros(1, 4, 3, 8),
                                   torch.zeros(1, 4, 3, 8))


# the f32 CUDA kernel's tile edges (64 query rows; 64 keys, or 32 for
# 64 < hd <= 128): Sq and Skv one short of and one past a tile, hd 36 and
# 256.  The plain version the kernel is held against on the card, against
# flash_attention_jnp and the Pallas kernel (interpret mode)
EDGE_CASES = [(63, 65, 36), (65, 63, 36), (31, 33, 100), (33, 31, 100),
              (65, 65, 256), (63, 63, 256)]


@pytest.mark.parametrize("Sq,Skv,hd", EDGE_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_gqa_at_the_f32_tile_edges_matches_jax(Sq, Skv, hd, causal):
    rng = np.random.default_rng(Sq * Skv + hd)
    B, H, K = 1, 4, 2
    qj, qt = _pair(rng.standard_normal((B, Sq, H, hd)), "float32")
    kj, kt = _pair(rng.standard_normal((B, Skv, K, hd)), "float32")
    vj, vt = _pair(rng.standard_normal((B, Skv, K, hd)), "float32")
    got = kref.gqa_attention_ref(qt, kt, vt, causal=causal)
    want = jattn.flash_attention_jnp(qj, kj, vj, q_block=32, kv_block=32,
                                     causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)
    if Sq == Skv:   # the Pallas signature: one head a row of (BH, S, hd)
        q3, k3, v3 = (x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], hd)
                      for x in (qj, jnp.repeat(kj, H // K, axis=2),
                                jnp.repeat(vj, H // K, axis=2)))
        pallas = jflash(q3, k3, v3, causal=causal, block_q=Sq, block_k=Skv)
        np.testing.assert_allclose(
            _np(got).transpose(0, 2, 1, 3).reshape(-1, Sq, hd), _np(pallas),
            atol=ATOL["float32"], rtol=3e-2)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_per_slot(window, dtype):
    rng = np.random.default_rng(7)
    B, S, H, K, hd = 3, 16, 4, 2, 64
    qj, qt = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, K, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, K, hd)), dtype)
    clen = np.array([1, 9, 16], np.int32)
    got = tattn.decode_attention(qt, kt, vt, cache_len=torch.from_numpy(clen),
                                 window=window)
    want = jattn.decode_attention(qj, kj, vj, cache_len=jnp.asarray(clen),
                                  window=window)
    assert got.dtype == qt.dtype and got.shape == (B, 1, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                               rtol=3e-2 if dtype == "bfloat16" else 3e-5)


def test_simple_attention_matches_jax():
    rng = np.random.default_rng(11)
    B, Sq, Skv, H, K, hd = 2, 7, 12, 4, 2, 32
    qj, qt = _pair(rng.standard_normal((B, Sq, H, hd)), "float32")
    kj, kt = _pair(rng.standard_normal((B, Skv, K, hd)), "float32")
    vj, vt = _pair(rng.standard_normal((B, Skv, K, hd)), "float32")
    kw = dict(q_offset=5, causal=True, window=6, scale=0.2)
    got = tattn.simple_attention(qt, kt, vt, kv_valid_len=10, **kw)
    want = jattn.simple_attention(qj, kj, vj, kv_valid_len=jnp.int32(10),
                                  **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)
