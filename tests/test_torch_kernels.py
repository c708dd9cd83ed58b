"""The port's kernel wrappers on CPU tensors (their plain versions)
against the JAX package's oracles, ``repro.kernels.ref``, on the
parametrizations of ``tests/test_kernels.py``: random f32 and bf16 at
that file's tolerances, plus the strict < 5e-7 gate on quantized f32
inputs, where every sum is exact.  Also the wrappers' argument checks
and the build helper's behaviour without a CUDA toolkit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

# the tolerances of tests/test_kernels.py:19
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _quantized(rng, shape, step=2 ** -6, span=32):
    """f32 values on a coarse lattice: short sums are exact in any
    order (tests/test_kernels.py::_quantized)."""
    return (rng.integers(-span, span, shape) * step).astype(np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``
    (bf16 rounded once, by JAX, then carried bit for bit)."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _ids(a):
    return jnp.asarray(a, jnp.int32), torch.from_numpy(
        np.asarray(a, np.int32))


def _mask(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _f32(x):
    x = np.asarray(x.float() if isinstance(x, torch.Tensor) else
                   jnp.asarray(x, jnp.float32))
    return x.astype(np.float32)


@pytest.mark.parametrize("N,D,F", [(16, 128, 4), (32, 256, 8),
                                   (64, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_matches_jax(N, D, F, dtype):
    rng = np.random.default_rng(N + D)
    hj, ht = _pair(rng.standard_normal((N, D)), dtype)
    wj, wt = _pair(rng.standard_normal((N, F)), dtype)
    nj, nt = _ids(rng.integers(0, N, (N, F)))
    mj, mt = _mask(rng.random((N, F)) > 0.25)
    got = ops.spmm(ht, wt, nt, mt)
    assert got.dtype == TDT[dtype] and got.shape == (N, D)
    np.testing.assert_allclose(_f32(got), _f32(jref.spmm_ref(hj, wj, nj, mj)),
                               atol=ATOL[dtype] * F, rtol=3e-2)


@pytest.mark.parametrize("N,D,F", [(16, 64, 4), (32, 128, 8), (24, 96, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_matches_jax(N, D, F, dtype):
    rng = np.random.default_rng(N + D)
    qj, qt = _pair(rng.standard_normal((N, D)), dtype)
    kj, kt = _pair(rng.standard_normal((N, D)), dtype)
    nj, nt = _ids(rng.integers(0, N, (N, F)))
    mj, mt = _mask(rng.random((N, F)) > 0.25)
    got = ops.sddmm(qt, kt, nt, mt)
    assert got.dtype == torch.float32 and got.shape == (N, F)
    np.testing.assert_allclose(_f32(got), _f32(jref.sddmm_ref(qj, kj, nj, mj)),
                               atol=ATOL[dtype] * np.sqrt(D), rtol=3e-2)


@pytest.mark.parametrize("R,U,D,F", [(16, 16, 128, 4), (32, 48, 256, 8),
                                     (64, 80, 96, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_spmm_matches_jax(R, U, D, F, dtype):
    rng = np.random.default_rng(R + U + D)
    hj, ht = _pair(rng.standard_normal((U, D)), dtype)
    tj, tt = _ids(rng.permutation(U))
    wj, wt = _pair(rng.standard_normal((R, F)), dtype)
    nj, nt = _ids(rng.integers(0, U, (R, F)))
    mj, mt = _mask(rng.random((R, F)) > 0.25)
    got = ops.gather_spmm(ht, tt, wt, nt, mt)
    want = jref.gather_spmm_ref(hj, tj, wj, nj, mj)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               atol=ATOL[dtype] * F, rtol=3e-2)


@pytest.mark.parametrize("N,U,D,F,heads", [(16, 16, 64, 4, 1),
                                           (32, 48, 64, 8, 4),
                                           (64, 64, 128, 16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_attention_matches_jax(N, U, D, F, heads, dtype):
    rng = np.random.default_rng(N + U + heads)
    qj, qt = _pair(rng.standard_normal((N, D)), dtype)
    kj, kt = _pair(rng.standard_normal((U, D)), dtype)
    nj, nt = _ids(rng.integers(0, U, (N, F)))
    mask = rng.random((N, F)) > 0.25
    mask[0] = False                    # an all-masked row comes out 0
    mj, mt = _mask(mask)
    got = ops.gat_attention(qt, kt, nt, mt, heads=heads)
    assert got.dtype == torch.float32 and got.shape == (N, F, heads)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.gat_attention_ref(qj, kj, nj, mj, heads)),
        atol=ATOL[dtype], rtol=3e-2)
    assert (got.numpy()[~mask] == 0.0).all()


@pytest.mark.parametrize("kernel", ["spmm", "gather_spmm", "sddmm",
                                    "gat_attention"])
def test_quantized_strict(kernel):
    """The acceptance gate of tests/test_kernels.py: f32 max err < 5e-7
    on the quantized lattice (sums exact, so really 0.0); attention on
    random f32, as at tests/test_kernels.py:156."""
    rng = np.random.default_rng(11)
    R, U, D, F, heads = 64, 96, 128, 16, 4
    qz = _quantized if kernel != "gat_attention" else (
        lambda r, s: r.standard_normal(s).astype(np.float32))
    hj, ht = _pair(qz(rng, (U, D)), "float32")
    qj, qt = _pair(qz(rng, (R, D)), "float32")
    wj, wt = _pair(qz(rng, (R, F)), "float32")
    tj, tt = _ids(rng.permutation(U))
    nj, nt = _ids(rng.integers(0, U, (R, F)))
    mj, mt = _mask(rng.random((R, F)) > 0.25)
    got, want = {
        "spmm": lambda: (ops.spmm(ht, wt, nt, mt),
                         jref.spmm_ref(hj, wj, nj, mj)),
        "gather_spmm": lambda: (ops.gather_spmm(ht, tt, wt, nt, mt),
                                jref.gather_spmm_ref(hj, tj, wj, nj, mj)),
        "sddmm": lambda: (ops.sddmm(qt, ht, nt, mt),
                          jref.sddmm_ref(qj, hj, nj, mj)),
        "gat_attention": lambda: (
            ops.gat_attention(qt, ht, nt, mt, heads=heads),
            jref.gat_attention_ref(qj, hj, nj, mj, heads)),
    }[kernel]()
    assert np.abs(_f32(got) - _f32(want)).max() < 5e-7


def test_pallas_spmm_rounds_coefficients_to_h_dtype():
    """Pins the semantics the CUDA kernel copies (its card test is in
    tests/test_torch_gpu.py): the Pallas kernel rounds w * mask to h's
    dtype before the f32 sum (spmm.py:76), so with bf16 h a coefficient
    of 1 + 2**-9 becomes 1.0 and this row sums to 0; the oracles keep
    the f32 coefficient and give 2**-9."""
    from repro.kernels.spmm import spmm as pallas_spmm
    h = np.ones((8, 128), np.float32)
    w = np.zeros((8, 2), np.float32)
    w[:, 0], w[:, 1] = 1 + 2 ** -9, -1.0
    nbr = np.zeros((8, 2), np.int32)
    mask = np.ones((8, 2), bool)
    hj = jnp.asarray(h, jnp.bfloat16)
    got = pallas_spmm(hj, jnp.asarray(w), jnp.asarray(nbr),
                      jnp.asarray(mask), block_n=8, block_d=128)
    assert (np.asarray(got, np.float32) == 0).all()
    plain = ops.spmm(torch.from_numpy(h).to(torch.bfloat16),
                     torch.from_numpy(w), torch.from_numpy(nbr),
                     torch.from_numpy(mask))
    assert (plain.float().numpy() == 2 ** -9).all()


# (heads, D, F): heads 1, 2 and 4, D 8 to 128, F 1, 8 and 40 (past a warp)
HEADS_CASES = [(1, 8, 1), (2, 32, 8), (4, 128, 8), (4, 64, 40), (2, 16, 1),
               (1, 128, 40)]


@pytest.mark.parametrize("heads,D,F", HEADS_CASES)
@pytest.mark.parametrize("fused_table", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_heads_weighted_spmm_matches_pallas_per_head(heads, D, F,
                                                     fused_table, quantized):
    """w (R, F, heads): head k's weights on h's k-th block of D / heads
    columns, as GAT's attend runs it -- equal to the concatenation of
    JAX's per-head Pallas spmm / gather_spmm (interpret mode, as
    tests/test_kernels.py runs them): < 5e-7 on the quantized lattice,
    the sweep tolerance on random f32."""
    from repro.kernels.gather_spmm import gather_spmm as pallas_gather
    from repro.kernels.spmm import spmm as pallas_spmm
    rng = np.random.default_rng(heads * 100 + D + F)
    R, U = 24, 40
    draw = _quantized if quantized else (
        lambda r, s: r.standard_normal(s).astype(np.float32))
    hj, ht = _pair(draw(rng, (U, D)), "float32")
    wj, wt = _pair(draw(rng, (R, F, heads)), "float32")
    tj, tt = _ids(rng.permutation(U))
    nj, nt = _ids(rng.integers(0, U, (R, F)))
    mask = rng.random((R, F)) > 0.25
    mask[0] = False
    mj, mt = _mask(mask)
    dh = D // heads
    cols = [slice(k * dh, (k + 1) * dh) for k in range(heads)]
    if fused_table:
        got = ops.gather_spmm(ht, tt, wt, nt, mt)
        want = [pallas_gather(hj[:, c], tj, wj[..., k], nj, mj, block_d=dh)
                for k, c in enumerate(cols)]
    else:
        got = ops.spmm(ht, wt, nt, mt)
        want = [pallas_spmm(hj[:, c], wj[..., k], nj, mj, block_d=dh)
                for k, c in enumerate(cols)]
    want = np.concatenate([_f32(x) for x in want], axis=1)
    assert got.shape == (R, D)
    if quantized:
        assert np.abs(_f32(got) - want).max() < 5e-7
    else:
        np.testing.assert_allclose(_f32(got), want, atol=ATOL["float32"] * F,
                                   rtol=3e-2)
    assert (_f32(got)[0] == 0).all()


@pytest.mark.parametrize("fused_table", [False, True])
def test_heads_weighted_spmm_reads_strided_weights(fused_table):
    """A transposed (R, F, heads) view -- the unfused softmax's layout --
    gives the bits of its contiguous copy."""
    rng = np.random.default_rng(9)
    R, U, D, F, heads = 30, 45, 64, 8, 4
    h = torch.from_numpy(rng.standard_normal((U, D)).astype(np.float32))
    table = torch.from_numpy(rng.permutation(U).astype(np.int32))
    nbr = torch.from_numpy(rng.integers(0, U, (R, F)).astype(np.int32))
    mask = torch.from_numpy(rng.random((R, F)) > 0.25)
    w = torch.from_numpy(rng.random((R, heads, F)).astype(
        np.float32)).transpose(1, 2)
    assert not w.is_contiguous()
    run = ((lambda ww: ops.gather_spmm(h, table, ww, nbr, mask))
           if fused_table else (lambda ww: ops.spmm(h, ww, nbr, mask)))
    assert torch.equal(run(w), run(w.contiguous()))


def test_heads_weighted_spmm_rejects_heads_that_do_not_divide_d():
    h = torch.zeros(8, 12)
    nbr = torch.zeros(8, 3, dtype=torch.int32)
    mask = torch.ones(8, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="heads=5, which must divide D=12"):
        ops.spmm(h, torch.ones(8, 3, 5), nbr, mask)
    with pytest.raises(ValueError, match="w must be"):
        ops.spmm(h, torch.ones(8, 2, 4), nbr, mask)


def test_gather_spmm_bitwise_vs_materialized():
    """The fused indirection equals spmm over h[table] bit for bit."""
    rng = np.random.default_rng(5)
    R, U, D, F = 32, 40, 128, 8
    h = torch.from_numpy(rng.standard_normal((U, D)).astype(np.float32))
    table = torch.from_numpy(rng.permutation(U).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((R, F)).astype(np.float32))
    nbr = torch.from_numpy(rng.integers(0, U, (R, F)).astype(np.int32))
    mask = torch.from_numpy(rng.random((R, F)) > 0.25)
    fused = ops.gather_spmm(h, table, w, nbr, mask)
    materialized = ops.spmm(h[table.long()], w, nbr, mask)
    assert torch.equal(fused, materialized)


def test_wrappers_reject_bad_shapes_and_devices():
    h = torch.zeros(8, 4)
    nbr = torch.zeros(8, 3, dtype=torch.int32)
    mask = torch.ones(8, 3, dtype=torch.bool)
    w = torch.ones(8, 3)
    with pytest.raises(ValueError, match="w must be"):
        ops.spmm(h, torch.ones(8, 2), nbr, mask)
    with pytest.raises(ValueError, match="nbr and mask"):
        ops.sddmm(h, h, nbr, mask[:, :2])
    with pytest.raises(ValueError, match="table must be 1-D"):
        ops.gather_spmm(h, nbr, w, nbr, mask)
    with pytest.raises(ValueError, match="heads=3"):
        ops.gat_attention(h, h, nbr, mask, heads=3)
    with pytest.raises(ValueError, match="k must be"):
        ops.gat_attention(h, torch.zeros(8, 5), nbr, mask)
    meta = [t.to("meta") for t in (h, w, nbr, mask)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.spmm(*meta)


def test_launch_counters_reset_and_cpu_calls_do_not_count():
    ops.reset_launch_counts()
    h = torch.zeros(8, 4)
    nbr = torch.zeros(8, 3, dtype=torch.int32)
    mask = torch.ones(8, 3, dtype=torch.bool)
    ops.spmm(h, torch.ones(8, 3), nbr, mask)
    ops.gat_attention(h, h, nbr, mask)
    q = torch.zeros(2, 5, 4)
    ops.flash_attention(q, q, q)
    ops.rgat_attention(torch.zeros(8, 4), torch.zeros(8, 2, 4), nbr,
                       torch.zeros(8, 3, dtype=torch.int8), mask)
    assert ops.launch_counts() == {"spmm": 0, "gather_spmm": 0,
                                   "gat_attention": 0, "sddmm": 0,
                                   "flash_attention": 0,
                                   "rgat_attention": 0}


def test_build_names_libraries_by_source_hash_and_needs_nvcc(
        monkeypatch, tmp_path):
    a, b = build.library_path("spmm"), build.library_path("gat_attention")
    assert a.parent == b.parent == build.BUILD_DIR and a != b
    assert a == build.library_path("spmm")        # stable name
    assert all((build.CSRC / f"{n}.cu").exists() for n in build.SOURCES)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


@pytest.mark.parametrize("D,vec,want", [(128, 4, (2, 32)), (32, 4, (8, 8)),
                                        (20, 4, (8, 8)), (128, 8, (4, 16)),
                                        (7, 1, (8, 8)), (4096, 4, (2, 32))])
def test_default_tiling(D, vec, want):
    from repro_torch.kernels.spmm import default_tiling
    assert default_tiling(D, vec) == want


# (F, D, heads, itemsize, softmax, warps a block); a warp's shared memory
# is 32 / F2 * D + 33 * D / V + 64 (+ max(32, F2 * heads)) words, F2 = F
# rounded up to a power of two, V = 16 bytes of columns where dh allows
# it, else 1
@pytest.mark.parametrize("F,D,heads,itemsize,softmax,want", [
    (8, 128, 4, 4, True, 8), (8, 32, 1, 4, False, 8),
    (8, 2048, 4, 4, True, 2), (32, 1024, 1, 2, False, 8),
    (6, 20, 4, 4, True, 8)])
def test_attention_block_warps(F, D, heads, itemsize, softmax, want):
    from repro_torch.kernels.gat_attention import block_warps, warp_words
    assert block_warps("k", F, D, heads, itemsize, softmax) == want
    assert want * 4 * warp_words(F, D, heads, itemsize, softmax) <= 232448


# the one limit left: a warp's shared memory (the wide kernel's pass of k
# rows, q rows, slot lists and F x heads scores) within a block's 227 KB;
# and a row needs a column
@pytest.mark.parametrize("F,D,heads,match", [
    (4096, 128, 16, "280624 bytes .* more than a block.s 227 KB"),
    (58113, 1, 1, "465968 bytes .* more than a block.s 227 KB"),
    (1024, 64, 64, "267296 bytes .* more than a block.s 227 KB"),
    (8, 0, 1, "D=0, the kernel needs a column")])
def test_attention_block_warps_name_the_kernel_limits(F, D, heads, match):
    from repro_torch.kernels.gat_attention import block_warps
    with pytest.raises(ValueError, match=match):
        block_warps("gat_attention", F, D, heads, 4, True)


# which kernel of csrc/gat_attention.cu takes a shape: the narrow one
# where it did before (F <= 32, heads a power of two up to 32), the wide
# one for F = 33 and 64 and for heads 3, 6 and 64
@pytest.mark.parametrize("F,D,heads,itemsize,softmax,want", [
    (33, 128, 4, 4, True, "wide"), (64, 128, 4, 4, True, "wide"),
    (64, 32, 1, 4, False, "wide"), (8, 96, 3, 4, True, "wide"),
    (8, 96, 6, 2, True, "wide"), (8, 128, 64, 4, True, "wide"),
    (8, 8192, 4, 4, True, "wide"),          # narrow's warp past 227 KB
    (8, 128, 4, 4, True, "narrow"), (32, 128, 4, 2, True, "narrow"),
    (1, 64, 4, 4, True, "narrow"), (32, 32, 1, 4, False, "narrow"),
    (3, 64, 32, 4, True, "narrow"), (8, 2048, 4, 4, True, "narrow")])
def test_kernel_for_picks_the_wide_kernel_by_shape(F, D, heads, itemsize,
                                                   softmax, want):
    from repro_torch.kernels.gat_attention import kernel_for
    assert kernel_for(F, D, heads, itemsize, softmax) == want


@pytest.mark.parametrize("args", [("gat_attention", 64, 128, 4, 4, True),
                                  ("gat_attention", 8, 96, 3, 4, True),
                                  ("sddmm", 64, 32, 1, 4, False)])
def test_block_warps_takes_wide_rows_and_any_heads(args):
    from repro_torch.kernels.gat_attention import block_warps, wide_words
    assert block_warps(*args) == 8
    assert 8 * 4 * wide_words(*args[1:]) <= 232448


# the wide kernel's shared memory (a pass of k rows, the q rows, a live
# list of up to 64 slots, the scores): for heads 1-64 at 32 columns a head,
# the largest F the wrapper takes fits a block, and the next one raises
@pytest.mark.parametrize("heads", [1, 2, 3, 4, 6, 8, 16, 32, 64])
@pytest.mark.parametrize("itemsize,softmax", [(4, True), (2, True),
                                              (4, False)])
def test_wide_shared_memory_fits_up_to_the_largest_fanout(heads, itemsize,
                                                          softmax):
    from repro_torch.kernels.gat_attention import (block_warps, kernel_for,
                                                   wide_words)
    D = 32 * heads
    if not softmax:    # sddmm keeps no scores: no fanout is too large
        F = 1 << 20
        warps = block_warps("k", F, D, heads, itemsize, softmax)
        assert warps == 8 and kernel_for(F, D, heads, itemsize, False) == \
            "wide"
        assert 8 * 4 * wide_words(F, D, heads, itemsize, False) <= 232448
        return
    lo, hi = 33, 1 << 17
    while lo < hi:                       # the largest F block_warps takes
        mid = (lo + hi + 1) // 2
        try:
            block_warps("k", mid, D, heads, itemsize, softmax)
            lo = mid
        except ValueError:
            hi = mid - 1
    F = lo
    assert kernel_for(F, D, heads, itemsize, softmax) == "wide"
    warps = block_warps("k", F, D, heads, itemsize, softmax)
    assert warps * 4 * wide_words(F, D, heads, itemsize, softmax) <= 232448
    assert 4 * wide_words(F + 1, D, heads, itemsize, softmax) > 232448
    with pytest.raises(ValueError, match="more than a block.s 227 KB"):
        block_warps("k", F + 1, D, heads, itemsize, softmax)


@pytest.mark.parametrize("D,heads,itemsize,want", [
    (128, 4, 4, (33, 8)), (96, 3, 4, (25, 11)), (32, 1, 4, (9, 32)),
    (128, 1, 4, (33, 15)), (128, 4, 2, (17, 8)), (97, 1, 4, (25, 20))])
def test_wide_pitch_and_pass(D, heads, itemsize, want):
    """Rows 16 x odd bytes apart; a pass holds enough slots for 32 (slot,
    head) pairs, at most about 8 KB of rows (csrc/gat_attention.cu
    wide_pitch16 / wide_pass)."""
    from repro_torch.kernels.gat_attention import wide_pass, wide_pitch16
    assert (wide_pitch16(D, itemsize), wide_pass(D, heads, itemsize)) == want


def test_wide_pass_budget_mirrors_the_c_source():
    import re
    from pathlib import Path
    from repro_torch.kernels import gat_attention as kgat
    src = (Path(kgat.__file__).parent / "csrc" /
           "gat_attention.cu").read_text()
    m = re.search(r"constexpr int kPassWords = (\d+);", src)
    assert int(m.group(1)) == kgat._PASS_WORDS


@pytest.mark.parametrize("N,U,D,F,heads", [(16, 24, 96, 64, 3),
                                           (24, 16, 96, 8, 3),
                                           (16, 16, 96, 40, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_attention_wide_shapes_match_pallas(N, U, D, F, heads, dtype):
    """The port's plain gat_attention at the wide kernel's shapes against
    the Pallas kernel run as tests/test_kernels.py runs it (interpret
    mode), at that file's tolerances."""
    from repro.kernels.gat_attention import gat_attention as pallas_gat
    rng = np.random.default_rng(N + F + heads)
    qj, qt = _pair(rng.standard_normal((N, D)), dtype)
    kj, kt = _pair(rng.standard_normal((U, D)), dtype)
    nj, nt = _ids(rng.integers(0, U, (N, F)))
    mask = rng.random((N, F)) > 0.25
    mask[0] = False
    mj, mt = _mask(mask)
    got = ops.gat_attention(qt, kt, nt, mt, heads=heads)
    want = pallas_gat(qj, kj, nj, mj, heads=heads)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dtype],
                               rtol=3e-2)
    assert (got.numpy()[~mask] == 0.0).all()


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_plain_spmm_gives_nan_at_a_masked_non_finite_row_as_jax(bad):
    """The reference side of the masked-slot contract (README,
    "Numerics"): the TPU kernel and the plain versions compute
    0.0 * row, so a masked Inf/NaN row makes its output row NaN.  The
    CUDA kernels skip masked slots (tests/test_torch_gpu.py pins that
    side)."""
    from repro.kernels.spmm import spmm as pallas_spmm
    rng = np.random.default_rng(0)
    h = rng.standard_normal((16, 128)).astype(np.float32)
    h[3] = bad
    nbr = rng.integers(0, 16, (16, 4)).astype(np.int32)
    nbr[5, 1] = 3
    mask = np.ones((16, 4), bool)
    mask[5, 1] = False                     # row 5 reaches row 3 masked
    mask[nbr == 3] = False
    w = rng.standard_normal((16, 4)).astype(np.float32)
    got = ops.spmm(torch.from_numpy(h), torch.from_numpy(w),
                   torch.from_numpy(nbr), torch.from_numpy(mask)).numpy()
    want = np.asarray(pallas_spmm(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(nbr), jnp.asarray(mask)))
    hit = (nbr == 3).any(axis=1)
    assert np.isnan(got[hit]).all() and np.isnan(want[hit]).all()
    assert np.isfinite(got[~hit]).all()
    np.testing.assert_allclose(got[~hit], want[~hit], atol=2e-5 * 4,
                               rtol=3e-2)
