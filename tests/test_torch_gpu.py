"""The CUDA kernels against their plain versions on the card, at small
and ragged shapes.  Marked ``gpu``: each test skips where no CUDA card
is visible, so on a CPU-only machine they all skip.  On a machine with a
card and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.gpu
ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.cuda.synchronize()
    return torch.device("cuda")


def _graph(dev, R, U, F, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    nbr = torch.randint(0, U, (R, F), generator=g, device=dev,
                        dtype=torch.int32)
    mask = torch.rand((R, F), generator=g, device=dev) > 0.25
    mask[0] = False
    return g, nbr, mask


def _close(got, want, atol, rtol=3e-2):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


def _misaligned(t):
    """The same values one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


# (R, U, D, F): F = 1, 32 (a warp of slots) and 40 (past it), D = 20 (one-
# element chunks in bf16) and 7, ragged R
SPMM_CASES = [(16, 16, 128, 4), (23, 37, 20, 6), (64, 80, 96, 16),
              (1000, 900, 7, 8), (40, 50, 64, 1), (40, 50, 128, 32),
              (40, 50, 128, 40)]


@pytest.mark.parametrize("R,U,D,F", SPMM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused_table", [False, True])
def test_spmm_kernels_match_plain(cuda, R, U, D, F, dtype, fused_table):
    """Against the plain version; bitwise the same across tilings and on a
    misaligned view of h (narrow loads); a row with no live slot (row 0)
    exactly 0."""
    g, nbr, mask = _graph(cuda, R, U, F, R + D)
    h = torch.randn((U, D), generator=g, device=cuda).to(dtype)
    w = torch.randn((R, F), generator=g, device=cuda)      # always f32
    before = kops.launch_counts()
    if fused_table:
        table = torch.randperm(U, generator=g, device=cuda).to(torch.int32)
        fn = lambda hh, **kw: kops.gather_spmm(hh, table, w, nbr, mask, **kw)
        want = ref.gather_spmm_ref(h, table, w, nbr, mask)
        name = "gather_spmm"
    else:
        fn = lambda hh, **kw: kops.spmm(hh, w, nbr, mask, **kw)
        want = ref.spmm_ref(h, w, nbr, mask)
        name = "spmm"
    got = fn(h)
    assert got.dtype == dtype and got.shape == (R, D)
    _close(got, want, ATOL[dtype] * F)
    for tiling in ((3, 2), (1, 32), (16, 8)):    # tiling-invariant bits
        assert torch.equal(fn(h, block_rows=tiling[0],
                              block_cols=tiling[1]), got)
    assert torch.equal(fn(_misaligned(h)), got)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    assert kops.launch_counts()[name] == before[name] + 5


@pytest.mark.parametrize("fused_table", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_row_subset_equals_full_launch_bitwise(cuda, fused_table,
                                                    dtype):
    """Delta refresh runs row subsets (every third row, rows 1000 to
    1999): a row's bits may not depend on which rows share its launch."""
    R, U, D, F = 2500, 1200, 128, 8
    g, nbr, mask = _graph(cuda, R, U, F, 11)
    h = torch.randn((U, D), generator=g, device=cuda).to(dtype)
    w = torch.randn((R, F, 4), generator=g, device=cuda)
    table = torch.randperm(U, generator=g, device=cuda).to(torch.int32)

    def run(rows):
        args = (w[rows], nbr[rows], mask[rows])
        if fused_table:
            return kops.gather_spmm(h, table, *args)
        return kops.spmm(h, *args)
    full = run(torch.arange(R, device=cuda))
    for rows in (torch.arange(0, R, 3, device=cuda),
                 torch.arange(1000, 2000, device=cuda)):
        part = run(rows)
        torch.cuda.synchronize()
        assert torch.equal(part, full[rows])


@pytest.mark.parametrize("fused_table", [False, True])
def test_spmm_masked_slots_do_not_reach_the_output(cuda, fused_table):
    """Masked slots pointing at a row of large finite values give the bits
    of the same launch with those ids set to 0: a masked slot's row is
    never read (the TPU kernel adds 0.0 * row there, the same bits for a
    finite row)."""
    R, U, D, F = 300, 200, 128, 8
    g, nbr, mask = _graph(cuda, R, U, F, 5)
    h = torch.randn((U + 1, D), generator=g, device=cuda)
    h[U] = 3e38
    w = torch.randn((R, F), generator=g, device=cuda)
    table = torch.arange(U + 1, device=cuda, dtype=torch.int32)
    big = torch.where(mask, nbr, torch.full_like(nbr, U))
    zero = torch.where(mask, nbr, torch.zeros_like(nbr))
    if fused_table:
        a = kops.gather_spmm(h, table, w, big, mask)
        b = kops.gather_spmm(h, table, w, zero, mask)
    else:
        a, b = kops.spmm(h, w, big, mask), kops.spmm(h, w, zero, mask)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("fused_table", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_weighted_spmm_equals_per_head_launches(cuda, transposed,
                                                      fused_table, dtype):
    """GAT's attend in one launch: w (R, F, heads), contiguous or the
    unfused softmax's transposed view (read in place), gives the bits of
    one launch per head on copied column slices, as attend ran before."""
    R, U, D, F, heads = 700, 500, 128, 8, 4
    g, nbr, mask = _graph(cuda, R, U, F, 3)
    h = torch.randn((U, D), generator=g, device=cuda).to(dtype)
    w = torch.rand((R, heads, F), generator=g, device=cuda).transpose(1, 2)
    if not transposed:
        w = w.contiguous()
    assert w.is_contiguous() != transposed
    table = torch.randperm(U, generator=g, device=cuda).to(torch.int32)

    def run(hh, ww):
        if fused_table:
            return kops.gather_spmm(hh, table, ww, nbr, mask)
        return kops.spmm(hh, ww, nbr, mask)
    before = kops.launch_counts()
    got = run(h, w)
    name = "gather_spmm" if fused_table else "spmm"
    assert kops.launch_counts()[name] == before[name] + 1
    dh = D // heads
    per_head = torch.cat([run(h[:, k * dh:(k + 1) * dh].contiguous(),
                              w[..., k].contiguous()) for k in range(heads)],
                         dim=1)
    torch.cuda.synchronize()
    assert torch.equal(got, per_head)
    plain = (ref.gather_spmm_heads_ref(h, table, w, nbr, mask) if fused_table
             else ref.spmm_heads_ref(h, w, nbr, mask))
    _close(got, plain, ATOL[dtype] * F)


def test_spmm_rounds_coefficients_to_h_dtype(cuda):
    """(w * mask) is rounded to h's dtype before the f32 sum, as
    src/repro/kernels/spmm.py:76 does: 1 + 2**-9 rounds to 1.0 in bf16,
    so the row sums to exactly 0 (the plain version, which keeps the f32
    coefficient, gives 2**-9).  tests/test_torch_kernels.py pins the
    Pallas kernel to the same 0."""
    h = torch.ones((1, 8), device=cuda, dtype=torch.bfloat16)
    w = torch.tensor([[1 + 2 ** -9, -1.0]], device=cuda)
    nbr = torch.zeros((1, 2), device=cuda, dtype=torch.int32)
    mask = torch.ones((1, 2), device=cuda, dtype=torch.bool)
    table = torch.zeros(1, device=cuda, dtype=torch.int32)
    for out in (kops.spmm(h, w, nbr, mask),
                kops.gather_spmm(h, table, w, nbr, mask)):
        torch.cuda.synchronize()
        assert bool((out == 0).all()), out


@pytest.mark.parametrize("N,U,D,F,heads", [(16, 16, 64, 4, 1),
                                           (32, 48, 64, 8, 4),
                                           (50, 61, 20, 6, 4),
                                           (64, 64, 128, 16, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_match_plain(cuda, N, U, D, F, heads, dtype):
    g, nbr, mask = _graph(cuda, N, U, F, N + heads)
    q = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((U, D), generator=g, device=cuda).to(dtype)
    alpha = kops.gat_attention(q, k, nbr, mask, heads=heads)
    assert alpha.shape == (N, F, heads) and alpha.dtype == torch.float32
    strict = 5e-7 if dtype == torch.float32 else ATOL[dtype]
    _close(alpha, ref.gat_attention_ref(q, k, nbr, mask, heads), strict,
           0 if dtype == torch.float32 else 3e-2)
    assert bool((alpha[~mask] == 0).all())
    e = kops.sddmm(q, k, nbr, mask)
    _close(e, ref.sddmm_ref(q, k, nbr, mask), ATOL[dtype] * D ** 0.5)


def _scores(kernel, q, k, nbr, mask, heads):
    if kernel == "sddmm":
        return kops.sddmm(q, k, nbr, mask)
    return kops.gat_attention(q, k, nbr, mask, heads=heads)


@pytest.mark.parametrize("kernel,heads", [("gat_attention", 4),
                                          ("sddmm", 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_row_subset_equals_full_launch_bitwise(cuda, kernel,
                                                         heads, dtype):
    """Delta and chunked refresh run row subsets: a row's bits may not
    depend on where it sits in a launch or which rows share its block."""
    N, U, D, F = 300, 257, 128, 8
    g, nbr, mask = _graph(cuda, N, U, F, 7)
    q = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((U, D), generator=g, device=cuda).to(dtype)
    full = _scores(kernel, q, k, nbr, mask, heads)
    for rows in (torch.arange(5, 5 + 37, device=cuda),
                 torch.randperm(N, generator=g, device=cuda)[:101]):
        part = _scores(kernel, q[rows], k, nbr[rows], mask[rows], heads)
        torch.cuda.synchronize()
        assert torch.equal(part, full[rows])


# (N, U, D, F, heads): F = 1 and 32, D = 20 (one-column chunks at
# dh = 5), D = 96 (24 chunks a row, not a power of two), 32 heads
EDGE_CASES = [(40, 50, 64, 1, 4), (40, 50, 128, 32, 4), (40, 50, 32, 32, 1),
              (33, 45, 20, 6, 4), (33, 45, 20, 6, 1), (40, 50, 96, 8, 2),
              (17, 30, 64, 3, 32)]


@pytest.mark.parametrize("N,U,D,F,heads", EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_the_edges(cuda, N, U, D, F, heads, dtype):
    """An all-masked row (0), a fully live row (sums to 1), F = 1 and 32,
    narrow chunks, and a misaligned view of the same q and k (narrow
    loads in the same order: bitwise the aligned result)."""
    g, nbr, mask = _graph(cuda, N, U, F, N + F)
    mask[1] = True                                   # fully live
    q = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((U, D), generator=g, device=cuda).to(dtype)
    alpha = kops.gat_attention(q, k, nbr, mask, heads=heads)
    e = kops.sddmm(q, k, nbr, mask)
    strict = 5e-7 if dtype == torch.float32 else ATOL[dtype]
    _close(alpha, ref.gat_attention_ref(q, k, nbr, mask, heads), strict,
           0 if dtype == torch.float32 else 3e-2)
    _close(e, ref.sddmm_ref(q, k, nbr, mask), ATOL[dtype] * D ** 0.5)
    assert bool((alpha[0] == 0).all()) and bool((e[0] == 0).all())
    assert bool((alpha[~mask] == 0).all()) and bool((e[~mask] == 0).all())
    _close(alpha[1].sum(0), torch.ones(heads, device=cuda), 1e-5, 0)

    def odd(t):                      # the same values, one element off
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view
    qo, ko = odd(q), odd(k)
    assert qo.data_ptr() % 16 and ko.data_ptr() % 16
    assert torch.equal(kops.gat_attention(qo, ko, nbr, mask, heads=heads),
                       alpha)
    assert torch.equal(kops.sddmm(qo, ko, nbr, mask), e)


@pytest.mark.parametrize("width", [128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sddmm_reads_column_slices_in_place(cuda, width, dtype):
    """A per-head column slice (row-strided; width 129 leaves every row
    but the first unaligned) gives the bits of its contiguous copy."""
    N, U, F, dh = 70, 90, 8, 32
    g, nbr, mask = _graph(cuda, N, U, F, width)
    qw = torch.randn((N, width), generator=g, device=cuda).to(dtype)
    kw = torch.randn((U, width), generator=g, device=cuda).to(dtype)
    before = kops.launch_counts()["sddmm"]
    for h in range(4):
        q, k = qw[:, h * dh:(h + 1) * dh], kw[:, h * dh:(h + 1) * dh]
        assert not q.is_contiguous()
        got = kops.sddmm(q, k, nbr, mask)
        assert torch.equal(got, kops.sddmm(q.contiguous(), k.contiguous(),
                                           nbr, mask))
    assert kops.launch_counts()["sddmm"] == before + 8
    with pytest.raises(ValueError, match="unit-stride columns"):
        kops.sddmm(qw[:, ::2], kw[:, ::2], nbr, mask)


def test_attention_wrappers_raise_past_the_kernel_limits(cuda):
    """F = 33, heads = 3 and a narrow warp past 227 KB now take the wide
    kernel; the one limit left, a wide warp's F x heads scores past
    227 KB of shared memory, raises before any launch."""
    _, nbr, mask = _graph(cuda, 8, 8, 33, 0)
    h = torch.randn((8, 96), device=cuda)
    before = kops.launch_counts()
    wide = (kops.gat_attention.launches_wide, kops.sddmm.launches_wide)
    kops.gat_attention(h, h, nbr, mask, heads=4)
    kops.sddmm(h, h, nbr, mask)
    n8, m8 = nbr[:, :8].contiguous(), mask[:, :8].contiguous()
    kops.gat_attention(h, h, n8, m8, heads=3)
    big = torch.randn((8, 8192), device=cuda)
    kops.gat_attention(big, big, n8, m8, heads=4)
    torch.cuda.synchronize()
    assert kops.gat_attention.launches_wide == wide[0] + 3
    assert kops.sddmm.launches_wide == wide[1] + 1
    _, nbr, mask = _graph(cuda, 8, 8, 4096, 0)
    h = torch.randn((8, 256), device=cuda)
    after = kops.launch_counts()
    with pytest.raises(ValueError, match="more than a block.s 227 KB"):
        kops.gat_attention(h, h, nbr, mask, heads=16)
    assert kops.launch_counts() == after
    assert after["gat_attention"] == before["gat_attention"] + 3


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    _, nbr, mask = _graph(cuda, 8, 8, 4, 0)
    h = torch.randn((8, 16), device=cuda)
    w = torch.ones((8, 4), device=cuda)
    with pytest.raises(TypeError, match="nbr"):
        kops.spmm(h, w, nbr.long(), mask)
    with pytest.raises(TypeError, match="w must"):
        kops.spmm(h, w.to(torch.bfloat16), nbr, mask)
    with pytest.raises(ValueError, match="contiguous"):
        kops.spmm(torch.randn((8, 32), device=cuda)[:, :16], w, nbr, mask)
    with pytest.raises(ValueError, match="is on cpu"):
        kops.sddmm(h, h, nbr.cpu(), mask)
    with pytest.raises(TypeError, match="q is"):
        kops.gat_attention(h, h.to(torch.bfloat16), nbr, mask)
    with pytest.raises(ValueError, match="heads=3, which must divide"):
        kops.spmm(torch.randn((8, 128), device=cuda),
                  torch.ones((8, 4, 3), device=cuda), nbr, mask)


def test_cuda_session_matches_ref_on_the_card(cuda):
    from repro_torch.api import DealConfig, Session
    from repro_torch.core.gnn_models import model_spec
    from repro_torch.core.ops import DenseIO, RefExecutor, run_model
    for model, heads in (("gcn", 1), ("sage", 1), ("gat", 4)):
        cfg = DealConfig.from_dict({
            "graph": {"dataset": "rmat", "n_nodes": 512, "avg_degree": 8},
            "model": {"name": model, "n_layers": 2, "d_feature": 32,
                      "heads": heads},
            "executor": {"name": "cuda"}})
        with Session.build(cfg) as s:
            kops.reset_launch_counts()
            H = s.infer_all()
            assert H.is_cuda and H.shape == (512, 32)
            assert kops.launch_counts()["spmm"] == 2   # one a layer
            ios = [DenseIO.from_layer_graph(lg, s.device)
                   for lg in s.layer_graphs]
            want = run_model(RefExecutor(), model_spec(model, s.params),
                             ios, s.X)
            _close(H, want, 1e-4, 3e-3)


# (B, Sq, Skv, H, K, hd, q_offset, causal, window)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, 0, True, None),     # GQA, whole tiles
    (1, 37, 37, 6, 2, 64, 0, True, None),       # ragged S
    (2, 100, 100, 4, 4, 128, 0, True, 8),       # window; two threads a row
    (1, 21, 57, 4, 1, 32, 36, True, 16),        # q_offset; hd 32 padded to 64
    (2, 50, 70, 2, 2, 80, 0, False, None),      # cross attention; hd 80
    (1, 9, 40, 2, 1, 64, 100, True, 8),         # no live key: mean of v
    (1, 300, 300, 15, 5, 64, 0, True, 1 << 30),  # smollm heads, global
    (1, 70, 70, 8, 4, 256, 0, True, 32),        # gemma3: hd 256, local
    # the tensor-core kernel's edges: 64-row warpgroups, 128-row blocks and
    # 128-key tiles (64 for hd 256), one short of and one past each
    (1, 63, 63, 4, 2, 64, 0, True, None),
    (1, 65, 127, 4, 2, 128, 62, True, None),
    (2, 129, 129, 2, 1, 64, 0, True, None),
    (1, 127, 65, 4, 4, 64, 0, False, None),
    (1, 129, 257, 2, 2, 256, 128, True, None),
    (1, 100, 300, 4, 2, 64, 150, True, 60),     # window band crosses key 128
    (1, 70, 64, 2, 1, 128, 60, True, 4),        # rows 7.. have no live key
    # the f32 kernel's tiles: 64 query rows; 64 keys (32 for 64 < hd <=
    # 128); one short of and one past each, hd 4 and 36 (not multiples of
    # 8), hd 256 with a window
    (1, 65, 65, 4, 2, 64, 0, True, None),
    (2, 64, 63, 4, 2, 36, 0, False, None),
    (1, 63, 65, 2, 1, 4, 2, True, None),
    (1, 31, 33, 4, 2, 128, 0, False, None),
    (2, 33, 31, 2, 2, 100, 0, True, None),
    (1, 129, 129, 2, 1, 128, 0, True, 33),     # window across key tiles
    (1, 97, 95, 4, 2, 256, 0, True, 40),
    (1, 65, 63, 2, 2, 200, 0, False, None),
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,q_offset,causal,window",
                         FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, H, K, hd,
                                              q_offset, causal, window,
                                              dtype):
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    g = torch.Generator(device=cuda).manual_seed(Sq + hd)
    # q, k, v as strided views of one fused projection, as a model may
    # hold them: the kernel reads the strides and copies nothing.  Heads
    # sit a multiple of 8 columns apart, as the bf16 kernel's TMA loads
    # need (hd 4, 36 and 100 leave a gap after each head)
    hd8 = -(-hd // 8) * 8
    qkv = torch.randn((B, max(Sq, Skv), H + 2 * K, hd8), generator=g,
                      device=cuda).to(dtype)[..., :hd]
    q, k, v = (qkv[:, :Sq, :H], qkv[:, :Skv, H:H + K],
               qkv[:, :Skv, H + K:])
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    before = kops.launch_counts()["flash_attention"]
    before_tc = kops.flash_attention.launches_tc
    got = flash_attention_gqa(q, k, v, **kw)
    assert kops.launch_counts()["flash_attention"] == before + 1
    # bf16 runs on the tensor cores (every hd up to 256), f32 never
    assert kops.flash_attention.launches_tc == before_tc + int(
        dtype == torch.bfloat16)
    assert got.dtype == dtype and got.shape == (B, Sq, H, hd)
    _close(got, ref.gqa_attention_ref(q, k, v, **kw), ATOL[dtype])


@pytest.mark.parametrize("hd", [36, 37, 64, 128, 200])
def test_f32_flash_reads_misaligned_views_bitwise(cuda, hd):
    """The f32 kernel copies a view whose base or strides are not 16-byte
    aligned (or whose hd is not a multiple of 4) four bytes at a time,
    with the arithmetic of the 16-byte copies: the same bits as an
    aligned copy, and within tolerance of the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((2, 70, n, hd), generator=g, device=cuda)
               for n in (4, 2, 2))
    qo, ko, vo = (_misaligned(t) for t in (q, k, v))
    kw = dict(q_offset=3, causal=True, window=50)
    got = flash_attention_gqa(qo, ko, vo, **kw)
    assert torch.equal(got, flash_attention_gqa(q, k, v, **kw))
    _close(got, ref.gqa_attention_ref(q, k, v, **kw), ATOL[torch.float32])


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_f32_flash_is_deterministic(cuda, hd):
    """No atomics and no split over keys: two runs of the f32 kernel on
    the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    g = torch.Generator(device=cuda).manual_seed(hd + 1)
    q, k, v = (torch.randn((2, 300, n, hd), generator=g, device=cuda)
               for n in (6, 2, 2))
    first = flash_attention_gqa(q, k, v, causal=True)
    for _ in range(2):
        assert torch.equal(flash_attention_gqa(q, k, v, causal=True), first)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_pallas_signature(cuda, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((6, 200, 64), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before_tc = kops.flash_attention.launches_tc
    got = kops.flash_attention(q, k, v, causal=causal, block_q=64)
    assert got.shape == q.shape and got.dtype == dtype
    assert kops.flash_attention.launches_tc == before_tc + int(
        dtype == torch.bfloat16)
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal),
           ATOL[dtype])


# (B, Sq, Skv, H, K, hd, vd, q_offset, causal, window): v's head dim
# differs from q's.  MLA's 192 / 128 (the bf16 kernel's <192, 128> tile,
# the f32 kernel's Tile256v128), reduced MLA's 48 / 32, vd below hd in one
# tile (the bf16 kernel's second V box wholly past vd), vd above hd, hd 256
# over vd 128, widths that are not multiples of 8 in f32
FLASH_VD_CASES = [
    (2, 130, 130, 4, 4, 192, 128, 0, True, None),
    (1, 100, 150, 2, 1, 192, 128, 50, False, None),
    (1, 129, 129, 4, 2, 192, 128, 0, True, 40),
    (2, 70, 70, 4, 4, 48, 32, 0, True, None),
    (1, 65, 65, 2, 1, 128, 64, 0, True, None),
    (1, 65, 80, 2, 2, 64, 128, 10, True, None),
    (1, 50, 50, 2, 2, 256, 128, 0, True, 20),
    (1, 40, 40, 2, 2, 200, 104, 0, False, None),
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,vd,q_offset,causal,window",
                         FLASH_VD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_with_v_head_dim_unlike_q(cuda, B, Sq, Skv, H, K, hd,
                                                  vd, q_offset, causal,
                                                  window, dtype):
    """Both kernels with vd != hd against the plain version.  k and v are
    views of one (B, Skv, K, hd + vd) projection, v starting at column hd
    (as MLA's prefill reads it from its kv projection: no copy)."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    g = torch.Generator(device=cuda).manual_seed(hd + vd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    kv = torch.randn((B, Skv, K, hd + vd), generator=g,
                     device=cuda).to(dtype)
    k, v = kv[..., :hd], kv[..., hd:]
    kw = dict(q_offset=q_offset, causal=causal, window=window,
              scale=1.0 / (hd + 3) ** 0.5)
    before = kops.launch_counts()["flash_attention"]
    before_tc = kops.flash_attention.launches_tc
    got = flash_attention_gqa(q, k, v, **kw)
    assert kops.launch_counts()["flash_attention"] == before + 1
    assert kops.flash_attention.launches_tc == before_tc + int(
        dtype == torch.bfloat16)
    assert got.dtype == dtype and got.shape == (B, Sq, H, vd)
    _close(got, ref.gqa_attention_ref(q, k, v, **kw), ATOL[dtype])


@pytest.mark.parametrize("hd,vd", [(192, 128), (48, 32), (64, 100)])
def test_f32_flash_reads_a_misaligned_v_view_bitwise(cuda, hd, vd):
    """The f32 kernel with vd != hd reads a v whose base is not 16-byte
    aligned four bytes at a time: the same bits as an aligned v."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    g = torch.Generator(device=cuda).manual_seed(vd)
    q, k = (torch.randn((2, 70, n, hd), generator=g, device=cuda)
            for n in (4, 2))
    v = torch.randn((2, 70, 2, vd), generator=g, device=cuda)
    kw = dict(causal=True, window=50)
    got = flash_attention_gqa(q, k, _misaligned(v), **kw)
    assert torch.equal(got, flash_attention_gqa(q, k, v, **kw))
    _close(got, ref.gqa_attention_ref(q, k, v, **kw), ATOL[torch.float32])


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q = torch.randn((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="v head dim 320 outside"):
        flash_attention_gqa(q, q, torch.randn((1, 8, 2, 320), device=cuda))
    vb = torch.randn((1, 8, 2, 128), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_gqa(q.to(torch.bfloat16), q.to(torch.bfloat16),
                            _misaligned(vb))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_gqa(q.transpose(1, 3).contiguous().transpose(1, 3),
                            q, q)
    big = torch.randn((1, 8, 2, 320), device=cuda)
    with pytest.raises(ValueError, match="head dim 320"):
        flash_attention_gqa(big, big, big)
    with pytest.raises(TypeError, match="q is"):
        flash_attention_gqa(q, q.to(torch.bfloat16), q)
    # TMA's rules for the tensor-core kernel: raised, never re-routed
    qb = torch.randn((1, 8, 2, 68), device=cuda).to(torch.bfloat16)
    before = kops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention_gqa(qb[..., :64], qb[..., :64], qb[..., :64])
    flat = torch.zeros(1 + 8 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_gqa(odd, odd, odd)
    assert kops.launch_counts()["flash_attention"] == before


def test_prefill_step_cuda_matches_ref_on_the_card(cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.step import prefill_step
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              dtype="float32")
    params = init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 77), device=cuda)
    kops.reset_launch_counts()
    got, cache = prefill_step(cfg, params, {"tokens": tokens})
    assert kops.launch_counts()["flash_attention"] == cfg.n_layers
    assert kops.flash_attention.launches_tc == 0          # f32: FMA kernel
    want, want_cache = prefill_step(cfg, params, {"tokens": tokens},
                                    attn_backend="ref")
    assert kops.launch_counts()["flash_attention"] == cfg.n_layers
    _close(got, want, 1e-4, 3e-3)
    for name in ("k", "v"):
        _close(cache[name], want_cache[name], 1e-4, 3e-3)


def test_bf16_prefill_runs_flash_on_the_tensor_cores(cuda):
    """A bf16 prefill sends every layer's attention to the tensor-core
    kernel, and its logits stay close to "ref"'s (bf16 noise)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.step import prefill_step
    cfg = get_config("smollm-360m").reduced()
    assert cfg.dtype == "bfloat16"
    params = init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 130), device=cuda)
    kops.reset_launch_counts()
    got, _ = prefill_step(cfg, params, {"tokens": tokens})
    assert kops.flash_attention.launches_tc == cfg.n_layers
    want, _ = prefill_step(cfg, params, {"tokens": tokens},
                           attn_backend="ref")
    assert kops.flash_attention.launches_tc == cfg.n_layers
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, 0.1, 0.1)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_prefill_cuda_matches_ref_on_the_card(cuda, arch):
    """The moe family's f32 prefill through the kernels against "ref":
    one flash launch a layer (MLA's hd 48 / vd 32 for deepseek-v2),
    logits and every cache entry within the whole-model tolerance."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.step import prefill_step
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 77), device=cuda)
    kops.reset_launch_counts()
    got, cache = prefill_step(cfg, params, {"tokens": tokens})
    assert kops.launch_counts()["flash_attention"] == cfg.n_layers
    want, want_cache = prefill_step(cfg, params, {"tokens": tokens},
                                    attn_backend="ref")
    assert kops.launch_counts()["flash_attention"] == cfg.n_layers
    _close(got, want, 1e-4, 3e-3)
    assert set(cache) == set(want_cache)
    for name in cache:
        _close(cache[name], want_cache[name], 1e-4, 3e-3)


def test_moe_serving_decodes_on_the_card(cuda):
    """deepseek-v2's reduced config through the launcher on the card:
    every request finishes, and decode (MLA absorbed, in PyTorch) launches
    no flash kernel."""
    from repro_torch.launch import serve
    kops.reset_launch_counts()
    reqs, stats = serve.run("deepseek-v2-236b", n_requests=3, max_new=4,
                            batch_slots=2)
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert kops.launch_counts()["flash_attention"] == 0


def test_serve_engine_decodes_on_the_card(cuda):
    """The launcher on the card (params on cuda:0, the engine asked for
    "cuda"): every request finishes, and decode launches no flash kernel
    (the engine only decodes, as in JAX)."""
    from repro_torch.launch import serve
    kops.reset_launch_counts()
    reqs, stats = serve.run("smollm-360m", n_requests=5, max_new=6,
                            batch_slots=2)
    assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
    assert stats["tokens"] == 30
    assert kops.launch_counts()["flash_attention"] == 0


# ----------------------------------------------------------------------
# the wide scoring kernel (F > 32, or heads not a power of two up to 32)
# ----------------------------------------------------------------------

# (N, U, D, F, heads): F = 40 and 64, heads 3 and 6, and one narrow-width
# head count at F = 64; F = 32 with 3 heads, F = 33, 65 (three passes of
# 32 slots), 96 and 128; several rows a warp (F = 6: 4 rows, F = 1: 32)
# with N not a multiple of them
WIDE_CASES = [(40, 50, 96, 40, 3), (33, 45, 96, 64, 6), (64, 80, 128, 64, 4),
              (50, 61, 96, 8, 3), (40, 50, 48, 40, 6), (45, 50, 96, 32, 3),
              (40, 50, 128, 33, 4), (37, 60, 128, 65, 4),
              (30, 70, 64, 96, 2), (25, 90, 128, 128, 1),
              (61, 80, 96, 6, 3), (45, 40, 48, 1, 3)]


@pytest.mark.parametrize("N,U,D,F,heads", WIDE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_attention_kernel_matches_plain(cuda, N, U, D, F, heads,
                                             dtype):
    """The wide kernel against its plain version (f32 within 5e-7, bf16 at
    tests/test_kernels.py's tolerance), masked slots 0, an all-masked
    row 0, a fully live row summing to 1, row subsets and a misaligned
    view bitwise; sddmm at the same F."""
    g, nbr, mask = _graph(cuda, N, U, F, N + F + heads)
    mask[1] = True
    q = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((U, D), generator=g, device=cuda).to(dtype)
    before = (kops.gat_attention.launches_wide, kops.sddmm.launches_wide)
    alpha = kops.gat_attention(q, k, nbr, mask, heads=heads)
    e = kops.sddmm(q, k, nbr, mask)
    torch.cuda.synchronize()
    assert kops.gat_attention.launches_wide == before[0] + 1
    assert kops.sddmm.launches_wide == before[1] + (F > 32)
    strict = 5e-7 if dtype == torch.float32 else ATOL[dtype]
    _close(alpha, ref.gat_attention_ref(q, k, nbr, mask, heads), strict,
           0 if dtype == torch.float32 else 3e-2)
    _close(e, ref.sddmm_ref(q, k, nbr, mask), ATOL[dtype] * D ** 0.5)
    assert bool((alpha[~mask] == 0).all()) and bool((alpha[0] == 0).all())
    _close(alpha[1].sum(0), torch.ones(heads, device=cuda), 1e-5, 0)
    for rows in (torch.arange(3, N - 4, device=cuda),
                 torch.randperm(N, generator=g, device=cuda)[:N // 2]):
        part = kops.gat_attention(q[rows], k, nbr[rows], mask[rows],
                                  heads=heads)
        torch.cuda.synchronize()
        assert torch.equal(part, alpha[rows])
        assert torch.equal(kops.sddmm(q[rows], k, nbr[rows], mask[rows]),
                           e[rows])
    qo, ko = _misaligned(q), _misaligned(k)
    assert torch.equal(kops.gat_attention(qo, ko, nbr, mask, heads=heads),
                       alpha)
    assert torch.equal(kops.sddmm(qo, ko, nbr, mask), e)


@pytest.mark.parametrize("width", [96, 97])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_sddmm_reads_column_slices_in_place(cuda, width, dtype):
    """F = 64 takes the wide kernel: each per-head column slice (width 97
    leaves rows unaligned) gives the bits of its contiguous copy."""
    N, U, F, dh = 70, 90, 64, 32
    g, nbr, mask = _graph(cuda, N, U, F, width)
    qw = torch.randn((N, width), generator=g, device=cuda).to(dtype)
    kw = torch.randn((U, width), generator=g, device=cuda).to(dtype)
    before = kops.sddmm.launches_wide
    for h in range(3):
        q, k = qw[:, h * dh:(h + 1) * dh], kw[:, h * dh:(h + 1) * dh]
        assert not q.is_contiguous()
        got = kops.sddmm(q, k, nbr, mask)
        assert torch.equal(got, kops.sddmm(q.contiguous(), k.contiguous(),
                                           nbr, mask))
        _close(got, ref.sddmm_ref(q, k, nbr, mask), ATOL[dtype] * dh ** 0.5)
    assert kops.sddmm.launches_wide == before + 6


@pytest.mark.parametrize("F,heads", [(8, 4), (64, 4), (8, 3)])
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_masked_non_finite_rows_do_not_reach_the_scores(cuda, F, heads,
                                                        bad):
    """The kernel side of the masked-slot contract (README, "Numerics"):
    a k row of Inf or NaN reached only through masked slots leaves the
    output finite, equal to the plain version with that row zeroed; and
    sddmm writes +0.0 at a masked slot, where the plain version's
    ``dot * 0.0`` gives -0.0 for a negative dot."""
    N, U, D = 60, 40, 96
    g, nbr0, mask = _graph(cuda, N, U, F, F + heads)
    q = torch.randn((N, D), generator=g, device=cuda)
    k = torch.randn((U + 1, D), generator=g, device=cuda)
    k[U] = bad
    nbr = torch.where(mask, nbr0, torch.full_like(nbr0, U))
    alpha = kops.gat_attention(q, k, nbr, mask, heads=heads)
    e = kops.sddmm(q, k, nbr, mask)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(alpha).all()) and bool(
        torch.isfinite(e).all())
    k0 = k.clone()
    k0[U] = 0.0
    _close(alpha, ref.gat_attention_ref(q, k0, nbr, mask, heads), 5e-7, 0)
    _close(e, ref.sddmm_ref(q, k0, nbr, mask), ATOL[torch.float32]
           * D ** 0.5)
    assert not bool(torch.isfinite(ref.sddmm_ref(q, k, nbr, mask)).all())
    # signed zeros, with masked slots on real rows: the plain version's
    # negative dots times 0.0 give -0.0, the kernel writes +0.0
    plain = ref.sddmm_ref(q, k0, nbr0, mask)
    e0 = kops.sddmm(q, k0, nbr0, mask)
    torch.cuda.synchronize()
    assert bool(torch.signbit(plain[~mask]).any())
    assert not bool(torch.signbit(e0[~mask]).any())
    assert bool((e0[~mask] == 0).all())


def _gat_cfg(fanout, d_feature, heads, executor="cuda", n_nodes=512):
    from repro_torch.api import DealConfig
    return DealConfig.from_dict({
        "graph": {"dataset": "rmat", "n_nodes": n_nodes, "avg_degree": 40,
                  "fanout": fanout},
        "model": {"name": "gat", "n_layers": 2, "d_feature": d_feature,
                  "heads": heads},
        "executor": {"name": executor}})


@pytest.mark.parametrize("fanout,d_feature,heads,fused", [
    (64, 32, 4, True), (64, 32, 4, False), (8, 96, 3, True)])
def test_gat_session_at_wide_shapes_matches_ref(cuda, fanout, d_feature,
                                                heads, fused):
    """A gat config at fanout 64, or with 3 heads at d_feature 96, runs
    infer_all on "cuda" through the wide kernel and matches "ref"."""
    from repro_torch.api import Session
    from repro_torch.core.gnn_models import model_spec
    from repro_torch.core.ops import DenseIO, RefExecutor, run_model
    cfg = _gat_cfg(fanout, d_feature, heads)
    cfg.executor.options = {"fused_attention": fused}
    with Session.build(cfg) as s:
        kops.reset_launch_counts()
        H = s.infer_all()
        torch.cuda.synchronize()
        wide = (kops.gat_attention.launches_wide if fused
                else kops.sddmm.launches_wide)
        assert wide == (2 if fused else 2 * heads)
        ios = [DenseIO.from_layer_graph(lg, s.device)
               for lg in s.layer_graphs]
        want = run_model(RefExecutor(), model_spec("gat", s.params), ios,
                         s.X)
        _close(H, want, 1e-4, 3e-3)


@pytest.mark.parametrize("model,heads", [("gcn", 1), ("gat", 4)])
def test_serving_invariants_on_the_card(cuda, model, heads):
    """chip_smoke.py's [serve] checks at a small size: the delta refresh
    equals a fresh full epoch bitwise, chunked equals inline, a budgeted
    store serves the unbudgeted bytes, "cuda" matches "ref", and the
    refresh runs on gather_spmm (and gat_attention for gat)."""
    import copy

    from repro_torch.api import DealConfig, Session
    from repro_torch.gnnserve import DeltaReinference
    d = {"graph": {"dataset": "rmat", "n_nodes": 4096, "avg_degree": 8,
                   "fanout": 8},
         "model": {"name": model, "n_layers": 2, "d_feature": 32,
                   "heads": heads},
         "executor": {"name": "cuda"}, "store": {"onboarding": "tail"},
         "qos": {"staleness_bound": 1 << 30}}
    rng = np.random.default_rng(0)
    n = 4096
    batch = (rng.integers(0, n, (2, 64)), rng.integers(0, n, 16),
             rng.standard_normal((16, 32)).astype(np.float32))

    def mutate(s):
        log = s.apply_mutations()
        log.add_edges(*batch[0])
        log.update_features(batch[1], batch[2])
        log.add_nodes(4, np.ones((4, 32), np.float32))
        log.add_edges(np.arange(n, n + 4), np.arange(4))

    # the chunked engine refreshes one chunk a step under QoS: a tenant
    # whose SLO the mutations break demands it
    tenant = {"name": "t", "priority": 1.0, "slot_quota": 1, "rate": 0,
              "staleness_slo": 1}
    levels = {}
    for name, extra in (("inline", {}),
                        ("chunked", {"refresh": {"chunk_rows": 100},
                                     "qos": {"tenants": [tenant]}}),
                        ("budget", {"store": {"onboarding": "tail",
                                              "budget_rows": 1024}}),
                        ("ref", {"executor": {"name": "ref"}})):
        with Session.build(DealConfig.from_dict({**d, **extra})) as s:
            eng = s.serve()
            mutate(s)
            kops.reset_launch_counts()
            if name == "chunked":
                from repro_torch.gnnserve import Query
                eng.submit(Query(uid=0, node_ids=np.arange(8), tenant="t"))
                eng.run()
                assert eng.n_refresh_chunks > 2 and eng.log.pending == 0
            else:
                s.refresh()
            counts = kops.launch_counts()
            if name != "ref":
                assert counts["gather_spmm"] > 0, counts
                if model == "gat":
                    assert counts["gat_attention"] > 0, counts
            ids = np.arange(s.store.n_nodes)
            levels[name] = [s.store.lookup(ids, lvl)
                            for lvl in range(s.store.n_levels)]
            if name == "inline":
                oracle = DeltaReinference(
                    copy.deepcopy(s.reinfer.layer_graphs), model, s.params,
                    executor=s.executor).full_levels(levels[name][0])
                for lvl in range(1, len(oracle)):
                    assert np.array_equal(levels[name][lvl], oracle[lvl])
    for lvl, want in enumerate(levels["inline"]):
        assert np.array_equal(levels["chunked"][lvl], want)
        assert np.array_equal(levels["budget"][lvl], want)
        np.testing.assert_allclose(levels["ref"][lvl], want, atol=1e-4,
                                   rtol=3e-3)


def _small_world(n=2048, fanout=8, d=32, seed=0):
    from repro_torch.core.graph import csr_from_edges, rmat_edges
    from repro_torch.core.sampler import sample_layer_graphs
    src, dst = rmat_edges(n, 8 * n, seed=seed)
    lgs = sample_layer_graphs(csr_from_edges(src, dst, n), fanout=fanout,
                              n_layers=3, seed=seed)
    X = np.random.default_rng(seed).standard_normal((n, d),
                                                    dtype=np.float32)
    return lgs, X


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_local_engines_cuda_match_ref_on_the_card(cuda, model):
    """The layer-wise engines through the kernels against "ref" on the
    card, with each model's kernels launched."""
    from repro_torch.core import gnn_models
    from repro_torch.core.layerwise import LOCAL_ENGINES
    lgs, X = _small_world()
    gen = torch.Generator().manual_seed(0)
    dims = [32, 32, 32, 16]
    params = gnn_models.params_to(
        gnn_models.init_gat(gen, dims, heads=4) if model == "gat"
        else getattr(gnn_models, f"init_{model}")(gen, dims), cuda)
    kops.reset_launch_counts()
    got = LOCAL_ENGINES[model](lgs, X, params)
    counts = kops.launch_counts()
    want = LOCAL_ENGINES[model](lgs, X, params, executor="ref")
    assert got.device.type == "cuda" and got.shape == (2048, 16)
    _close(got, want, 1e-4, 3e-3)
    assert counts["spmm"] == 3, counts
    if model == "gat":
        assert counts["gat_attention"] == 3, counts


@pytest.mark.parametrize("F", [1, 7, 10, 25, 64])
def test_mean_weights_kernel_is_numpys_bitwise(cuda, F):
    """At 2^16 + 3 rows (ragged against every tile), with empty and
    all-live rows; and on a mask view one byte off a 16-byte boundary
    (the kernel's byte loads)."""
    from repro_torch.core.gnn_models import mean_weights
    rng = np.random.default_rng(F)
    mask = rng.random((2 ** 16 + 3, F)) < rng.random((2 ** 16 + 3, 1))
    mask[:5] = False
    mask[5:9] = True
    want = mean_weights(mask).view(np.uint32)
    before = kops.mean_weights.launches
    m = torch.as_tensor(mask, device=cuda)
    for view in (m, _misaligned(m)):
        got = kops.mean_weights(view)
        torch.cuda.synchronize()
        assert got.shape == mask.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      want)
    assert kops.mean_weights.launches == before + 2
    assert torch.equal(kops.mean_weights(m[:0]),
                       torch.empty((0, F), device=cuda))


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_epoch_builds_mean_weights_on_the_card(cuda, model):
    """One ``mean_weights`` launch a GraphSAGE layer and none in GAT; the
    ``io.h2d_bytes`` counter of an epoch is its ids', masks' and X's
    bytes, in GraphSAGE the host-built weights' R * F * 4 bytes a layer
    fewer than before, as its ``io.mean_w`` spans copy nothing."""
    from repro_torch import obs
    from repro_torch.core import gnn_models
    from repro_torch.core.layerwise import LOCAL_ENGINES
    lgs, X = _small_world()
    gen = torch.Generator().manual_seed(0)
    dims = [32, 32, 32, 16]
    params = gnn_models.params_to(
        gnn_models.init_gat(gen, dims, heads=4) if model == "gat"
        else gnn_models.init_sage(gen, dims), cuda)
    before = kops.mean_weights.launches
    tel = obs.Telemetry(enabled=True)
    with obs.use(tel):
        LOCAL_ENGINES[model](lgs, X, params)
    torch.cuda.synchronize()
    L = len(lgs) if model == "sage" else 0
    assert kops.mean_weights.launches == before + L
    assert tel.counters["io.h2d_bytes"] == sum(
        lg.nbr.size * (4 + 1) for lg in lgs) + X.nbytes
    spans = [ev for ev in tel.tracer.events_in_order()
             if ev[0] == "io.mean_w"]
    assert [a["h2d_bytes"] for *_, a in spans] == [0] * L


@pytest.mark.parametrize("batch_size", [100, 2048])
def test_ego_baseline_on_the_card_is_bitwise_layerwise(cuda, batch_size):
    from repro_torch.core import gnn_models
    from repro_torch.core.layerwise import (ego_batched_gcn_infer,
                                            local_gcn_infer)
    lgs, X = _small_world()
    params = gnn_models.params_to(gnn_models.init_gcn(
        torch.Generator().manual_seed(0), [32, 32, 32, 16]), cuda)
    want = local_gcn_infer(lgs, X, params)
    kops.reset_launch_counts()
    got, work = ego_batched_gcn_infer(lgs, X, params, batch_size)
    assert kops.launch_counts()["spmm"] >= 3
    assert got.device.type == "cuda"
    assert torch.equal(got, want)
    assert work >= 3 * 2048


def test_dump_trace_from_the_card_validates(cuda, tmp_path):
    """A traced serving run through the launcher's functions on the card:
    the trace (kernel builds included, under session.executor_build)
    passes the port's validator and report check at coverage 0.9."""
    import json

    from repro_torch.api import DealConfig
    from repro_torch.launch import serve_embeddings as se
    from repro_torch.obs import report
    from repro_torch.obs.validate import DEFAULT_CATS, validate_trace
    cfg = DealConfig.from_dict({
        "graph": {"dataset": "rmat", "n_nodes": 4096, "avg_degree": 8,
                  "fanout": 8},
        "model": {"name": "gcn", "n_layers": 2, "d_feature": 32},
        "executor": {"name": "cuda"}, "qos": {"staleness_bound": 8},
        "telemetry": {"enabled": True}})
    with se._serve_session(cfg) as s:
        se.drive(s.engine, ticks=4, mutations_per_tick=4)
        doc = s.dump_trace(tmp_path / "trace.json")
    assert doc == json.loads((tmp_path / "trace.json").read_text())
    problems, summary = validate_trace(
        doc, 0.9, tuple(DEFAULT_CATS.split(",")),
        ("serve.tick", "refresh.layer", "session.executor_build"))
    assert problems == [], problems
    assert report.check_trace(doc) == []


def _dist_cfg(model, executor="dist", p=4, m=2, **extra):
    d = {"graph": {"dataset": "rmat", "n_nodes": 4096, "avg_degree": 8,
                   "fanout": 8},
         "model": {"name": model, "n_layers": 2, "d_feature": 32},
         "partition": {"p": p, "m": m}, "executor": {"name": executor},
         "store": {"onboarding": "tail"},
         "qos": {"staleness_bound": 1 << 30}}
    d.update(extra)
    return d


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_dist_session_matches_cuda_on_the_card(cuda, model):
    """A 4 x 2 dist Session (8 shards on the card) against the
    single-card "cuda" Session with the same params, its shards'
    aggregation and scoring on the kernels; grouped and monolithic
    agree, and so do the kernels and their plain versions."""
    from repro_torch.api import DealConfig, Session
    from repro_torch.core.gnn_models import model_spec
    from repro_torch.core.ops import DistExecutor, run_model
    with Session.build(DealConfig.from_dict(_dist_cfg(model, "cuda"))) as s:
        want = s.infer_all()
        params = s.params
    with Session.build(DealConfig.from_dict(_dist_cfg(model)),
                       params=params) as s:
        kops.reset_launch_counts()
        got = s.infer_all()
        counts = kops.launch_counts()
        assert got.device.type == "cuda" and got.shape == want.shape
        _close(got, want, 1e-4, 3e-3)
        assert counts["spmm"] > 0, counts
        assert (counts["sddmm"] > 0) == (model == "gat"), counts
        spec = model_spec(model, params)
        ios = s.executor.bind(s.layer_graphs, need_sddmm=True)
        for kw in ({"grouped": False}, {"kernels": "ref"}):
            other = DistExecutor(s.executor.mesh, **kw)
            _close(run_model(other, spec, ios, s.X).to_global(), got,
                   1e-5, 1e-5)


def test_dist_refresh_is_bitwise_a_dist_full_epoch_on_the_card(cuda):
    """chip_smoke.py's [dist] serving check at a small size: with no
    cutover every level of the refreshed store equals a dist full epoch
    bitwise; the tail route launches gather_spmm, the mesh spmm."""
    from repro_torch.api import DealConfig, Session
    rng = np.random.default_rng(0)
    n = 4096
    with Session.build(DealConfig.from_dict(_dist_cfg("gcn"))) as s:
        s.serve()
        log = s.apply_mutations()
        log.add_edges(rng.integers(0, n, 64), rng.integers(0, n, 64))
        log.update_features(rng.choice(n, 16, replace=False),
                            rng.standard_normal((16, 32)).astype(np.float32))
        log.add_nodes(4, np.ones((4, 32), np.float32))
        log.add_edges(np.arange(n, n + 4), np.arange(4))
        log.add_edges(np.arange(4), np.arange(n, n + 4))
        kops.reset_launch_counts()
        s.refresh()
        counts = kops.launch_counts()
        assert counts["spmm"] > 0 and counts["gather_spmm"] > 0, counts
        ids = np.arange(s.store.n_nodes)
        levels = [s.store.lookup(ids, lvl) for lvl in range(3)]
        oracle = s.reinfer.full_levels(levels[0])
        for lvl in (1, 2):
            assert np.array_equal(levels[lvl], oracle[lvl]), lvl
        cut = s.stats()["refresh_cutover"]
        assert cut["n_tail"] > 0 and cut["n_dist"] > 0


def test_dist_shards_on_distinct_cards(cuda):
    """Shards placed round-robin over every visible card (messages
    between cards are peer copies) give the one-card result, grouped and
    monolithic.  Needs two or more cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.core import gnn_models
    from repro_torch.core.layerwise import DistributedLayerwise, LOCAL_ENGINES
    from repro_torch.launch.mesh import make_host_mesh
    lgs, X = _small_world()
    gen = torch.Generator().manual_seed(0)
    dims = [32, 32, 32, 16]
    mesh = make_host_mesh(4, 2)
    cards = min(torch.cuda.device_count(), 8)
    assert len(mesh.distinct_devices()) == cards
    for model in ("gcn", "gat"):
        params = gnn_models.params_to(
            gnn_models.init_gat(gen, dims, heads=1) if model == "gat"
            else gnn_models.init_gcn(gen, dims), cuda)
        want = LOCAL_ENGINES[model](lgs, X, params)
        for grouped in (True, False):
            got = DistributedLayerwise(mesh, lgs, model, params,
                                       grouped=grouped).infer(X)
            _close(got, want, 1e-4, 3e-3)


# ----------------------------------------------------------------------
# the block-size autotuner and the cluster tier on the card
# ----------------------------------------------------------------------

def test_autotune_over_the_real_grid_on_the_card(cuda, tmp_path,
                                                 monkeypatch):
    """``ensure_tuned`` over each spmm kernel's real grid, timed with
    CUDA events: every candidate's output is bitwise the default
    tiling's, the winner goes to the port's table file, and an executor
    bound to that file ("default") launches with it, bitwise the
    untuned executor."""
    from repro_torch import tuning
    from repro_torch.core.ops import CudaExecutor, DenseIO
    monkeypatch.delenv("REPRO_TUNING", raising=False)
    monkeypatch.setattr(tuning, "DEFAULT_TABLE_PATH",
                        tmp_path / "tuned_blocks_torch.json")
    R, U, D, F = 20000, 30000, 128, 8
    g, nbr, mask = _graph(cuda, R, U, F, 5)
    h = torch.randn((U, D), generator=g, device=cuda)
    w = torch.rand((R, F), generator=g, device=cuda)
    table = torch.randperm(U, generator=g, device=cuda).to(torch.int32)
    calls = {
        "spmm": lambda **kw: kops.spmm(h, w, nbr, mask, **kw),
        "gather_spmm": lambda **kw: kops.gather_spmm(h, table, w, nbr,
                                                     mask, **kw)}
    tb = tuning.resolve_block_table("default")
    for kernel, call in calls.items():
        base = call()
        outs = []

        def make_call(blocks, call=call, outs=outs):
            def fn():
                outs.append(call(**blocks))
            return fn

        blocks = tuning.ensure_tuned(tb, kernel, make_call, N=R, D=D)
        assert blocks in tuning.candidates(kernel, R, D)
        assert len(outs) >= len(tuning.candidates(kernel, R, D))
        torch.cuda.synchronize()
        for out in outs:
            assert torch.equal(out, base), kernel
    saved = tuning.BlockTable.load(tuning.DEFAULT_TABLE_PATH)
    assert set(saved.entries) == {
        f"{k}/cuda/float32/n32768/d128" for k in calls}
    io = DenseIO(nbr.cpu().numpy(), mask.cpu().numpy(),
                 table=table.cpu().numpy(), device=cuda)
    tuned = CudaExecutor(block_table="default")
    assert tuned._pick_blocks("gather_spmm", R, D, torch.float32) == \
        saved.lookup("gather_spmm", N=R, D=D)
    kops.reset_launch_counts()
    got = tuned.spmm(h, io.mean_w, io)
    assert kops.launch_counts()["gather_spmm"] == 1
    assert torch.equal(got, CudaExecutor().spmm(h, io.mean_w, io))


def _cluster_cfg(**cluster):
    return {"graph": {"dataset": "rmat", "n_nodes": 2048, "avg_degree": 8,
                      "fanout": 8, "seed": 1},
            "model": {"name": "gat", "n_layers": 2, "d_feature": 32,
                      "heads": 4},
            "executor": {"name": "cuda"},
            "store": {"onboarding": "tail"},
            "qos": {"staleness_bound": 1 << 30},
            "cluster": cluster}


@pytest.fixture(scope="module")
def cuda_cluster(tmp_path_factory):
    """A 2-shard "cuda" cluster (both workers on the card) beside a
    single-process "cuda" session on the same config."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.api import DealConfig, Session
    single = Session.build(DealConfig.from_dict(_cluster_cfg()))
    cluster = Session.build(DealConfig.from_dict(_cluster_cfg(
        n_shards=2, run_dir=str(tmp_path_factory.mktemp("cluster")))))
    try:
        yield single, single.serve(), cluster, cluster.serve()
    finally:
        procs = list(cluster.cluster.procs) if cluster.cluster else []
        cluster.close()
        single.close()
        assert all(p is None or p.poll() is not None for p in procs)


def test_cluster_serves_bitwise_a_single_process_on_the_card(cuda,
                                                             cuda_cluster):
    """Queries, one trickle commit (edge adds, feature updates, node
    adds) and queries again: the router's rows bitwise the single
    process's, every worker's store digest the single store's, and the
    workers launched gather_spmm and gat_attention on the card."""
    import hashlib
    from repro_torch.gnnserve import Query
    single, e1, cluster, e2 = cuda_cluster
    rng = np.random.default_rng(3)
    n = e1.store.n_nodes

    def queries(uid):
        for i in range(4):
            ids = rng.integers(0, e1.store.n_nodes, 64)
            q1, q2 = Query(uid + i, ids), Query(uid + i, ids.copy())
            e1.submit(q1), e2.submit(q2)
            e1.run(), e2.run()
            assert q1.served_version == q2.served_version
            assert np.array_equal(q1.out, q2.out)

    queries(0)
    for eng in (e1, e2):
        r = np.random.default_rng(9)
        log = eng.mutate()
        log.add_nodes(4, r.standard_normal((4, 32)).astype(np.float32))
        log.add_edges(r.integers(0, n, 32), r.integers(0, n, 32))
        log.add_edges(np.arange(n, n + 4), np.arange(4))
        log.update_features(np.arange(8),
                            r.standard_normal((8, 32)).astype(np.float32))
        eng.refresh()
    queries(100)
    st = e1.store
    ids = np.arange(st.n_nodes)
    want = {f"level{l}": hashlib.sha256(st.lookup(ids, l).tobytes())
            .hexdigest() for l in range(st.n_levels)}
    for d in cluster.cluster.router.digests():
        assert {k: v for k, v in d["digests"].items()
                if k.startswith("level")} == want
    for s in cluster.cluster.router.statuses():
        assert s["kernel_launches"]["gather_spmm"] > 0, s
        assert s["kernel_launches"]["gat_attention"] > 0, s
        assert s["memory"]["device_peak_bytes"] > 0


def test_cluster_kill_and_rejoin_on_the_card(cuda, cuda_cluster):
    """SIGKILL shard 1 after a commit, restart it: it restores its
    checkpoint on the card and every shard's digests are equal again."""
    _, e1, cluster, e2 = cuda_cluster
    for eng in (e1, e2):            # the same commit on both worlds
        eng.mutate().add_edges(np.arange(8), np.arange(8, 16))
        eng.refresh()
    dep = cluster.cluster
    before = dep.router.digests()
    dep.kill_worker(1)
    dep.restart_worker(1)
    after = dep.router.digests()
    assert after[0]["digests"] == after[1]["digests"] == \
        before[0]["digests"]
    st = dep.router.statuses()[1]
    assert st["restored"] and st["timings"]["restore_s"] > 0


# the [ssm] phase's attention: zamba2's hd 112 (the 128-column tiles
# zero-fill columns 112-127 and clip the store), whisper's non-causal
# encoder (ragged against the 128-key tiles) and its cross-attention
# (non-causal, Sq != Skv, Sq = 1 in decode)
SSM_FLASH_CASES = [   # B, Sq, Skv, H, K, hd, causal
    (2, 300, 300, 4, 4, 112, True),
    (1, 130, 130, 8, 2, 112, True),
    (2, 333, 333, 2, 2, 64, False),
    (2, 45, 300, 3, 3, 64, False),
    (3, 1, 300, 2, 2, 64, False),
    (1, 1, 129, 4, 4, 112, False),
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal", SSM_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_hd_112_and_non_causal(cuda, B, Sq, Skv, H, K, hd,
                                                  causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, Skv, K, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before_tc = kops.flash_attention.launches_tc
    got = flash_attention_gqa(q, k, v, causal=causal)
    assert kops.flash_attention.launches_tc == before_tc + int(
        dtype == torch.bfloat16)
    assert got.shape == (B, Sq, H, hd)
    tol = ATOL[dtype] if dtype == torch.float32 else 8e-3
    _close(got, ref.gqa_attention_ref(q, k, v, causal=causal), tol,
           3e-2 if dtype == torch.float32 else 1e-2)


def _to_card(params, dev):
    """A copy of a model's params on ``dev`` (the CPU model stays)."""
    import copy
    return copy.deepcopy(params).to(dev)


@pytest.mark.parametrize("arch,n_layers", [("mamba2-1.3b", 2),
                                           ("zamba2-7b", 5)])
def test_ssm_and_hybrid_on_the_card_match_the_cpu(cuda, arch, n_layers):
    """mamba2 and zamba2 (reduced; zamba2 at 5 layers: two super-blocks
    and a tail) in f32 on the card through "cuda" against the same model
    on the CPU: prefill logits and every cache entry, then three decode
    steps (the cache written in place on both)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              n_layers=n_layers)
    cpu = transformer.init_params(cfg, 0, device="cpu")
    card = _to_card(cpu, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 77),
                           generator=torch.Generator().manual_seed(1))
    kops.reset_launch_counts()
    got, _, cache = transformer.forward(cfg, card, {"tokens": tokens.to(cuda)},
                                        return_cache=True)
    n_attn = (transformer._hybrid_layout(cfg)[0] if cfg.family == "hybrid"
              else 0)
    assert kops.launch_counts()["flash_attention"] == n_attn
    want, _, want_cache = transformer.forward(cfg, cpu, {"tokens": tokens},
                                              return_cache=True)
    _close(got, want, 1e-4, 3e-3)

    def leaves(c):
        for n, v in c.items():
            yield from ((f"{n}.{f}", getattr(v, f)) for f in v._fields) \
                if isinstance(v, tuple) else [(n, v)]

    for (n, a), (_, b) in zip(leaves(cache), leaves(want_cache)):
        _close(a, b, 1e-4, 3e-3)
    dcache = transformer.init_cache(cfg, 2, 8, device=cuda)
    hcache = transformer.init_cache(cfg, 2, 8, device="cpu")
    for t in range(3):
        tok = tokens[:, t:t + 1]
        a, dcache = transformer.decode_step(cfg, card, dcache,
                                            {"token": tok.to(cuda), "pos": t})
        b, hcache = transformer.decode_step(cfg, cpu, hcache,
                                            {"token": tok, "pos": t})
        _close(a, b, 1e-4, 3e-3)


def test_whisper_decode_cross_attention_cuda_matches_ref(cuda):
    """whisper (reduced, f32) on the card: the prefill through "cuda"
    against "ref", then decode steps whose cross-attention (non-causal,
    one query against the 13 frames) takes the kernel, one launch a
    layer, against the same steps through "ref"."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("whisper-base").reduced(),
                              dtype="float32")
    params = transformer.init_params(cfg, 0)
    g = torch.Generator(device=cuda).manual_seed(2)
    batch = {"frames": torch.randn((2, 13, cfg.frontend_dim), generator=g,
                                   device=cuda),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 9), generator=g,
                                     device=cuda)}
    kops.reset_launch_counts()
    got, _, pre = transformer.forward(cfg, params, batch, return_cache=True)
    assert kops.launch_counts()["flash_attention"] == (
        cfg.n_encoder_layers + 2 * cfg.n_layers)
    want, _ = transformer.forward(cfg, params, batch, attn_backend="ref")
    _close(got, want, 1e-4, 3e-3)
    caches = {}
    for backend in ("cuda", "ref"):
        c = transformer.init_cache(cfg, 2, 12, 13, device=cuda)
        for n in ("k", "v"):
            c[n][:, :, :9] = pre[n]
        for n in ("cross_k", "cross_v"):
            c[n].copy_(pre[n])
        caches[backend] = c
    tok = got[:, -1].argmax(-1, keepdim=True)
    for t in range(3):
        kops.reset_launch_counts()
        a, _ = transformer.decode_step(cfg, params, caches["cuda"],
                                       {"token": tok, "pos": 9 + t},
                                       attn_backend="cuda")
        assert kops.launch_counts()["flash_attention"] == cfg.n_layers
        b, _ = transformer.decode_step(cfg, params, caches["ref"],
                                       {"token": tok, "pos": 9 + t},
                                       attn_backend="ref")
        assert kops.launch_counts()["flash_attention"] == cfg.n_layers
        _close(a, b, 1e-4, 3e-3)
        tok = b[:, -1].argmax(-1, keepdim=True)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_ssm_serving_decodes_on_the_card(cuda, arch):
    from repro_torch.launch import serve
    kops.reset_launch_counts()
    reqs, stats = serve.run(arch, n_requests=3, max_new=4, batch_slots=2)
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert kops.launch_counts()["flash_attention"] == 0


# ----------------------------------------------------------------------
# training: the flash kernel under autograd
# ----------------------------------------------------------------------

# B, Sq, Skv, H, K, hd, vd, q_offset, causal, window: causal GQA over
# several backward chunks, non-causal, cross-attention (Sq != Skv), a
# window, a q offset, and MLA's hd 192 / vd 128
FN_CASES = [(2, 1100, 1100, 6, 2, 64, 64, 0, True, None),
            (2, 300, 300, 4, 4, 64, 64, 0, False, None),
            (2, 48, 700, 4, 2, 64, 64, 0, False, None),
            (1, 600, 600, 4, 2, 128, 128, 0, True, 200),
            (1, 200, 700, 4, 1, 64, 64, 500, True, None),
            (1, 530, 530, 4, 4, 192, 128, 0, True, None)]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,vd,q_offset,causal,window",
                         FN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fn_forward_is_the_kernel_and_grads_are_plain(
        cuda, B, Sq, Skv, H, K, hd, vd, q_offset, causal, window, dtype):
    """Under autograd ``flash_attention_gqa`` goes through
    ``FlashAttentionFn``: its output is the kernel's, bit for bit, one
    launch (on the tensor cores in bf16); its q, k and v gradients are the
    plain version's autograd gradients within the kernel tolerances."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    g = torch.Generator(device=cuda).manual_seed(Sq + hd + vd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Skv, K, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Skv, K, vd), generator=g, device=cuda).to(dtype)
    go = torch.randn((B, Sq, H, vd), generator=g, device=cuda).to(dtype)
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    with torch.no_grad():
        kernel = flash_attention_gqa(q, k, v, **kw)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    kops.reset_launch_counts()
    out = flash_attention_gqa(*ins, **kw)
    assert kops.launch_counts()["flash_attention"] == 1
    assert kops.flash_attention.launches_tc == int(dtype == torch.bfloat16)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(out, kernel)
    got = torch.autograd.grad(out, ins, go)
    assert kops.launch_counts()["flash_attention"] == 1   # plain backward
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.gqa_attention_ref(*ref_ins, **kw),
                               ref_ins, go)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert float(a.float().abs().max()) > 0
        _close(a, b, *({torch.float32: (2e-5, 3e-2),
                        torch.bfloat16: (8e-3, 1e-2)}[dtype]))


def test_flash_launch_refuses_an_input_that_requires_grad(cuda):
    """No kernel result reaches autograd without its backward: the
    launch itself raises on an input that requires grad with grad mode
    on; under ``no_grad`` the same tensors launch."""
    from repro_torch.kernels import flash_attention as kflash
    q = torch.randn((1, 64, 2, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 64, 2, 64), device=cuda)
    kw = dict(q_offset=0, causal=True, window=None, scale=0.125)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        kflash._launch(q, k, k, **kw)
    with torch.no_grad():
        out = kflash._launch(q, k, k, **kw)
    assert not out.requires_grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_cuda_matches_ref_on_the_card(cuda, dtype):
    """One training step at a small width: "cuda" launches the flash
    kernel twice a layer (the forward and the checkpointed layer's
    recompute), "ref" never; the loss and every gradient agree (f32: atol
    1e-5, rtol 1e-3; bf16: atol 2e-2, rtol 2e-2), the attention
    projections' gradients are nonzero, and ``train_step`` moves the
    params."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train import optimizer, step
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              dtype=dtype)
    params = init_params(cfg, 0).requires_grad_(True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = {n: torch.randint(0, cfg.vocab_size, (2, 300), generator=gen,
                              device=cuda) for n in ("tokens", "labels")}
    out = {}
    for backend in ("cuda", "ref"):
        kops.reset_launch_counts()
        out[backend] = step.loss_and_grads(cfg, params, batch,
                                           attn_backend=backend)
        want = 2 * cfg.n_layers if backend == "cuda" else 0
        assert kops.launch_counts()["flash_attention"] == want
        assert kops.flash_attention.launches_tc == (
            want if dtype == "bfloat16" else 0)
    (lc, _), gc = out["cuda"]
    (lr_, _), gr = out["ref"]
    tol = (1e-5, 1e-3) if dtype == "float32" else (2e-2, 2e-2)
    _close(lc, lr_, 1e-5 if dtype == "float32" else 2e-2, 1e-4)
    for name, g in gc.items():
        _close(g, gr[name], *tol)
    assert float(gc["blocks.0.attn.wq"].float().abs().max()) > 0
    opt_cfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    before = params.blocks[0].attn.wk.detach().clone()
    _, opt, metrics = step.train_step(cfg, opt_cfg, params,
                                      optimizer.init_opt_state(params,
                                                               opt_cfg),
                                      batch)
    assert int(opt.step) == 1 and bool(torch.isfinite(metrics["loss"]))
    assert not torch.equal(before, params.blocks[0].attn.wk)


# ----------------------------------------------------------------------
# the dry-run's predictions and the mesh paths on one card
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dryrun_argument_bytes_match_the_card(cuda, kind):
    """The dry-run's per-chip argument bytes on the card mesh against
    the bytes the same arguments request of the card's caching
    allocator, within 1% + 2 MiB (its blocks round a request up)."""
    import dataclasses

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import init_params
    from repro_torch.train import optimizer
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              dtype="bfloat16")
    shape = InputShape("t", 256, 4, kind)
    rec = dryrun.dry_run(cfg, shape, "card")
    torch.cuda.synchronize()
    def requested():
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    base = requested()
    params = init_params(cfg, 0, device=cuda)
    batch = {n: torch.zeros((4, 256), dtype=torch.int32, device=cuda)
             for n in (("tokens", "labels") if kind == "train"
                       else ("tokens",))}
    opt = (optimizer.init_opt_state(params, optimizer.AdamWConfig())
           if kind == "train" else None)
    grown = requested() - base
    want = rec["memory_analysis"]["argument_size_in_bytes"]
    assert abs(grown - want) <= 0.01 * want + 2 * 2**20, (grown, want)
    del params, batch, opt


def test_moe_ep_on_a_one_card_mesh(cuda, monkeypatch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.context import sharding_context
    cfg = get_config("deepseek-v2-236b").reduced()
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=64.0))
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init_moe_params(gen, cfg, torch.float32)
    x = torch.randn((4, 8, cfg.d_model), generator=gen, device=cuda) * 0.5
    want, want_aux = moe.moe_block(x, p, cfg)
    monkeypatch.setenv("REPRO_TUNING", "moe_ep")
    with sharding_context(make_host_mesh(1, 4, device=cuda)):
        got, aux = moe.moe_block(x, p, cfg)
    _close(got, want, 1e-4, 0)
    _close(aux, want_aux, 1e-6, 0)


@pytest.mark.parametrize("window", [None, 7])
def test_cp_decode_on_a_one_card_mesh(cuda, window):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, kc, vc = (torch.randn(s, generator=gen, device=cuda)
                 for s in ((1, 1, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)))
    want = attention.decode_attention(q, kc, vc, cache_len=49, window=window)
    got = attention.cp_decode_attention(
        q, kc, vc, cache_len=49, window=window,
        mesh=make_host_mesh(8, 1, device=cuda))
    _close(got, want, 2e-5, 0)


# ----------------------------------------------------------------------
# placement across cards (sharding.placement)
# ----------------------------------------------------------------------

def _four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    return [torch.device("cuda", i) for i in range(4)]


def _placed_run(path, mesh, monkeypatch):
    """One placed path on ``mesh`` at a reduced width in f32: "decode"
    (zamba2, B=1, cp_decode, 3 steps from S - 4), "prefill" (deepseek-v2
    under moe_ep, 2 x 12) or "train" (smollm-360m, one data-parallel
    step).  Returns {name: tensor on the CPU}."""
    import dataclasses

    from repro_torch.configs import InputShape, get_config
    from repro_torch.models import transformer
    from repro_torch.serve.step import prefill_step
    from repro_torch.sharding import placement, specs
    from repro_torch.sharding.context import sharding_context
    from repro_torch.train import optimizer, step
    arch = {"decode": "zamba2-7b", "prefill": "deepseek-v2-236b",
            "train": "smollm-360m"}[path]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if path == "prefill":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=64.0))
    home = mesh.home
    params = transformer.init_params(cfg, 0, device=home)
    pspecs = specs.param_specs(cfg, params, mesh)
    out = {}
    with sharding_context(mesh):
        if path == "decode":
            monkeypatch.setenv("REPRO_TUNING", "cp_decode")
            S = 64
            cache = transformer.init_cache(cfg, 1, S, device="cpu")
            gen = torch.Generator().manual_seed(1)
            for t in (cache["k"], cache["v"], *cache["mamba"],
                      *cache["tail"]):
                t.copy_(torch.randn(t.shape, generator=gen))
            cache["k"][:, :, S - 4:] = 0
            cache["v"][:, :, S - 4:] = 0
            cspecs = specs.cache_specs(cfg, cache, mesh,
                                       InputShape("d", S, 1, "decode"))
            cache = placement.place_tree(
                {k: (v.to(home) if isinstance(v, torch.Tensor) else
                     type(v)(*(t.to(home) for t in v)))
                 for k, v in cache.items()}, cspecs, mesh)
            pp = placement.place_module(params, pspecs, mesh)
            for t in range(3):
                lg, _ = transformer.decode_step(
                    cfg, pp, cache, {"token": torch.tensor([[5 + t]]),
                                     "pos": S - 4 + t})
                out[f"logits{t}"] = lg.cpu()
            for k, v in placement.gather_tree(cache, "cpu").items():
                for f, t in (v._asdict().items() if isinstance(v, tuple)
                             else [("", v)]):
                    out[f"{k}.{f}"] = t
        elif path == "prefill":
            monkeypatch.setenv("REPRO_TUNING", "moe_ep")
            tok = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (2, 12)))
            pp = placement.place_module(params, pspecs, mesh)
            lg, cache = prefill_step(cfg, pp, {"tokens": tok},
                                     attn_backend="ref")
            out["logits"] = lg.cpu()
            out.update({k: v.cpu() for k, v in cache.items()})
        else:
            opt_cfg = optimizer.AdamWConfig()
            opt = placement.place_tree(
                optimizer.init_opt_state(params, opt_cfg),
                optimizer.OptState((), pspecs, pspecs), mesh)
            pp = placement.place_module(params, pspecs, mesh)
            rng = np.random.default_rng(0)
            batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                      (4, 32)))
                     for k in ("tokens", "labels")}
            _, grads = step.placed_loss_and_grads(cfg, pp, batch,
                                                  attn_backend="cuda")
            want = transformer.init_params(cfg, 0, device=home)
            optimizer.adamw_update(
                want, {n: placement.gather(g) for n, g in grads.items()},
                optimizer.init_opt_state(want, opt_cfg), opt_cfg,
                step.decay_mask(cfg, want))
            pp, opt, m = step.train_step(cfg, opt_cfg, pp, opt, batch,
                                         attn_backend="cuda")
            out["loss"] = m["loss"].cpu()
            for (n, t), (_, w), (_, p0) in zip(
                    placement.gather_tree(pp, "cpu").named_parameters(),
                    want.named_parameters(), params.named_parameters()):
                out[n] = t
                out[f"change.{n}"] = t - p0.detach().cpu()
                out[f"adamw.{n}"] = (w - p0).detach().cpu()
    return out, dict(mesh.sent)


PLACED_MESHES = {"decode": (4, 1), "prefill": (1, 4), "train": (4, 1)}


@pytest.mark.parametrize("path", ["decode", "prefill", "train"])
def test_placed_path_on_one_card_matches_no_mesh(cuda, path, monkeypatch):
    """Each placed path with every shard on one card against the same
    inputs on a (1, 1) mesh: within 2e-5 (train: the loss within 1e-5,
    rtol 1e-4, the params after AdamW within 1e-4).  Train: each param's
    change in the step against ``adamw_update``'s on the gathered
    gradients, within 5% of the first step's update (lr 3e-6 an
    element), on both meshes."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import optimizer
    P, M = PLACED_MESHES[path]
    card = torch.device("cuda", 0)
    got, sent = _placed_run(path, Mesh(P, M, [card] * (P * M)),
                            monkeypatch)
    want, _ = _placed_run(path, Mesh(1, 1, [card]), monkeypatch)
    for n, t in want.items():
        if n.startswith(("change.", "adamw.")):
            continue
        tol = dict(atol=1e-4) if path == "train" and n != "loss" else dict(
            atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(got[n].float().numpy(),
                                   t.float().numpy(), **tol, err_msg=n)
    assert sent.get("experts", 0) == 0
    if path == "train":
        lr1 = float(optimizer.lr_schedule(1, optimizer.AdamWConfig()))
        for run in (got, want):
            moved = 0.0
            for n in [k for k in run if k.startswith("adamw.")]:
                ref_change = run[n]
                np.testing.assert_allclose(
                    run["change." + n[6:]].numpy(), ref_change.numpy(),
                    atol=1e-8, rtol=5e-2, err_msg=n)
                moved = max(moved, float(ref_change.abs().max()))
            assert moved >= 0.5 * lr1


@pytest.mark.parametrize("path", ["decode", "prefill", "train"])
def test_placed_path_across_cards_is_bitwise_the_one_card_mesh(
        cuda, path, monkeypatch):
    """The same mesh with its shards on four distinct cards against every
    shard on card 0: the same ops on the same blocks, so the same bits,
    and the same bytes copied between shards."""
    from repro_torch.launch.mesh import Mesh
    cards = _four_cards()
    P, M = PLACED_MESHES[path]
    got, sent = _placed_run(path, Mesh(P, M, cards), monkeypatch)
    want, want_sent = _placed_run(path, Mesh(P, M, [cards[0]] * 4),
                                  monkeypatch)
    for n, t in want.items():
        assert torch.equal(got[n], t), n
    assert sent == want_sent


def test_placed_bytes_on_each_card_are_per_chip_bytes(cuda):
    """smollm-360m's params and f32 AdamW state placed on a 4 x 1 mesh
    over four cards: each card's allocator holds exactly
    ``per_chip_bytes`` more than before (requested bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.sharding import placement, specs
    from repro_torch.train import optimizer
    cards = _four_cards()
    mesh = make_host_mesh(4, 1)
    assert mesh.devices == cards
    cfg = get_config("smollm-360m")
    params = transformer.init_params(cfg, 0, device="cpu")
    pspecs = specs.param_specs(cfg, params, mesh)
    opt = optimizer.init_opt_state(params, optimizer.AdamWConfig())
    ospecs = optimizer.OptState((), pspecs, pspecs)
    for d in cards:
        torch.cuda.synchronize(d)
    before = [torch.cuda.memory_stats(d)["requested_bytes.all.current"]
              for d in cards]
    placed = (placement.place_module(params, pspecs, mesh),
              placement.place_tree(opt, ospecs, mesh))
    for d in cards:
        torch.cuda.synchronize(d)
    after = [torch.cuda.memory_stats(d)["requested_bytes.all.current"]
             for d in cards]
    want = (specs.per_chip_bytes(params, pspecs, mesh)
            + specs.per_chip_bytes(opt, ospecs, mesh))
    assert [a - b for a, b in zip(after, before)] == [want] * 4
    assert placement.shard_bytes(placed) == [want] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_first_launch_on_the_fourth_card(cuda, dtype):
    """Both flash kernels' first launch on card 3 (the tensor-core one
    builds its TMA maps from card 3's addresses): the kernel against its
    plain version there."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    card = _four_cards()[3]
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn((2, 256, 15, 64), generator=g, device=card).to(dtype)
    k, v = (torch.randn((2, 256, 5, 64), generator=g, device=card).to(dtype)
            for _ in range(2))
    kops.reset_launch_counts()
    with torch.no_grad():
        got = flash_attention_gqa(q, k, v, causal=True)
    assert kops.launch_counts()["flash_attention"] == 1
    assert got.device == card
    want = ref.gqa_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize(card)
    _close(got, want, *({torch.float32: (2e-5, 3e-2),
                         torch.bfloat16: (8e-3, 1e-2)}[dtype]))
