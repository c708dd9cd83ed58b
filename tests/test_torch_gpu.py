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


@pytest.mark.parametrize("R,U,D,F", [(16, 16, 128, 4), (23, 37, 20, 6),
                                     (64, 80, 96, 16), (1000, 900, 7, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused_table", [False, True])
def test_spmm_kernels_match_plain(cuda, R, U, D, F, dtype, fused_table):
    g, nbr, mask = _graph(cuda, R, U, F, R + D)
    h = torch.randn((U, D), generator=g, device=cuda).to(dtype)
    w = torch.randn((R, F), generator=g, device=cuda)      # always f32
    before = kops.launch_counts()
    if fused_table:
        table = torch.randperm(U, generator=g, device=cuda).to(torch.int32)
        got = kops.gather_spmm(h, table, w, nbr, mask)
        want = ref.gather_spmm_ref(h, table, w, nbr, mask)
        other = kops.gather_spmm(h, table, w, nbr, mask, block_rows=3,
                                 block_cols=2)
        name = "gather_spmm"
    else:
        got = kops.spmm(h, w, nbr, mask)
        want = ref.spmm_ref(h, w, nbr, mask)
        other = kops.spmm(h, w, nbr, mask, block_rows=3, block_cols=2)
        name = "spmm"
    assert got.dtype == dtype and got.shape == (R, D)
    _close(got, want, ATOL[dtype] * F)
    assert torch.equal(got, other)               # tiling-invariant bits
    assert kops.launch_counts()[name] == before[name] + 2


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
            assert kops.launch_counts()["spmm"] == 2 * heads
            ios = [DenseIO.from_layer_graph(lg, s.device)
                   for lg in s.layer_graphs]
            want = run_model(RefExecutor(), model_spec(model, s.params),
                             ios, s.X)
            _close(H, want, 1e-4, 3e-3)
