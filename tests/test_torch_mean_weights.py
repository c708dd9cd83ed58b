"""The mean-aggregation weights built from the bound mask
(``kernels.mean_weights``, ``DenseIO.mean_w``) on the CPU: the plain
version and the binding's weights are bitwise numpy's
``core.gnn_models.mean_weights``, on rows with no live slot, rows all
live and a row count that is not a multiple of the kernel's tile; the
tile the wrapper picks fits the kernel.  The kernel itself is held to
numpy on the card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.gnn_models import mean_weights  # noqa: E402
from repro_torch.core.ops import DenseIO  # noqa: E402
from repro_torch.kernels import mean_weights as mw  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

FANOUTS = (1, 10, 25, 64)


def _mask(F, live, seed=0):
    """A mask of 2 tiles and 3 rows: row 0 empty, row 1 all live, the
    rest live with probability ``live``."""
    R = 2 * mw.tile_rows(F) + 3
    mask = np.random.default_rng(seed).random((R, F)) < live
    mask[0] = False
    mask[1] = True
    return mask


def _same_bits(got, want):
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("live", [0.15, 0.5, 0.95])
@pytest.mark.parametrize("F", FANOUTS)
def test_plain_version_is_numpys_bitwise(F, live):
    mask = _mask(F, live)
    got = ref.mean_weights_ref(torch.as_tensor(mask)).numpy()
    _same_bits(got, mean_weights(mask))


@pytest.mark.parametrize("F", FANOUTS)
def test_dense_io_mean_w_on_the_cpu_is_numpys_bitwise(F):
    mask = _mask(F, 0.5, seed=F)
    nbr = np.zeros(mask.shape, np.int32)
    before = kops.mean_weights.launches
    io = DenseIO(nbr, mask, device="cpu")
    _same_bits(io.mean_w.numpy(), mean_weights(mask))
    assert io.mean_w is io.mean_w                     # built once
    assert kops.mean_weights.launches == before       # the CPU: plain


def test_f32_quotient_is_the_f64_quotient_rounded():
    """1 / d divided in f32 has the bits of 1 / d divided in f64 and
    rounded to f32, for every degree 1..4096: the kernel could divide
    either way and give numpy's weights."""
    d = np.arange(1, 4097)
    _same_bits(np.float32(1) / d.astype(np.float32),
               (1.0 / d).astype(np.float32))
    _same_bits((1 / torch.arange(1, 4097, dtype=torch.float32)).numpy(),
               (1.0 / d).astype(np.float32))


@pytest.mark.parametrize("F", [1, 3, 10, 25, 64, 1000, mw.MAX_FANOUT])
def test_a_tile_fits_the_kernel(F):
    """A multiple of 4 rows (each tile's output 16-byte aligned), at least
    4, and its mask bytes, padded to 16, and a float a row within 48 KiB
    of shared memory, as ``deal_mean_weights`` checks; at fanouts up to
    512, a multiple of 16 rows, so that every tile's mask bytes start
    16-byte aligned (the kernel's 16-byte loads)."""
    rows = mw.tile_rows(F)
    assert rows >= 4 and rows % 4 == 0
    if F <= mw.TILE_SLOTS // 16:
        assert rows % 16 == 0 and rows * F % 16 == 0
    assert -(-rows * F // 16) * 16 + 4 * rows <= 48 * 1024
    assert rows * F <= mw.TILE_SLOTS or rows == 4


def test_wrapper_takes_a_2d_mask_and_returns_empty_shapes():
    with pytest.raises(ValueError, match=r"\(R, F\)"):
        kops.mean_weights(torch.ones(4, dtype=torch.bool))
    for shape in ((0, 5), (3, 0)):
        got = kops.mean_weights(torch.zeros(shape, dtype=torch.bool))
        assert got.shape == shape and got.dtype == torch.float32


def test_reset_launch_counts_zeroes_mean_weights():
    kops.mean_weights.launches = 3
    kops.reset_launch_counts()
    assert kops.mean_weights.launches == 0
    assert "mean_weights" not in kops.launch_counts()   # no TPU kernel
