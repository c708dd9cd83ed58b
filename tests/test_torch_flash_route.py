"""Which flash kernel a call takes, and what the tensor-core kernel's TMA
loads accept, checked on the CPU: the route is a rule on (dtype, hd,
device) alone, and the alignment check reads only shapes, strides and
addresses, so neither needs a card."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,device,want", [
    (BF16, CUDA, "tc"),        # every hd up to 256 on the tensor cores
    (F32, CUDA, "simt"),       # f32 stays on the f32-FMA kernel
    (BF16, CPU, "plain"),      # CPU tensors: the plain version only
    (F32, CPU, "plain"),
])
def test_route_is_a_rule_on_dtype_and_device(dtype, device, want):
    assert kflash.route(dtype, device) == want


def _bf16(*shape):
    return torch.zeros(shape, dtype=BF16)


@pytest.mark.parametrize("make,want", [
    (lambda: _bf16(2, 5, 3, 64), [960, 192, 64]),            # contiguous
    # q, k and v as views of one fused projection (H + 2K heads)
    (lambda: _bf16(2, 9, 8, 64)[:, :7, :4], [4608, 512, 64]),
    (lambda: _bf16(2, 9, 8, 64)[:, :, 6:], [4608, 512, 64]),
    # the Pallas signature, (BH, S, hd) with a head axis of size 1
    (lambda: _bf16(6, 10, 64)[:, :, None], [640, 64, 64]),
    # a size-1 axis's stride is never stepped along: a contiguous one
    # stands in for it (heads outside seq: any order of strides reads)
    (lambda: _bf16(3, 1, 7, 64).permute(1, 2, 0, 3), [1344, 64, 448]),
    (lambda: _bf16(4, 8, 3, 32)[:, :, 1:2], [768, 96, 32]),
])
def test_tma_strides_of_views_the_model_makes(make, want):
    assert kflash.tma_strides(make(), "q") == want


@pytest.mark.parametrize("make,match", [
    (lambda: _bf16(2, 5, 3, 68)[..., :64], "multiples of 8"),   # hd pitch
    (lambda: _bf16(2, 5, 3, 60), "multiples of 8"),             # hd 60
    (lambda: _bf16(2, 5, 196)[:, :, :192].unflatten(-1, (3, 64)),
     "multiples of 8"),                                         # seq pitch
    (lambda: _bf16(1 + 5 * 3 * 64)[1:].view(1, 5, 3, 64),
     "16-byte aligned"),
    (lambda: _bf16(8 + 5 * 3 * 64)[4:4 + 5 * 3 * 64].view(1, 5, 3, 64),
     "16-byte aligned"),
])
def test_tma_strides_refuse_what_tma_cannot_read(make, match):
    t = make()
    if match == "multiples of 8" and all(s % 8 == 0 for s in t.stride()[:3]):
        pytest.fail(f"case does not break the rule: {t.stride()}")
    with pytest.raises(ValueError, match=match):
        kflash.tma_strides(t, "k")


def test_cpu_calls_count_no_launch_and_reset_zeroes_the_tc_count():
    kops.reset_launch_counts()
    q = torch.zeros((1, 4, 2, 64), dtype=BF16)
    kflash.flash_attention_gqa(q, q, q)
    kflash.flash_attention(q[:, :, 0], q[:, :, 0], q[:, :, 0])
    assert kops.launch_counts()["flash_attention"] == 0
    assert kops.flash_attention.launches_tc == 0
    kops.flash_attention.launches_tc = 5
    kops.reset_launch_counts()
    assert kops.flash_attention.launches_tc == 0


def test_no_kernel_for_a_device_that_is_neither_cpu_nor_cuda():
    """The launcher refuses any device but a card; a meta tensor (the
    dry-run's trace) reaches the shape-only op, which launches nothing."""
    q = torch.zeros((1, 4, 2, 64), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kflash._launch(q, q, q, q_offset=0, causal=True, window=None,
                       scale=1.0)
    kops.reset_launch_counts()
    out = kflash.flash_attention_gqa(q, q, q)
    assert out.is_meta and tuple(out.shape) == (1, 4, 2, 64)
    assert kops.launch_counts()["flash_attention"] == 0


# the f32 kernel's tiles (csrc/flash_attention.cu Tile64 / Tile128 /
# Tile256), mirrored by simt_tiling: 64 query rows a block throughout
SMEM_MAX = 232448                  # a block's shared memory, 227 KB


@pytest.mark.parametrize("hd", range(1, 257))
def test_every_head_dim_gets_a_tile_that_fits(hd):
    t = kflash.simt_tiling(hd)
    assert t.smem <= SMEM_MAX and t.threads in (128, 256)
    assert t.rows == t.threads // 16 * t.tm and t.keys == 16 * t.tn
    hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
    assert t.smem == 4 * ((t.rows + 2 * t.keys) * (hdp + 4)
                          + t.keys * (t.rows + 4))


@pytest.mark.parametrize("hd,want", [(1, (64, 64, 128)), (64, (64, 64, 128)),
                                     (65, (64, 32, 128)),
                                     (128, (64, 32, 128)),
                                     (129, (64, 64, 256)),
                                     (256, (64, 64, 256))])
def test_simt_tiling_by_head_dim(hd, want):
    t = kflash.simt_tiling(hd)
    assert (t.rows, t.keys, t.threads) == want


def test_simt_tiling_mirrors_the_c_tiles():
    """simt_tiling's (TM, TN, threads) are the ones the C entry's Tile64,
    Tile128 and Tile256 declare (read from the source)."""
    import re
    from pathlib import Path
    src = (Path(kflash.__file__).parent / "csrc" /
           "flash_attention.cu").read_text()
    for name, hd in (("Tile64", 64), ("Tile128", 128), ("Tile256", 256)):
        m = re.search(rf"using {name} = Tile<(\d+), (\d+), (\d+), (\d+)",
                      src)
        hdp, tm, tn, ty = map(int, m.groups())
        t = kflash.simt_tiling(hd)
        assert (hdp, t.tm, t.tn, t.threads) == (hd, tm, tn, 16 * ty)


@pytest.mark.parametrize("hd", [1, 64, 65, 128, 256])
def test_the_query_row_limit_follows_the_row_tile(hd):
    assert kflash.max_query_rows(hd) == 65535 * kflash.simt_tiling(hd).rows


@pytest.mark.parametrize("hd", [0, 257])
def test_simt_tiling_refuses_head_dims_past_the_kernel(hd):
    with pytest.raises(ValueError, match="outside 1..256"):
        kflash.simt_tiling(hd)
