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
    q = torch.zeros((1, 4, 2, 64), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kflash.flash_attention_gqa(q, q, q)
