"""The binding's staging ring (``core.ops``): host arrays bound to a card
cross through page-locked buffers a chunk at a time.  On the CPU: the
chunk plan, and which arrays take the ring (C-contiguous host arrays of
at least ``STAGE_MIN_BYTES`` bound to a CUDA device) and which keep the
plain copy, with ``io.h2d_staged_bytes`` at 0.  Marked ``gpu`` (skip
without a card): the ring's tensors bitwise ``torch.as_tensor``'s, the
counters, nothing kept across calls, and no device memory beyond the
result's own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import ops  # noqa: E402

CUDA = torch.device("cuda")
C = 1 << 12


@pytest.mark.parametrize("itemsize", [1, 4, 8])
@pytest.mark.parametrize("n_bytes", [8, C - 8, C, 3 * C, 3 * C + 8,
                                     7 * C - 16])
def test_chunk_plan_covers_every_element_once_in_whole_chunks(itemsize,
                                                              n_bytes):
    n = n_bytes // itemsize
    plan = ops.chunk_plan(n, itemsize, C)
    assert plan[0][0] == 0 and plan[-1][1] == n
    assert all(a < b for a, b in plan)
    assert all(b == a2 for (_, b), (a2, _) in zip(plan, plan[1:]))
    assert all((b - a) * itemsize <= C for a, b in plan)
    # every chunk but the last is full: the fewest chunks
    assert all((b - a) * itemsize == C for a, b in plan[:-1])
    assert len(plan) == -(-n * itemsize // C)
    covered = np.zeros(n, np.int64)
    for a, b in plan:
        covered[a:b] += 1
    assert (covered == 1).all()


def test_chunk_plan_of_nothing_is_empty():
    assert ops.chunk_plan(0, 4, C) == []


def test_large_c_contiguous_host_arrays_bound_to_a_card_take_the_ring():
    a = np.zeros(ops.STAGE_MIN_BYTES // 4, np.float32)
    src = ops._stage_source(a, CUDA, None)
    assert src is not None and src.data_ptr() == a.ctypes.data   # no copy
    t = torch.zeros(ops.STAGE_MIN_BYTES, dtype=torch.uint8)
    assert ops._stage_source(t, CUDA, None) is t
    # the threshold is on the bytes as bound: int64 ids bound as int32
    ids = np.zeros(ops.STAGE_MIN_BYTES // 8, np.int64)
    assert ops._stage_source(ids, CUDA, None) is not None
    assert ops._stage_source(ids, CUDA, torch.int32) is None


@pytest.mark.parametrize("case", ["cpu", "small", "fortran", "strided",
                                  "list", "meta"])
def test_everything_else_keeps_the_plain_copy(case):
    big = np.zeros((ops.STAGE_MIN_BYTES // 64, 16), np.float32)
    a, device = {
        "cpu": (big, torch.device("cpu")),
        "small": (big[:-1], CUDA),
        "fortran": (np.asfortranarray(big), CUDA),
        "strided": (torch.zeros(ops.STAGE_MIN_BYTES // 2,
                                dtype=torch.float32)[::2], CUDA),
        "list": ([0.0] * (ops.STAGE_MIN_BYTES // 4), CUDA),
        "meta": (big, torch.device("meta")),
    }[case]
    assert ops._stage_source(a, device, None) is None


def test_the_cpu_binds_stage_nothing():
    """A DenseIO and a prepare on the CPU copy nothing to a card: both
    counters stay at 0, however large the arrays."""
    n = ops.STAGE_MIN_BYTES
    nbr = np.zeros((n // 4, 4), np.int32)
    tel = obs.Telemetry(enabled=True)
    with obs.use(tel):
        io = ops.DenseIO(nbr, nbr == 0, device="cpu")
        ops.RefExecutor(device="cpu").prepare(
            np.zeros((n // 16, 4), np.float32))
    assert io.nbr.data_ptr() == nbr.ctypes.data       # as_tensor's view
    assert tel.counters.get("io.h2d_bytes", 0) == 0
    assert tel.counters.get("io.h2d_staged_bytes", 0) == 0


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (page-locked buffers, copy streams)")
    torch.cuda.synchronize()
    return torch.device("cuda")


def _host(n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(n) < 0.3
    if dtype == np.float32:
        return rng.standard_normal(n, dtype=np.float32)
    hi = 2 ** 40 if dtype == np.int64 else 2 ** 31     # int64 -> int32 wraps
    return rng.integers(-hi, hi, n).astype(dtype)


def _bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,to", [
    (np.float32, None), (np.int32, None), (np.bool_, None),
    (np.int64, torch.int32)])
@pytest.mark.parametrize("n_bytes", [C // 2 + 4, 3 * C + 12])
def test_the_ring_equals_as_tensor_bitwise(cuda, dtype, to, n_bytes):
    """A ring of 3 buffers of ``C`` bytes, at sizes below and off a
    multiple of its chunk, and one int64 -> int32 conversion."""
    ring = ops.StageRing(cuda, 3, C)
    a = _host(n_bytes // np.dtype(dtype).itemsize, dtype, n_bytes)
    a = a.reshape(-1, 2) if a.size % 2 == 0 else a
    want = torch.as_tensor(a, dtype=to, device=cuda)
    got = ring.copy(torch.as_tensor(a), to or want.dtype)
    _bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,to", [
    (np.float32, None), (np.int32, None), (np.bool_, None),
    (np.int64, torch.int32)])
def test_bind_stages_large_arrays_bitwise_and_counts_them(cuda, dtype, to):
    """Through the module's ring, more than one chunk and off its size:
    ``io.h2d_staged_bytes`` equals ``io.h2d_bytes``."""
    size = (to.itemsize if to else np.dtype(dtype).itemsize)
    a = _host(ops.STAGE_CHUNK // size + 5, dtype, 7)
    tel = obs.Telemetry(enabled=True)
    with obs.use(tel):
        got, n = ops._bind(a, cuda, to)
    _bitwise(got, torch.as_tensor(a, dtype=to, device=cuda))
    assert n == a.size * size
    assert tel.counters["io.h2d_bytes"] == n
    assert tel.counters["io.h2d_staged_bytes"] == n


@pytest.mark.gpu
def test_small_arrays_keep_the_plain_copy_on_the_card(cuda):
    a = _host(ops.STAGE_MIN_BYTES // 4 - 1, np.float32, 1)
    tel = obs.Telemetry(enabled=True)
    with obs.use(tel):
        got, n = ops._bind(a, cuda)
    _bitwise(got, torch.as_tensor(a, device=cuda))
    assert tel.counters["io.h2d_bytes"] == n == a.nbytes
    assert tel.counters.get("io.h2d_staged_bytes", 0) == 0


@pytest.mark.gpu
def test_a_second_bind_reads_the_host_array_again(cuda):
    """Nothing is kept across calls: the array changed on the host binds
    to its new values, the first result keeps the old ones, and the
    caller's array is never pinned."""
    a = _host(3 * ops.STAGE_CHUNK // 4 + 3, np.float32, 2)
    old = a.copy()
    first, _ = ops._bind(a, cuda)
    a *= 2.0
    second, _ = ops._bind(a, cuda)
    _bitwise(first, torch.as_tensor(old, device=cuda))
    _bitwise(second, torch.as_tensor(a, device=cuda))
    assert not torch.as_tensor(a).is_pinned()


@pytest.mark.gpu
def test_a_staged_bind_adds_no_device_memory_beyond_its_result(cuda):
    a = _host(2 * ops.STAGE_CHUNK // 4 + 9, np.float32, 3)
    ops._bind(a[:ops.STAGE_MIN_BYTES // 4], cuda)     # the ring exists
    torch.cuda.synchronize()

    def peak_of(fn):
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        t = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(cuda) - base
        del t
        return peak

    plain = peak_of(lambda: torch.as_tensor(a, device=cuda))
    staged = peak_of(lambda: ops._bind(a, cuda)[0])
    assert staged == plain
    assert a.nbytes <= staged < a.nbytes + (2 << 20)


@pytest.mark.gpu
def test_binds_from_several_threads_through_one_ring_are_each_bitwise(cuda):
    """The ring's lock: four threads bind their own arrays at once, each
    of three chunks or more; every result is its own array's bits."""
    from concurrent.futures import ThreadPoolExecutor
    arrays = [_host(3 * ops.STAGE_CHUNK // 4 + i, np.float32, 10 + i)
              for i in range(4)]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda a: ops._bind(a, cuda)[0], arrays,
                            timeout=300))
    torch.cuda.synchronize()
    for a, t in zip(arrays, got):
        _bitwise(t, torch.as_tensor(a, device=cuda))

