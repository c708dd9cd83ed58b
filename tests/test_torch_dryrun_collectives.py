"""The dry-run's collective bytes and the flash kernel's op on the meta
device (``repro_torch.launch.dryrun``, ``repro_torch.kernels.
flash_attention``): the placed step's messages on a meta mesh equal, by
kind and by receiving shard, those of the same step run on a mesh of
``cpu`` shards (a dense prefill on 2 x 2, smollm-360m data parallel on
4 x 1, deepseek-v2's ``moe_ep`` prefill on 1 x 4, zamba2's
``cp_decode`` decode on 4 x 1); the "params" and "grads" bytes of a
train step written out from the specs; the flash op's FLOPs against a
brute-force count of the mask's pairs; a prefill's temp bytes linear in
S; and the records' ``collectives`` holding JAX's keys."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.roofline import analysis as janalysis  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs import InputShape  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import specs as tspecs  # noqa: E402
from repro_torch.sharding.context import sharding_context  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the tests share the CPU with other
    pytest workers, where PyTorch's OpenMP threads spin while they
    wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(arch):
    return dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               dtype="float32")


def _real_args(cfg, shape, fn, abstract, seed=0):
    """Values on the CPU in the structure of ``step_arguments``' abstract
    arguments: params from ``init_params``, the AdamW state of the
    step's own config, zero caches, token ids and normal features drawn
    from a numpy seed."""
    rng = np.random.default_rng(seed)

    def draw(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.from_numpy(rng.integers(
                0, cfg.vocab_size, tuple(t.shape)).astype(np.int32))
        return torch.from_numpy(rng.standard_normal(
            tuple(t.shape)).astype(np.float32)).to(t.dtype)

    params = ttf.init_params(cfg, 0, device="cpu")
    if shape.kind == "train":
        from repro_torch.train.optimizer import init_opt_state
        params.requires_grad_(True)
        return (params, init_opt_state(params, fn.args[1]),
                {k: draw(v) for k, v in abstract[2].items()})
    if shape.kind == "prefill":
        return params, {k: draw(v) for k, v in abstract[1].items()}
    enc = cfg.n_frontend_tokens if cfg.family == "audio" else None
    cache = ttf.init_cache(cfg, shape.global_batch, shape.seq_len, enc,
                           device="cpu")
    return params, cache, {"token": draw(abstract[2]["token"])}


def _on_cpu_mesh(cfg, shape, P, M, pos=None):
    """({kind: {receiving shard: bytes}}, {kind: bytes}) of one placed
    step on a P x M mesh of ``cpu`` shards, placed as the dry-run places
    it."""
    mesh = make_host_mesh(P, M, device="cpu")
    fn, args, specs, _, _ = dryrun.step_arguments(cfg, shape, mesh)
    run = dryrun.place_arguments(shape, _real_args(cfg, shape, fn, args),
                                 specs, mesh, pos)
    links, sent = collections.Counter(mesh.links), collections.Counter(
        mesh.sent)
    with sharding_context(mesh):
        fn(*run)
    got = {k: v for k, v in mesh.received(links).items()
           if k not in dryrun.NOT_IN_A_STEP}
    sent = {k: n for k, n in (mesh.sent - sent).items()
            if k not in dryrun.NOT_IN_A_STEP}
    return got, sent


PATHS = {   # (arch, shape, mesh, tuning flags, decode position)
    "dense_prefill_2x2": ("smollm-360m", InputShape("p", 16, 2, "prefill"),
                          (2, 2), "", None),
    "smollm_train_4x1": ("smollm-360m", InputShape("t", 16, 4, "train"),
                         (4, 1), "", None),
    "deepseek_moe_ep_prefill_1x4": (
        "deepseek-v2-236b", InputShape("p", 12, 2, "prefill"), (1, 4),
        "moe_ep", None),
    "zamba2_cp_decode_4x1": ("zamba2-7b", InputShape("d", 32, 1, "decode"),
                             (4, 1), "cp_decode", 28),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_meta_mesh_counts_equal_a_cpu_mesh_of_the_same_step(path,
                                                            monkeypatch):
    """The same placed step on a meta mesh (``dryrun.placed_counts``) and
    on a mesh of ``cpu`` shards: every message's bytes, by kind and by
    receiving shard, to the byte, and their sums ``Mesh.sent``'s."""
    arch, shape, (P, M), flags, pos = PATHS[path]
    monkeypatch.setenv("REPRO_TUNING", flags)
    cfg = _f32(arch)
    want, sent = _on_cpu_mesh(cfg, shape, P, M, pos)
    got = dryrun.placed_counts(cfg, shape, {"data": P, "model": M}, pos)
    assert got == want
    assert {k: sum(v.values()) for k, v in got.items()} == sent
    kinds = {"dense_prefill_2x2": {"params"},
             "smollm_train_4x1": {"params", "grads", "loss", "norm",
                                  "scalars"},
             "deepseek_moe_ep_prefill_1x4": {"params", "tokens",
                                             "partials"},
             "zamba2_cp_decode_4x1": {"params", "softmax", "entries",
                                      "replicas"}}[path]
    assert kinds <= set(got), sorted(got)


def test_train_params_and_grads_bytes_written_out_from_the_specs():
    """smollm-360m reduced, f32, data parallel on 2 x 2: each data shard
    p gathers every parameter that the specs split whole onto its shard
    (p, 0) (a replicated one is its own block there: nothing moves), and
    every block receives one whole piece of its gradient from each data
    shard."""
    cfg = _f32("smollm-360m")
    shape = InputShape("t", 8, 4, "train")
    P, M = 2, 2
    mesh = AbstractMesh({"data": P, "model": M})
    got = dryrun.placed_counts(cfg, shape, mesh)
    params = ttf.abstract_params(cfg)
    specs = tspecs.param_specs(cfg, params, mesh)
    split = [(p.numel() * 4, tspecs._shards(mesh, specs[n]))
             for n, p in params.named_parameters()]
    moved = sum(b for b, f in split if f > 1)
    assert got["params"] == {p * M: moved for p in range(P)}
    grads = {i: sum(P * b // f for b, f in split) for i in range(P * M)}
    assert got["grads"] == grads


def _pairs_by_brute_force(Sq, Skv, q_offset, causal, window):
    qp = q_offset + np.arange(Sq)[:, None]
    kv = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= kv <= qp
    if window is not None:
        keep &= (qp - kv) < window
    return int(keep.sum())


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("Sq,Skv,q_offset,causal,window", [
    (37, 37, 0, True, None),            # a causal prefill
    (7, 12, 5, True, None),             # queries after a prefix
    (40, 40, 0, True, 6),               # a sliding window
    (5, 9, 0, False, None),             # non-causal (cross-attention)
    (1, 30, 29, True, 8),               # one query at the end, windowed
])
def test_flash_op_flops_are_the_kept_pairs(Sq, Skv, q_offset, causal,
                                           window):
    """On meta tensors the flash wrapper is one op, which a dispatch mode
    sees once and whose FLOPs are B H (kept pairs) (2 hd + 2 vd); no
    kernel is launched."""
    B, H, K, hd, vd = 2, 4, 2, 16, 8
    q = torch.empty(B, Sq, H, hd, device="meta")
    k = torch.empty(B, Skv, K, hd, device="meta")
    v = torch.empty(B, Skv, K, vd, device="meta")
    kops.reset_launch_counts()
    with FlopCounterMode(display=False) as fc, _Ops() as ops:
        out = tflash.flash_attention_gqa(q, k, v, q_offset=q_offset,
                                         causal=causal, window=window)
    pairs = _pairs_by_brute_force(Sq, Skv, q_offset, causal, window)
    assert fc.get_total_flops() == B * H * pairs * (2 * hd + 2 * vd)
    assert ops.seen == [torch.ops.repro_torch.flash_attention.default]
    assert tuple(out.shape) == (B, Sq, H, vd) and out.is_meta
    assert kops.launch_counts()["flash_attention"] == 0
    assert tflash.kept_pairs(Sq, Skv, q_offset, causal, window) == pairs


def test_flash_op_holds_nothing_under_autograd_and_refuses_storage():
    """Under autograd the meta op allocates the output alone (the forward
    keeps no log-sum-exp); the op itself refuses a tensor with
    storage."""
    from repro_torch.launch.dryrun import TraceCounter
    q = torch.empty(1, 64, 4, 16, device="meta", requires_grad=True)
    k = torch.empty(1, 64, 2, 16, device="meta", requires_grad=True)
    with torch.enable_grad(), TraceCounter() as tc:
        out = tflash.flash_attention_gqa(q, k, k)
    assert out.requires_grad and tc.peak == out.numel() * 4
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        torch.ops.repro_torch.flash_attention(x, x, x, 0, True, None, 1.0)


def test_prefill_temp_grows_about_linearly_with_s():
    """smollm-360m's prefill on the card mesh at S and 4 S: the kernel's
    path holds activations, not (S, S) scores (the plain attention's
    temp grows about 13 x here)."""
    cfg = tconfigs.get_config("smollm-360m")
    temp = [dryrun.dry_run(cfg, InputShape("p", S, 1, "prefill"), "card")[
        "memory_analysis"]["temp_size_in_bytes"] for S in (1024, 4096)]
    assert temp[1] / temp[0] <= 4.5


@pytest.mark.parametrize("mesh_kind", ["card", "single", "multi"])
def test_records_hold_jax_collective_keys(mesh_kind):
    """Every record's ``collectives`` has the keys of JAX's
    ``collective_bytes_from_hlo``, integer bytes, and a numeric
    collective term; 0 on the card, more than 0 on the production
    meshes."""
    rec = dryrun.dry_run(_f32("smollm-360m"), InputShape("u", 64, 2,
                                                        "decode"), mesh_kind)
    coll = rec["collectives"]
    assert set(janalysis.collective_bytes_from_hlo("")) <= set(coll)
    assert all(isinstance(coll[k], int)
               for k in janalysis.collective_bytes_from_hlo(""))
    assert coll["total"] == sum(coll[k] for k in dryrun.JAX_KINDS)
    assert isinstance(rec["roofline"]["collective_s"], float) or (
        rec["roofline"]["collective_s"] == 0)
    if mesh_kind == "card":
        assert coll["total"] == 0 and coll["count"] == 0
    else:
        assert coll["total"] > 0 and coll["count"] > 0
        assert coll["all-gather"] == coll["by_kind"]["params"] + coll[
            "by_kind"]["cache"]     # both to the home alone


def test_report_tabulates_the_collectives_by_kind():
    """``roofline.report``'s rows carry a production-mesh record's bytes
    by JAX's kinds, its collective term over the link's rate, and
    ``markdown_collectives`` prints them a row a record."""
    from repro_torch.roofline import analysis as tanalysis
    from repro_torch.roofline import report
    rec = dryrun.dry_run(_f32("smollm-360m"), InputShape("u", 64, 2,
                                                        "decode"), "single")
    [row] = report.build_rows("single", [rec])
    assert row["coll_by_kind"] == {k: rec["collectives"][k]
                                   for k in report.JAX_KINDS}
    assert row["collective_s"] == rec["collectives"]["total"] / (
        tanalysis.HW["link_bw"])
    md = report.markdown_collectives({"single": [row], "multi": []}
                                     ).splitlines()
    assert len(md) == 3 and md[2].startswith("| smollm-360m | u | ")
    cells = [c.strip() for c in md[2].split("|")[1:-1]]
    assert cells[4] == f"{rec['collectives']['all-gather'] / 1e9:.3f} / -"
