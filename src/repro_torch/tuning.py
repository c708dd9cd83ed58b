"""The block-size table and autotuner for the CUDA kernels — the port's
twin of ``repro.tuning``.

A ``BlockTable`` maps ``(kernel, backend, dtype, shape-bucket)`` keys to
the winning tiling of a kernel's wrapper; ``ensure_tuned`` times the
candidate grid for a key once and persists the winner, and
``CudaExecutor(block_table=...)`` consults the table when it launches.
The JSON format and the keys are the JAX package's
(``"spmm/cuda/float32/n1048576/d128"``), so either package's
``BlockTable.load`` reads a table the other wrote.  ``"default"`` is the
port's own table, ``configs/tuned_blocks_torch.json`` (empty while the
file is missing), never the JAX package's ``configs/tuned_blocks.json``.

The grids are over the knobs the wrappers really take.  ``spmm`` and
``gather_spmm`` (``kernels/spmm.py``) take ``block_rows`` x
``block_cols``: rows of a block, and threads over a row's 16-byte
chunks.  ``gat_attention``, ``sddmm`` and ``flash_attention`` take no
tiling (their wrappers size their blocks from the shape), so they have
no grid.  A tiling only changes the grid a kernel runs on, never the
order in which a row is summed, so tuned and untuned outputs are
bitwise the same: the table is a pure speed knob.

Unlike the JAX search, which skips a candidate whose warm-up raises,
``candidates`` prunes the grid up front with the wrapper's own tiling
check (``kernels.spmm.check_tiling``), and a launch that fails during
the search raises: on the card a skipped candidate would hide a failing
launch.  ``REPRO_TUNING=autotune`` forces a search even where the table
has the key.

The switches of the JAX package's ``repro.tuning`` live here too:
``REPRO_TUNING`` is a comma-separated list of flags, read on every call
(``flags()``, ``on(name)``).  Besides ``autotune`` they are the mesh
paths' switches: ``serve_tp`` (weights not sharded over ``data``),
``gqa_cache_seq`` and ``mla_cache_seq`` (the cache's sequence over
``model``) in ``sharding.specs``, ``moe_ep`` (``models.moe``'s
expert-parallel MoE) and ``cp_decode`` (``models.attention``'s
sequence-parallel decode attention).
"""
from __future__ import annotations

import json
import os
import statistics
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Set

DEFAULT_TABLE_PATH = (Path(__file__).resolve().parents[2]
                      / "configs" / "tuned_blocks_torch.json")

# candidate tilings per kernel wrapper (see the module docstring for the
# kernels without one): block_cols of 8 / 16 / 32 chunks (a row of
# D = 128 f32 is 32 chunks of 16 bytes), rows filling 16 to 512 threads
KERNEL_GRIDS: Dict[str, Dict[str, tuple]] = {
    "spmm": {"block_rows": (1, 2, 4, 8, 16), "block_cols": (8, 16, 32)},
    "gather_spmm": {"block_rows": (1, 2, 4, 8, 16),
                    "block_cols": (8, 16, 32)},
}


def flags() -> Set[str]:
    """The flags of ``REPRO_TUNING`` (comma-separated), as the JAX
    package reads them."""
    return set(filter(None, os.environ.get("REPRO_TUNING", "").split(",")))


def on(name: str) -> bool:
    return name in flags()


def autotune_forced() -> bool:
    """REPRO_TUNING=autotune invalidates persisted winners."""
    return on("autotune")


def shape_bucket(n: int) -> int:
    """Power-of-two shape bucket (floor 8): one table entry serves every
    shape that rounds up to the same power of two."""
    b = 8
    while b < n:
        b *= 2
    return b


def _backend() -> str:
    """The backend a key names when the caller gives none: "cuda" where
    a card is visible, else "cpu" (as ``jax.default_backend()`` names
    the JAX package's)."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def table_key(kernel: str, backend: str, dtype: str, N: int,
              D: int) -> str:
    return (f"{kernel}/{backend}/{dtype}"
            f"/n{shape_bucket(N)}/d{shape_bucket(D)}")


class BlockTable:
    """Persisted (kernel, backend, dtype, shape-bucket) -> tiling map.

    JSON format (``configs/tuned_blocks_torch.json``)::

        {"spmm/cuda/float32/n1048576/d128":
             {"block_rows": 4, "block_cols": 32, "us": 412.3}, ...}

    ``us`` is the winner's median time, for information; ``lookup``
    returns only the ``block_*`` knobs.  A key that is not there misses,
    and the caller keeps the wrapper's default tiling.
    """

    def __init__(self, entries: Optional[Dict[str, Dict]] = None,
                 path: Optional[os.PathLike] = None):
        self.entries: Dict[str, Dict] = dict(entries or {})
        self.path = Path(path) if path is not None else DEFAULT_TABLE_PATH

    @classmethod
    def load(cls, path: Optional[os.PathLike] = None) -> "BlockTable":
        p = Path(path) if path is not None else DEFAULT_TABLE_PATH
        entries: Dict[str, Dict] = {}
        if p.exists():
            entries = json.loads(p.read_text())
        return cls(entries, path=p)

    def save(self, path: Optional[os.PathLike] = None) -> Path:
        p = Path(path) if path is not None else self.path
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.entries, indent=1, sort_keys=True)
                     + "\n")
        return p

    def lookup(self, kernel: str, *, N: int, D: int = 128,
               dtype: str = "float32",
               backend: Optional[str] = None) -> Optional[Dict]:
        key = table_key(kernel, backend or _backend(), dtype, N, D)
        got = self.entries.get(key)
        if got is None:
            return None
        return {k: v for k, v in got.items() if k.startswith("block_")}

    def put(self, kernel: str, *, N: int, D: int = 128,
            dtype: str = "float32", blocks: Dict[str, int],
            us: Optional[float] = None,
            backend: Optional[str] = None) -> str:
        key = table_key(kernel, backend or _backend(), dtype, N, D)
        entry = dict(blocks)
        if us is not None:
            entry["us"] = round(float(us), 1)
        self.entries[key] = entry
        return key


def resolve_block_table(spec) -> Optional[BlockTable]:
    """ExecutorSpec ``block_table`` knob -> a BlockTable (or None).

    None / "none" -> no table (default tilings only); "default" -> the
    port's table file (empty when the file is missing); any other
    string -> that JSON path; a BlockTable passes through."""
    if spec is None or spec == "none":
        return None
    if isinstance(spec, BlockTable):
        return spec
    if spec == "default":
        return BlockTable.load()
    return BlockTable.load(spec)


def candidates(kernel: str, N: int, D: Optional[int] = None):
    """Every tiling of ``kernel``'s grid that its wrapper accepts
    (``kernels.spmm.check_tiling``).  ``N`` and ``D`` name the shape the
    search is for; the kernels cover ragged rows and columns themselves,
    so neither prunes a tiling.  Raises for a kernel with no grid."""
    from repro_torch.kernels.spmm import check_tiling
    if kernel not in KERNEL_GRIDS:
        raise ValueError(f"{kernel}: no tiling grid (its wrapper takes no "
                         f"tiling); kernels with one: "
                         f"{', '.join(KERNEL_GRIDS)}")
    grid = KERNEL_GRIDS[kernel]
    combos = [{}]
    for name, values in grid.items():
        combos = [dict(c, **{name: v}) for c in combos for v in values]
    out = []
    for c in combos:
        try:
            check_tiling(kernel, c["block_rows"], c["block_cols"])
        except ValueError:
            continue                 # the wrapper would refuse this one
        out.append(c)
    return out


def cuda_event_timer(fn: Callable[[], Any], repeats: int = 3) -> float:
    """Median seconds of ``fn()`` on the current CUDA stream, from CUDA
    events around each call (after one warm-up call)."""
    import torch
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times) / 1e3


def autotune_op(table: BlockTable, kernel: str, make_call: Callable,
                *, N: int, D: int = 128, dtype: str = "float32",
                timer: Optional[Callable] = None, repeats: int = 3,
                backend: Optional[str] = None) -> Dict[str, int]:
    """Time every candidate tiling and record the winner in ``table``.

    ``make_call(blocks) -> zero-arg callable`` builds the kernel launch
    for one tiling.  ``timer(fn, repeats) -> seconds`` is injectable
    (the default, ``cuda_event_timer``, needs a card); a launch that
    raises ends the search with its error."""
    timer = timer or cuda_event_timer
    best_t, best_blocks = None, None
    for blocks in candidates(kernel, N, D):
        t = timer(make_call(blocks), repeats)
        if best_t is None or t < best_t:
            best_t, best_blocks = t, blocks
    table.put(kernel, N=N, D=D, dtype=dtype, blocks=best_blocks,
              us=best_t * 1e6, backend=backend)
    return best_blocks


def ensure_tuned(table: BlockTable, kernel: str, make_call: Callable,
                 *, N: int, D: int = 128, dtype: str = "float32",
                 timer: Optional[Callable] = None, repeats: int = 3,
                 backend: Optional[str] = None) -> Dict[str, int]:
    """The tuned tiling for a key: searched (and the table saved to its
    path) only on a miss, or always under ``REPRO_TUNING=autotune``."""
    if not autotune_forced():
        got = table.lookup(kernel, N=N, D=D, dtype=dtype, backend=backend)
        if got:
            return got
    blocks = autotune_op(table, kernel, make_call, N=N, D=D, dtype=dtype,
                         timer=timer, repeats=repeats, backend=backend)
    table.save()
    return blocks
