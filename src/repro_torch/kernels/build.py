"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/<name>-<hash>.so <name>.cu

No ``--use_fast_math``: the kernels keep IEEE division, square root and
``expf``.  The library's name carries a hash of its source and flags,
so an edited source rebuilds and an unchanged one is reused.  Libraries
go to ``build/kernels/`` at the repository root (git ignores it), and
are built at first use: ``build_all()`` starts one ``nvcc`` per source,
all at once, and waits for them.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("spmm", "gat_attention", "flash_attention",
           "flash_attention_sm90")
CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures (restype int: the launch's cudaError_t)
SIGNATURES = {
    "spmm": {"deal_spmm": [_P, _P, _P, _L, _L, _L, _P, _P, _P, _L, _I, _I,
                           _I, _I, _I, _I, _P],
             "deal_mean_weights": [_P, _P, _L, _I, _I, _P]},
    "gat_attention": {
        "deal_gat_attention": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                               _P],
        "deal_sddmm": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _I, _I,
                       _P],
        "deal_rgat_attention": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _F,
                                _I, _P]},
    "flash_attention": {
        "deal_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, *[_L] * 9, _I, _I, _L, _L, _F, _I, _P]},
    "flash_attention_sm90": {
        "deal_flash_attention_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, *[_L] * 9, _I, _I, _L, _L, _F, _I,
                                    _P]},
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else ``PATH``.  Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel.
    Returns ``{name: compiler output}`` for the sources built now (the
    ``-Xptxas=-v`` register and spill report).  Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))   # atomic: no torn .so
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed,
    with every C function's argument and result types declared."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_args(what: str, named: dict, dtypes: dict,
               row_strided=(), strided=()) -> None:
    """What a kernel takes: every tensor on the first one's CUDA device,
    contiguous (a name in ``row_strided``: 2-D with unit-stride columns,
    its rows any stride apart; a name in ``strided``: any strides), with
    a dtype in ``dtypes[name]``.  Raises otherwise."""
    dev = next(iter(named.values())).device
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{dev}")
        if name in row_strided:
            if t.dim() != 2 or (t.stride(1) != 1 and t.shape[1] > 1):
                raise ValueError(f"{what}: {name} must be 2-D with "
                                 "unit-stride columns, got strides "
                                 f"{t.stride()}")
        elif name not in strided and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous (make a "
                             "column slice contiguous first)")
        if t.dtype not in dtypes[name]:
            raise TypeError(f"{what}: {name} must be one of "
                            f"{dtypes[name]}, got {t.dtype}")


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
