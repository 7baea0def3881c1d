"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes`` (a few seconds
a file; a source that includes PyTorch's headers takes minutes). The
libraries go to ``build/repro_torch/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads from disk. Nothing builds when a module is
imported: the first launch of a kernel builds its library, and
:func:`build_all` builds every source at once, one ``nvcc`` each, all
started together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: sources whose products and sums are FMAs, held to the float32 row of
#: their plain versions rather than to their bits
FMA_SOURCES = frozenset({"flash_attention"})


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The flags of ``csrc/<name>.cu``. Every source but those of
    :data:`FMA_SOURCES` adds ``-fmad=false``: no mul+add is contracted
    into an FMA, so the plain PyTorch versions (separate, rounded
    products and sums in the kernels' order) reproduce the kernels'
    bits — see kernels/ref.py."""
    return NVCC_FLAGS if name in FMA_SOURCES else (*NVCC_FLAGS,
                                                   "-fmad=false")

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (popen, tmp_path, lib_path),
    or None when the library is already built."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> str:
    """Wait for one nvcc; move its library into place; return its log."""
    proc, tmp, lib = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib)      # atomic: a concurrent loader sees all or none
    (lib.with_suffix(".log")).write_text(log)
    return log


def build_all() -> dict[str, str]:
    """Build every source in parallel; returns {name: compiler log}
    ("" for a library that was already built)."""
    with _LOCK:
        started = {n: _start(n) for n in sources()}
        return {n: ("" if s is None else _finish(n, s))
                for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(code: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {code}")


def check_cuda(name: str, tensors, dtypes) -> None:
    """Raise unless ``tensors`` are contiguous CUDA tensors on one device
    with the given dtypes (a wrapper's operand check before its launch)."""
    dev = tensors[0].device
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name} takes {dt} here, got {t.dtype}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous operands")


#: the C entries' dtype codes of float operands and outputs
#: (``csrc/dtype_io.cuh``), by dtype name
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def io_dtypes(name: str, operands, out_dtype=None):
    """(in code, out code, out dtype) of a launch whose float
    ``operands`` share one dtype, float32 or bfloat16; ``out_dtype`` None
    is theirs (the Pallas kernels' ``out_dtype or x.dtype``). Raises
    ``TypeError`` on any other dtype or on operands of two dtypes."""
    dtypes = {t.dtype for t in operands}
    if len(dtypes) != 1 or _dtype_name(operands[0].dtype) not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one "
                        f"dtype (got {[t.dtype for t in operands]})")
    in_dt = operands[0].dtype
    out_dt = in_dt if out_dtype is None else out_dtype
    if _dtype_name(out_dt) not in DTYPE_CODES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, "
                        f"not {out_dt}")
    return (DTYPE_CODES[_dtype_name(in_dt)], DTYPE_CODES[_dtype_name(out_dt)],
            out_dt)


def check_smem(name: str, smem: int, shape: str) -> None:
    """Raise when a launch's shared-memory plan exceeds :data:`SMEM_LIMIT`."""
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {shape} needs {smem} B of shared "
                         f"memory > {SMEM_LIMIT} B")


def check_rows(name: str, bm, cell: str, max_rows: int | None) -> int:
    """``bm``, a CTA's query or destination rows that a caller asked for,
    as an int: at least 1, and at most ``max_rows`` (the cell's
    ``kMaxRows``; None: no such limit) on ``cell``; else ``ValueError``.
    A launch knob never re-plans: a row count the cell cannot run is
    refused, not moved to another cell."""
    if isinstance(bm, bool) or int(bm) != bm or bm < 1 or (
            max_rows is not None and bm > max_rows):
        raise ValueError(f"{name}: bm={bm!r} rows a CTA; the {cell} cell "
                         f"takes 1 to {max_rows or 'any number of'} rows")
    return int(bm)
