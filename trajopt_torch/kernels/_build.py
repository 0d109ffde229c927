"""Build the CUDA sources in ``trajopt_torch/csrc`` and load them with ``ctypes``.

Each ``*.cu`` file becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``build/trajopt_torch/`` at the repo
root (ignored by git) at first use.  The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a current one is reused.
The sources are compiled in parallel, one ``nvcc`` process each.

Nothing is compiled or loaded at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "trajopt_torch"
SOURCES = (
    "ilqr_backward.cu", "fused_backward.cu", "rollout.cu", "pscan_backward.cu", "gps.cu",
    "belief.cu", "bsp.cu",
)
# -fmad=false keeps each product and sum rounded on its own, as the plain
# PyTorch versions round them, so the kernels can be held to them tightly.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc was not found on PATH or under /usr/local/cuda/bin: the CUDA "
        "kernels of trajopt_torch need the CUDA toolkit to build"
    )


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every stale source in parallel; return each source's compiler
    report (``-Xptxas -v``: registers, spills), empty for a reused library.
    Raises ``RuntimeError`` with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        jobs[src] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports = {src: "" for src in sources}
    failed = []
    for src, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        reports[src] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if it is stale."""
    lib = _loaded.get(source)
    if lib is None:
        path = library_path(source)
        if not path.exists():
            build((source,))
        lib = _loaded[source] = ctypes.CDLL(str(path))
    return lib


def function(source: str, name: str, argtypes: list):
    """A C entry point of a source's library, with its argument types set
    (pointers and the stream as ``c_void_p``, so ctypes does not cut them)."""
    fn = getattr(load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


DTYPE_CODES = {"torch.float32": 0, "torch.float64": 1}


def cuda_operands(what: str, *tensors) -> int:
    """Check the operands of a kernel launch (one CUDA device, one floating
    dtype for the float operands, contiguous) and return the dtype code the C
    entry points take: 0 for float32, 1 for float64."""
    first = tensors[0]
    code = DTYPE_CODES.get(str(first.dtype))
    if code is None:
        raise TypeError(f"{what}: float32 or float64 operands expected, got {first.dtype}")
    for t in tensors:
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{what}: every operand must lie on {first.device} (a CUDA device)")
        if t.is_floating_point() and t.dtype != first.dtype:
            raise TypeError(f"{what}: mixed dtypes {first.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    return code


def check(rc: int, what: str) -> None:
    """Raise on a nonzero return of a C entry point: a CUDA error code from
    ``cudaGetLastError()`` after the launch, or -1 for an unsupported shape."""
    if rc == -1:
        raise ValueError(f"{what}: no kernel instantiated for these dimensions")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
