"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``
(pointers and the stream as ``c_void_p``). Libraries are built at first
use from the package's sources only, into ``polyrl_tpu_torch/build/``
(git-ignored), under a name that carries a digest of the sources and
flags, so an edited kernel is rebuilt and never silently reused.

Nothing here runs at import time: the CPU tests import this module and
never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name -> (C entry point, argtypes)
KERNELS: dict[str, tuple[str, list]] = {
    "paged_kv_write": ("polyrl_paged_kv_write",
                       [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "paged_attention": ("polyrl_paged_attention",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _F, _P]),
    "grouped_paged_attention": ("polyrl_grouped_paged_attention",
                                [_P] * 12 + [_I] * 11 + [_F, _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or add it to PATH)")


def _sources(name: str) -> list[Path]:
    return [CSRC_DIR / f"{name}.cu", CSRC_DIR / "paged_common.cuh"]


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    wall seconds of each kernel's build (0.0 when already built). The
    compiler's ``-Xptxas -v`` report lands in ``<lib>.log``."""
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, out, log)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), with
    its C entry point's argtypes set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            fn_name, argtypes = KERNELS[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.polyrl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.polyrl_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise on a non-zero
    ``cudaGetLastError()`` (a refused launch never runs, and a later
    synchronize would not report it)."""
    lib = library(name)
    rc = getattr(lib, KERNELS[name][0])(*args)
    if rc != 0:
        msg = lib.polyrl_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
