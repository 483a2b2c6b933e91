"""Build and load the port's hand-written CUDA kernels, and count launches.

Each kernel library is one ``csrc/<name>.cu`` (plus the headers it
includes), compiled by ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface and loaded with ``ctypes`` (pointers and the
stream as ``c_void_p``). A library may export several entry points (the
flash-attention backward has three). Libraries are built at first use from
the package's sources only, into ``polyrl_tpu_torch/build/`` (git-ignored),
under a name that carries a digest of the flags and of every source the
library is built from, its headers included, so an edited kernel is
rebuilt and never silently reused.

``LAUNCHES`` is the one launch counter of the port: every kernel wrapper
adds one to its library's entry where it launches the kernel
(``count_launch``), and nowhere else (plain-version calls on the CPU do
not count). A CUDA-graph capture runs the wrappers but launches nothing:
inside ``recording_launches`` this thread's counts go to the capture's own
record instead, and each replay of the graph credits that record to
``LAUNCHES`` (``credit_launches``), since a replay runs no wrapper.

Nothing here builds or loads at import time: the CPU tests import this
module and never build.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library name -> (sources: the .cu first, then the headers it includes,
#                  {C entry point: argtypes})
KERNELS: dict[str, tuple[tuple[str, ...], dict[str, list]]] = {
    "paged_kv_write": (
        ("paged_kv_write.cu",),
        {"polyrl_paged_kv_write": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P]}),
    "paged_kv_write_fused": (
        ("paged_kv_write_fused.cu",),
        {"polyrl_paged_kv_write_fused": [_P] * 12 + [_I] * 8 + [_F, _P]}),
    "paged_attention": (
        ("paged_attention.cu", "paged_common.cuh", "flash_mma.cuh",
         "flash_common.cuh"),
        {"polyrl_paged_attention": [_P] * 7 + [_I] * 10 + [_F, _P]}),
    "grouped_paged_attention": (
        ("grouped_paged_attention.cu", "paged_common.cuh", "flash_mma.cuh",
         "flash_common.cuh"),
        {"polyrl_grouped_paged_attention": [_P] * 11 + [_I] * 13 + [_F, _P]}),
    "flash_attention_fwd": (
        ("flash_attention_fwd.cu", "flash_common.cuh", "flash_f32.cuh",
         "flash_mma.cuh"),
        {"polyrl_flash_attention_fwd": [_P] * 6 + [_I] * 7 + [_F, _P]}),
    "flash_attention_bwd": (
        ("flash_attention_bwd.cu", "flash_common.cuh", "flash_f32.cuh",
         "flash_mma.cuh"),
        {"polyrl_flash_attention_bwd_delta": [_P] * 3 + [_I] * 5 + [_P],
         "polyrl_flash_attention_bwd_dq": [_P] * 8 + [_I] * 7 + [_F, _P],
         "polyrl_flash_attention_bwd_dkv": [_P] * 9 + [_I] * 7 + [_F, _P]}),
}

# library name -> launches since the last reset (one per wrapper call that
# launched its kernel; plain-version calls do not count)
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

# the ``dtype`` argument of every entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per thread: the launch record of the capture under way, if any
_recording = threading.local()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """One launch of library ``name``'s kernel by its wrapper: into
    ``LAUNCHES``, or into the record of a capture under way on this
    thread."""
    rec = getattr(_recording, "counts", None)
    if rec is None:
        LAUNCHES[name] += 1
    else:
        rec[name] = rec.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's wrapper launches are recorded into
    the yielded dict and not counted: a CUDA-graph capture, whose kernels
    run only when the graph is replayed. Other threads count as usual."""
    if getattr(_recording, "counts", None) is not None:
        raise RuntimeError("recording_launches does not nest")
    _recording.counts = {}
    try:
        yield _recording.counts
    finally:
        _recording.counts = None


def credit_launches(counts: dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``counts``."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (its wrapper takes the plain version), False
    for a CUDA tensor (the kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device} (cuda or cpu)")
    return False


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the int ctypes takes."""
    return torch.cuda.current_stream(device).cuda_stream


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
    return [CSRC_DIR / f for f in KERNELS[name][0]]


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named libraries (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    wall seconds of each library's build (0.0 when already built). The
    compiler's ``-Xptxas -v`` report lands in ``<lib>.log``
    (``ptxas_report`` reads it)."""
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
               str(_sources(name)[0])]
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
    """The loaded library ``name`` (built first if needed), with every C
    entry point's argtypes set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn_name, argtypes in KERNELS[name][1].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.polyrl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.polyrl_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


_TARG = re.compile(r"Li(\d+)E?|13__nv_bfloat16|S\d*_|f")


def kernel_name(mangled: str) -> str:
    """``flash_dq_bf16_kernel<128>`` for the mangled name of a kernel
    template instance of this package, ``paged_split_f32_kernel`` for a
    plain kernel in a namespace (the mangled name otherwise). Template
    arguments read: int constants, float, bf16, and a substitution
    (``S_``, ``S1_``) as the type before it."""
    # <length><identifier>I<args>E; a length may follow other digits of
    # an anonymous namespace's hash, so every digit position is a start
    for m in re.finditer(r"(?=(\d+))", mangled):
        at = m.start() + len(m.group(1))
        ident = mangled[at:at + int(m.group(1))]
        rest = mangled[at + len(ident):]
        if ident.endswith("_kernel") and rest.startswith("E"):
            return ident
        if ident.endswith("_kernel") and rest.startswith("I"):
            args = []
            for t in _TARG.finditer(rest[1:rest.find("EE")]):
                tok = t.group(0)
                args.append(t.group(1) if t.group(1) else "float" if tok == "f"
                            else args[-1] if tok.startswith("S") and args
                            else "bf16")
            return f"{ident}<{', '.join(args)}>"
    return mangled


def parse_ptxas(text: str) -> list[dict]:
    """Each kernel of an ``nvcc -Xptxas -v`` report: ``{"kernel",
    "registers", "spill_stores", "spill_loads"}`` (bytes)."""
    rows: dict[str, dict] = {}
    entry = props = None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            rows.setdefault(entry, dict(kernel=kernel_name(entry), registers=0,
                                        spill_stores=0, spill_loads=0))
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _SPILL.search(line)) and props in rows:
            rows[props].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        elif (m := _REGS.search(line)) and entry in rows:
            rows[entry]["registers"] = int(m.group(1))
    return list(rows.values())


def ptxas_report(name: str) -> list[dict]:
    """Registers and spill bytes of each kernel of library ``name``, read
    from the ``-Xptxas -v`` report its build left in ``<lib>.log``."""
    return parse_ptxas(lib_path(name).with_suffix(".log").read_text())


def launch(name: str, *args, entry: str | None = None) -> None:
    """Call C entry point ``entry`` of library ``name`` (its only entry
    point by default); raise on a non-zero ``cudaGetLastError()`` (a
    refused launch never runs, and a later synchronize would not report
    it). Counting is the wrapper's job: it calls ``count_launch`` once per
    call of the function it stands for."""
    lib = library(name)
    entries = KERNELS[name][1]
    if entry is None:
        (entry,) = entries
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.polyrl_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} ({msg})")
