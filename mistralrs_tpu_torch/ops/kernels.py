"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process into a
shared library with a plain C interface, for ``sm_90a`` (Hopper), and loaded
with ``ctypes``. All sources build in parallel on first use; the libraries
go to ``csrc/_build/<hash>/``, keyed by a hash of every source file and of
the flags, so an edited source rebuilds and an unchanged checkout reuses its
build. Nothing is compiled or loaded when this module is imported: the CPU
tests import every module on a machine without ``nvcc`` or a card.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "_build"
SOURCES = ("q4k_q8_gemv", "q8_0_q8_gemv", "q6k_gemv", "q5k_q8_gemv", "affine_gemv",
           "flash_prefill", "flash_prefill_paged", "paged_decode", "splash_prefill",
           "ragged_attention", "grouped_gemm", "q4k_bf16_gemv", "q8_0_bf16_gemv",
           "q5k_hbit_bf16_gemv", "q5k_bf16_gemv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> float:
    """Compile every missing library, one nvcc per source, all at once.
    Returns the seconds spent (0.0 when everything was already built).
    A failed build raises with nvcc's output."""
    with _lock:
        out_dir = build_dir()
        todo = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
        if not todo:
            return 0.0
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            (out_dir / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out_dir / f"lib{name}.so")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for one source."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""


def function(lib_name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function `fn_name` of csrc/`lib_name`.cu, built, loaded and
    given its argument types on first use (a pointer passed without them
    would be cut to 32 bits); later calls return it from a cache. Every
    function returns a CUDA error code."""
    fn = _fns.get((lib_name, fn_name))
    if fn is not None:
        return fn
    build()
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            lib = _libs[lib_name] = ctypes.CDLL(str(build_dir() / f"lib{lib_name}.so"))
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


_sms: dict[int, int] = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device (cached)."""
    import torch

    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
