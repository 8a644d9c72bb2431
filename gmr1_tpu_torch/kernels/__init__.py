"""Hand-written Hopper (sm_90a) kernels and their build.

Each `*.cu` here exports a plain C entry point.  `library(name)` compiles
`name.cu` with nvcc into a shared library under `gmr1_tpu_torch/_build/`
(named by a hash of source and flags, so an edit rebuilds) at first use
and loads it with ctypes; pointers and the CUDA stream travel as integers.
Nothing here runs at import time: the CPU tests import every module, and
the machines they run on have no nvcc.

There is no fallback: a missing toolkit, a failed compile or a failed
launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
# C signature of each library's entry point: (symbol, argtypes)
_ENTRY = {
    "viterbi": ("gmr1_viterbi_decode", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "pfb": ("gmr1_pfb_branch_filter", (_P, _P, _P, _I, _I, _I, _P)),
    "a5": ("gmr1_a5_keystream", (_U64, _P, _P, _P, _I, _I, _P)),
}
KERNELS = tuple(_ENTRY)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> tuple[Path, Path]:
    """(source, hashed shared-library path) of kernels/<name>.cu."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc on kernels/<name>.cu unless its hashed target exists;
    returns (target, process or None)."""
    src, out = _target(name)
    if out.is_file():
        return out, None
    cmd = [_nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd += ["-o", str(tmp), str(src)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _finish(name: str, out: Path, proc) -> Path:
    if proc is not None:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{err}")
        os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)
    return out


def build(name: str) -> Path:
    """Compile kernels/<name>.cu into the build directory (if its hashed
    target is missing) and return the shared library's path."""
    return _finish(name, *_start(name))


@functools.cache
def library(name: str):
    """The loaded entry point of kernels/<name>.cu (built on first use)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device")
    sym, argtypes = _ENTRY[name]
    fn = getattr(ctypes.CDLL(str(build(name))), sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_all() -> dict[str, float]:
    """Build every kernel, one nvcc per source all started together, and
    load each; returns the seconds from the start to each one's load."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in KERNELS}
    out = {}
    try:
        for name, (path, proc) in started.items():
            _finish(name, path, proc)
            library(name)
            out[name] = time.perf_counter() - t0
    finally:                 # a failed build leaves no compiler running
        for _, proc in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"kernel {name!r} launch failed: cudaError {err}")


def stream_ptr(device=None) -> int:
    """The current CUDA stream of `device` (the current device if None)."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernels/<name>.cu's entry point for tensors on `device`: that
    device is current for the launch and its current stream goes last in
    the arguments, so a tensor on cuda:1 never launches into cuda:0's
    context.  Raises on a CUDA error code."""
    fn = library(name)
    with torch.cuda.device(device):
        err = fn(*args, stream_ptr(device))
    check(err, name)
