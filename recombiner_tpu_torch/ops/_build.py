"""Build the port's CUDA kernels with nvcc into shared libraries loaded with
ctypes.

Each ``ops/csrc/<name>.cu`` exposes plain ``extern "C"`` functions. It is
compiled at first use into ``recombiner_tpu_torch/_build/`` (git-ignored),
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt. There is no fallback: a missing nvcc, a failed or
timed-out build, or a library that does not load raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

# sm_90a keeps wgmma and setmaxnreg available to later kernels. No
# --use_fast_math: the SIREN kernel needs the precise sinf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class Built:
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, including ptxas' register / smem / spill lines


_lock = threading.Lock()
_built: Dict[str, Built] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    return src


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless this source and these flags are
    already built; returns the library path, build seconds and nvcc's log."""
    return build_all([name])[name]


def build_all(names: List[str]) -> Dict[str, Built]:
    """``build`` for several sources, one nvcc each, all started together."""
    with _lock:
        todo = {}
        for name in names:
            if name in _built:
                continue
            src = _source(name)
            with open(src, "rb") as f:
                tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
            so = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
            if os.path.exists(so):
                _built[name] = Built(so, 0.0, "")
            else:
                todo[name] = (src, so, f"{so}.{os.getpid()}.tmp")
        if todo:
            nvcc = find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            procs = {name: subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)
                     for name, (src, _, tmp) in todo.items()}
            try:
                for name, proc in procs.items():
                    src, so, tmp = todo[name]
                    try:
                        log = proc.communicate(
                            timeout=max(BUILD_TIMEOUT_S - (time.perf_counter() - t0), 0.1))[0]
                    except subprocess.TimeoutExpired as e:
                        raise RuntimeError(
                            f"nvcc timed out after {BUILD_TIMEOUT_S} s building {src}") from e
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({proc.returncode}) building {src}:\n{log}")
                    os.replace(tmp, so)
                    _built[name] = Built(so, time.perf_counter() - t0, log)
            finally:
                for name, proc in procs.items():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    if os.path.exists(todo[name][2]):
                        os.remove(todo[name][2])
        return {name: _built[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, built first if needed."""
    built = build(name)
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(built.path)
        return _libs[name]
