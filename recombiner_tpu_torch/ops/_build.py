"""Build the port's CUDA kernels with nvcc into shared libraries loaded with
ctypes.

Each ``ops/csrc/<name>.cu`` exposes plain ``extern "C"`` functions. It is
compiled at first use into ``recombiner_tpu_torch/_build/`` (git-ignored),
under a name that carries a hash of the source, the shared headers beside
it (``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt.
There is no fallback: a missing nvcc, a failed or timed-out build, or a
library that does not load raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

# sm_90a keeps wgmma and setmaxnreg available to later kernels. No
# --use_fast_math: the SIREN kernels need sines as accurate as the precise
# sinf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class Built:
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, including ptxas' register / smem / spill lines (kept
    # beside the library as <library>.log, and read back when it was already built)


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


def source(name: str, csrc_dir: Optional[str] = None) -> str:
    """Path of ``<csrc_dir>/<name>.cu`` (``csrc_dir`` defaults to the
    package's ``csrc/``); raises if it is missing."""
    src = os.path.join(csrc_dir or CSRC_DIR, f"{name}.cu")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    return src


def _tag(src: str) -> str:
    """Hash of the source, every shared header beside it (``*.cuh``) and the
    flags: an edited header changes the library path as an edited source
    does."""
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(name: str, csrc_dir: Optional[str] = None) -> Built:
    """Compile ``csrc/<name>.cu`` unless this source and these flags are
    already built; returns the library path, build seconds and nvcc's log."""
    return build_all([name], csrc_dir)[name]


def build_all(names: List[str], csrc_dir: Optional[str] = None) -> Dict[str, Built]:
    """``build`` for several sources, one nvcc each, all started together."""
    srcs = {name: source(name, csrc_dir) for name in names}
    built = build_sources(list(srcs.values()))
    return {name: built[src] for name, src in srcs.items()}


def build_sources(srcs: List[str]) -> Dict[str, Built]:
    """Build ``.cu`` files from any directories, one nvcc for each distinct
    library, all started together; keyed by source path. Sources whose
    bytes, headers and flags agree share one library."""
    with _lock:
        so_of = {}  # source path -> library path, for sources not yet built
        todo: Dict[str, tuple] = {}  # library path -> (source, temporary output)
        for src in srcs:
            if src in _built:
                continue
            base = os.path.splitext(os.path.basename(src))[0]
            so = so_of[src] = os.path.join(BUILD_DIR, f"lib{base}-{_tag(src)}.so")
            if not os.path.exists(so) and so not in todo:
                todo[so] = (src, f"{so}.{os.getpid()}.tmp")
        if todo:
            nvcc = find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            procs = {so: subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
                     for so, (src, tmp) in todo.items()}
            try:
                for so, proc in procs.items():
                    src, tmp = todo[so]
                    try:
                        log = proc.communicate(
                            timeout=max(BUILD_TIMEOUT_S - (time.perf_counter() - t0), 0.1))[0]
                    except subprocess.TimeoutExpired as e:
                        raise RuntimeError(
                            f"nvcc timed out after {BUILD_TIMEOUT_S} s building {src}") from e
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({proc.returncode}) building {src}:\n{log}")
                    with open(f"{tmp}.log", "w") as f:
                        f.write(log)
                    os.replace(f"{tmp}.log", f"{so}.log")
                    os.replace(tmp, so)
                    _built[src] = Built(so, time.perf_counter() - t0, log)
            finally:
                for so, proc in procs.items():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    if os.path.exists(todo[so][1]):
                        os.remove(todo[so][1])
        for src, so in so_of.items():  # already built, or sharing another's library
            if src not in _built:
                log = ""
                if os.path.exists(f"{so}.log"):
                    with open(f"{so}.log") as f:
                        log = f.read()
                _built[src] = Built(so, 0.0, log)
        return {src: _built[src] for src in srcs}


def load(name: str, csrc_dir: Optional[str] = None) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, built first if needed."""
    built = build(name, csrc_dir)
    with _lock:
        if built.path not in _libs:
            _libs[built.path] = ctypes.CDLL(built.path)
        return _libs[built.path]
