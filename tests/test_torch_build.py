"""The nvcc + ctypes build raises on every failure; nothing falls back."""

import os
import shutil
import stat

import pytest

from recombiner_tpu_torch.ops import _build


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build, "_libs", {})
    return tmp_path


def _fake_nvcc(bin_dir, body: str):
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)


def test_missing_nvcc_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "no_cuda"))
    monkeypatch.setenv("PATH", str(fresh_build / "no_bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("siren_fwd")
    assert not os.path.exists(_build.BUILD_DIR)


def test_failed_compile_raises_with_its_log(fresh_build, monkeypatch):
    _fake_nvcc(fresh_build / "cuda" / "bin", "echo 'error: no sm_90a here' >&2\nexit 2\n")
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "cuda"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build("siren_fwd")
    assert os.listdir(_build.BUILD_DIR) == []


def test_flags_and_source(fresh_build, monkeypatch):
    args_file = fresh_build / "args"
    _fake_nvcc(fresh_build / "cuda" / "bin",
               f'echo "$@" > {args_file}\n'
               'prev=""; for a; do [ "$prev" = "-o" ] && touch "$a"; prev=$a; done\n')
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "cuda"))
    built = _build.build("siren_fwd")
    args = args_file.read_text()
    assert "arch=compute_90a,code=sm_90a" in args and "--use_fast_math" not in args
    assert args.strip().endswith("csrc/siren_fwd.cu")
    assert os.path.exists(built.path) and built.path.startswith(_build.BUILD_DIR)
    assert _build.build("siren_fwd") is built  # built once per process


def test_build_all_starts_one_nvcc_per_source_together(fresh_build, monkeypatch):
    """Both kernels' sources build at once: each fake nvcc waits until the
    other has started, so a serial build would time out."""
    marks = fresh_build / "started"
    marks.mkdir()
    _fake_nvcc(fresh_build / "cuda" / "bin",
               f'src=""; out=""; prev=""\n'
               'for a; do [ "$prev" = "-o" ] && out=$a; src=$a; prev=$a; done\n'
               f'touch {marks}/$(basename $src)\n'
               f'for i in $(seq 100); do [ $(ls {marks} | wc -l) -ge 2 ] && break; sleep 0.1; done\n'
               f'[ $(ls {marks} | wc -l) -ge 2 ] || exit 3\n'
               'touch "$out"\n')
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "cuda"))
    built = _build.build_all(["siren_fwd", "siren_bwd"])
    assert sorted(os.listdir(marks)) == ["siren_bwd.cu", "siren_fwd.cu"]
    assert all(os.path.exists(b.path) for b in built.values())
    assert built["siren_bwd"].path != built["siren_fwd"].path


def test_a_changed_header_changes_the_library_path(fresh_build, monkeypatch, tmp_path):
    """Both kernels include the shared header csrc/siren_mma.cuh, so its
    bytes are part of every library's tag: an edited header cannot load a
    stale library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("siren_fwd.cu", "siren_mma.cuh"):
        shutil.copy(os.path.join(_build.CSRC_DIR, name), csrc / name)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    _fake_nvcc(fresh_build / "cuda" / "bin",
               'prev=""; for a; do [ "$prev" = "-o" ] && touch "$a"; prev=$a; done\n')
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "cuda"))
    first = _build.build("siren_fwd").path
    with open(csrc / "siren_mma.cuh", "a") as f:
        f.write("\n// edited\n")
    monkeypatch.setattr(_build, "_built", {})
    second = _build.build("siren_fwd").path
    assert first != second and os.path.exists(first) and os.path.exists(second)


def test_sources_from_another_directory_share_or_get_their_own_library(fresh_build,
                                                                       monkeypatch, tmp_path):
    """Copies of the sources in another directory (as the variant timings make)
    build through the same path: an identical copy shares the package's
    library and its nvcc, an edited one gets a library of its own."""
    calls = fresh_build / "calls"
    _fake_nvcc(fresh_build / "cuda" / "bin",
               f'echo x >> {calls}\n'
               'prev=""; for a; do [ "$prev" = "-o" ] && touch "$a"; prev=$a; done\n')
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "cuda"))
    same, edited = tmp_path / "same", tmp_path / "edited"
    for d in (same, edited):
        shutil.copytree(_build.CSRC_DIR, d)
    with open(edited / "siren_mma.cuh", "a") as f:
        f.write("\n// edited\n")
    srcs = [_build.source("siren_fwd"), _build.source("siren_fwd", str(same)),
            _build.source("siren_fwd", str(edited))]
    built = _build.build_sources(srcs)
    assert len(calls.read_text().split()) == 2
    assert built[srcs[0]].path == built[srcs[1]].path != built[srcs[2]].path
    assert _build.build_all(["siren_fwd"], str(edited))["siren_fwd"] is built[srcs[2]]
    assert len(calls.read_text().split()) == 2  # nothing rebuilt


def test_the_build_log_is_kept_beside_the_library(fresh_build, monkeypatch):
    """nvcc's log (ptxas' registers and spills) is written beside the
    library and read back when a later process finds the library built."""
    _fake_nvcc(fresh_build / "cuda" / "bin",
               'echo "ptxas info    : Used 121 registers"\n'
               'prev=""; for a; do [ "$prev" = "-o" ] && touch "$a"; prev=$a; done\n')
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "cuda"))
    built = _build.build("siren_bwd")
    assert "Used 121 registers" in built.log and built.seconds > 0
    assert open(f"{built.path}.log").read() == built.log
    monkeypatch.setattr(_build, "_built", {})  # a new process: the library is on disk
    again = _build.build("siren_bwd")
    assert (again.path, again.seconds, again.log) == (built.path, 0.0, built.log)
