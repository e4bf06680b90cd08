"""The nvcc + ctypes build raises on every failure; nothing falls back."""

import os
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
