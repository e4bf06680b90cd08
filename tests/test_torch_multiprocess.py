"""The port's multi-process runs end to end on the CPU (gloo), as
``tests/test_multiprocess.py`` runs the JAX package's: the CLIs in two
ranks with exactly one writer, the env gate at world size 1, and an encode
crashed at world size 2 and resumed at world sizes 2 and 1. Every spawn
and every collective has a time limit of its own."""

import os
import shutil
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.io import bitstream as jax_bitstream
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.cli import decompress as decompress_cli
from recombiner_tpu_torch.coords import grid_fourier_features
from recombiner_tpu_torch.data.export import write_png
from recombiner_tpu_torch.io import checkpoint
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.parallel.mesh import Mesh

import torch_parallel_workers as workers
from test_torch_encode import DECODE_TOL, _artifacts, _images
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 300  # each spawn's limit, and every collective's


def spawn(fn, world, *args):
    launch.spawn(fn, world, args, timeout_s=SPAWN_S)


def _load(path):
    return torch.load(path, weights_only=False)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    for i, img in enumerate(_images(4, seed=8)):
        write_png(str(root / f"{i}.png"), img)
    return root


def _train_argv(pngs, out, *extra):
    return ["--train_dir", str(pngs), "--dataset", "tiny", "--train_size", "4",
            "--max_bitrate", "2.0", "--saving_dir", str(out), "--device", "cpu",
            "--n_em_iters", "2", "--first_epochs", "3", "--later_epochs", "2", "--lr", "2e-3",
            *extra]


PRIOR = "PRIOR_train_size_4_max_bitrate=2.000.npz"


def test_cli_train_compress_decompress_on_two_ranks(pngs, tmp_path):
    """cli.train, cli.compress and cli.rd_sweep in two ranks (``--n_devices
    2 --device cpu``): the training rows sharded (and rd_sweep's two test
    datapoints), exactly one writer (rank 0; rank 1 opens no file for
    writing under the output directory), an artifact and a bitstream that
    the JAX package reads, decoded by cli.decompress and by the JAX package
    alike (DECODE_TOL)."""
    out = tmp_path / "out"
    enc = out / "enc"
    runs = [("recombiner_tpu_torch.cli.train", _train_argv(pngs, out / "prior", "--n_devices",
                                                           "2")),
            ("recombiner_tpu_torch.cli.compress",
             ["--test_dir", str(pngs), "--test_idx", "0", "--prior_path",
              str(out / "prior" / PRIOR), "--save_dir", str(enc), "--device", "cpu",
              "--n_epochs", "4", "--finetune_epochs", "1", "--sample_size", "2",
              "--n_devices", "2", "--state_path", str(enc / "state.npz")]),
            ("recombiner_tpu_torch.cli.rd_sweep",
             ["--dataset", "tiny", "--device", "cpu", "--synthetic", "2", "--n_test", "2",
              "--bitrates", "2.0", "--n_em_iters", "2", "--first_epochs", "3", "--later_epochs",
              "2", "--n_encode_epochs", "3", "--finetune_epochs", "1", "--sample_size", "2",
              "--out", str(out / "rd.json"), "--save_prior_dir", str(out / "rd_priors"),
              "--state_dir", str(out / "rd_enc"), "--train_state_dir", str(out / "rd_ts"),
              "--n_devices", "2"])]
    out.mkdir()
    spawn(workers.cli_worker, 2, runs, str(out))
    w0, w1 = _load(str(out / "writes_0.pt")), _load(str(out / "writes_1.pt"))
    assert w1 == []
    written = {os.path.basename(p).removesuffix(".tmp") for p in w0}
    assert {PRIOR, "LOSS_train_size_4_max_bitrate=2.000.json", "Distortion_test_id_0.csv",
            "GroupIndex_test_id_0.csv", "bitstream_test_id_0.rctb", "state.npz", "rd.json",
            "PRIOR_rd_tiny_bitrate=2.npz", "encode_state_tiny_2.npz",
            "train_state_tiny_2.npz"} <= written
    jart = jck.load_prior_artifact(str(out / "prior" / PRIOR))
    assert jart.config.name == "tiny"
    header, idx = jax_bitstream.read_bitstream(str(enc / "bitstream_test_id_0.rctb"))
    assert header["config"] == "tiny"
    y = decompress_cli.main(["--bitstream", str(enc / "bitstream_test_id_0.rctb"),
                             "--prior_path", str(out / "prior" / PRIOR), "--save_dir",
                             str(tmp_path / "dec"), "--device", "cpu"])
    X = np.broadcast_to(grid_fourier_features(jart.config.pixel_sizes, jart.config.fourier_dim),
                        (1, jart.config.n_pixels, jart.config.fourier_dim))
    y_jax = jenc.decode(jenc.init_codec(jart, 1)[0], idx, jnp.asarray(X), jart.config)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_jax), **DECODE_TOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_env_gate_at_world_size_one_is_the_plain_run(pngs, tmp_path):
    """``RECOMBINER_TPU_MULTIHOST=1`` with the JAX names (coordinator, one
    process, id 0) starts a gloo group of one in a subprocess; cli.train
    there writes bitwise the artifact of the run with no group: at world
    size 1 the rank-ordered sums are the identity and the noise is the same
    draw."""
    from recombiner_tpu_torch.cli import train as train_cli

    train_cli.main(_train_argv(pngs, tmp_path / "plain"))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(RECOMBINER_TPU_MULTIHOST="1",
               RECOMBINER_TPU_COORDINATOR=f"localhost:{_free_port()}",
               RECOMBINER_TPU_NUM_PROCESSES="1", RECOMBINER_TPU_PROCESS_ID="0",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p),
               OMP_NUM_THREADS="1")
    code = ("import sys, torch.distributed as dist\n"
            "from recombiner_tpu_torch.cli import train\n"
            "train.main(sys.argv[1:])\n"
            "assert dist.is_initialized() and dist.get_world_size() == 1\n"
            "print('backend', dist.get_backend())\n")
    res = subprocess.run([sys.executable, "-c", code,
                          *_train_argv(pngs, tmp_path / "gate", "--n_devices", "1")],
                         env=env, capture_output=True, text=True, timeout=SPAWN_S)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "backend gloo" in res.stdout
    a = checkpoint.load_prior_artifact(str(tmp_path / "plain" / PRIOR))
    b = checkpoint.load_prior_artifact(str(tmp_path / "gate" / PRIOR))
    for x, y in zip(a.A + [a.w.p_loc, a.w.p_scale, a.w.avg_log_scale],
                    b.A + [b.w.p_loc, b.w.p_scale, b.w.avg_log_scale]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.w.grouping.param2group, b.w.grouping.param2group)


N_RES = 4


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A TINY encode of 4 datapoints at 2 ranks: uninterrupted, and crashed
    after its first snapshot (phase 1, epoch 10 of 20, mid stop window) and
    resumed in the same ranks; then that snapshot resumed in one process."""
    out = tmp_path_factory.mktemp("resume")
    _, art = _artifacts()
    cfg = art.config
    prior = str(out / "prior.npz")
    checkpoint.save_prior_artifact(prior, art)
    X = np.ascontiguousarray(np.broadcast_to(
        grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim),
        (N_RES, cfg.n_pixels, cfg.fourier_dim))).astype(np.float32)
    r = dict(prior=prior, X=X, Y=_images(N_RES, seed=9).reshape(N_RES, cfg.n_pixels, 3), S=2)
    inp = str(out / "resume_in.pt")
    torch.save(r, inp)
    spawn(workers.resume_worker, 2, inp, str(out))
    two = [_load(str(out / f"resume_{k}.pt")) for k in range(2)]
    path = str(out / "one" / "enc_state.npz")
    os.makedirs(out / "one")
    shutil.copy(out / "crash_snapshot.npz", path)
    resume, restored = compress_cli.resume_from(path, art, "cpu")
    one = workers.resumable_compress(r, Mesh(), restored, path, resume)
    plain = workers.resumable_compress(r, Mesh(), workers._codec(r)[2], None)
    return dict(two=two, one=one, plain=plain, Y=r["Y"], resume=resume)


def _psnr(rec, Y):
    return -10 * np.log10(np.mean((rec - Y) ** 2))


def test_crashed_encode_resumes_bitwise_at_the_same_world_size(resumed):
    """Resumed at world size 2 from the gathered snapshot (rows and phase-1
    Adam moments sliced again, the carried stop window on rank 0): the
    indices and posteriors bitwise those of the uninterrupted run, on both
    ranks."""
    for r in resumed["two"]:
        assert r["sharded"] and r["resume_at"] == 10
        np.testing.assert_array_equal(r["again"], r["full"])
        np.testing.assert_array_equal(r["again_loc"], r["full_loc"])
        np.testing.assert_array_equal(r["full"], resumed["two"][0]["full"])


def test_world_size_two_snapshot_resumes_at_world_size_one(resumed):
    """The same snapshot resumed in one process: at least 98% of the indices
    of the uninterrupted 2-rank run and of a 1-process run, the PSNR within
    0.3 dB (the JAX bar)."""
    one, Y = resumed["one"], resumed["Y"]
    assert resumed["resume"]["phase1_opt_leaves"] is not None
    full = resumed["two"][0]
    for what, want, rec in (("2 ranks", full["full"], full["full_rec"]),
                            ("one process", resumed["plain"].indices["w"],
                             resumed["plain"].reconstruction)):
        frac = float(np.mean(one.indices["w"] == want))
        gap = _psnr(one.reconstruction, Y) - _psnr(rec, Y)
        print(f"resumed in one process against {what}, uninterrupted: indices equal {frac}, "
              f"PSNR gap {gap:+.6f} dB")
        assert frac >= 0.98, frac
        assert abs(gap) < 0.3
