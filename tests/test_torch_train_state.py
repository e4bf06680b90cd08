"""Prior artifacts and train states across the packages, and the port's
``cli.train`` and ``cli.rd_sweep`` driven end to end on the CPU.

Tolerances: a decoded reconstruction at ``DECODE_TOL`` (atol 3e-5, rtol
1e-5; ``tests/test_torch_decode.py``'s, which covers the threefry
codebook's 3 ulp); group KLs of one grouping at rtol 1e-6 (the two
packages' softplus differ by an ulp on a few percent of the f32 scales);
everything else in an artifact or a train state equal.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.config import get_config as jax_get_config
from recombiner_tpu.io import bitstream as jax_bitstream
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.io import train_state as jts
from recombiner_tpu.priors import trainer as jtr
from recombiner_tpu.priors.artifact import build_prior_artifact as jax_build_prior_artifact
from recombiner_tpu_torch.cli import rd_sweep
from recombiner_tpu_torch.cli import train as train_cli
from recombiner_tpu_torch.coding import decoder
from recombiner_tpu_torch.config import CIFAR, get_config
from recombiner_tpu_torch.data.export import write_png
from recombiner_tpu_torch.data.synthetic import synthetic_dataset
from recombiner_tpu_torch.io import bitstream, checkpoint, convert, train_state
from recombiner_tpu_torch.io.atomic import SnapshotRejected
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.priors import trainer as tr
from recombiner_tpu_torch.priors.artifact import build_prior_artifact

from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encode import DECODE_TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIFAR_STATE = os.path.join(ROOT, "docs", "schedule_priors", "train_state_cifar_2.npz")


def _levels_equal(got, want, what):
    """Two level artifacts: priors, average raw scales and the grouping equal
    (its group KLs and weights at rtol 1e-6)."""
    for f in ("p_loc", "p_scale", "avg_log_scale"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{what}.{f}")
    g, w = got.grouping, want.grouping
    assert g.n_groups == w.n_groups, what
    for f in ("group_start", "group_end", "group_idx", "param2group", "group2param"):
        np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f"{what}.{f}")
    for f in ("group_kls", "weights"):
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=1e-6,
                                   err_msg=f"{what}.{f}")


def _artifacts_equal(got, want):
    assert got.config.name == want.config.name and got.kl_beta == want.kl_beta
    assert got.codebook_seed == want.codebook_seed
    for name in ("w", "h", "hh"):
        if getattr(want, name) is None:
            assert getattr(got, name) is None
        else:
            _levels_equal(getattr(got, name), getattr(want, name), name)
    for a, b in zip(got.A, want.A, strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert sorted(got.up) == sorted(want.up)
    for c in got.up:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got.up[c][k], np.asarray(want.up[c][k]))


def test_committed_cifar_state_builds_the_jax_packages_artifact():
    """The committed CIFAR train state (version 1, 500 rows, 200 EM
    iterations) loads in the port leaf for leaf as in the JAX package, and
    builds the same artifact: 125 groups, the same param2group, priors,
    average raw scales, A and conv parameters."""
    jcfg = jax_get_config("cifar")
    jstate, jpriors, jbeta, jdone, jextra = jts.load_train_state(CIFAR_STATE, jcfg)
    state, priors, beta, done, extra = train_state.load_train_state(CIFAR_STATE, CIFAR, "cpu")
    assert (beta, done, extra) == (jbeta, jdone, jextra) == (beta, 200, {
        "controller": None, "schedule_total": None})
    st, pr = convert.prior_state_leaves(state, priors)
    assert len(st) == 14 and len(pr) == 4
    for a, b in zip(st + pr, jax.tree_util.tree_leaves(jstate) + jax.tree_util.tree_leaves(
            jpriors), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    art = build_prior_artifact(state, priors, beta, CIFAR)
    jart = jax_build_prior_artifact(jstate, jpriors, jbeta, jcfg)
    assert art.w.grouping.n_groups == 125 and art.h is None
    _artifacts_equal(art, jart)
    assert checkpoint.prior_fingerprint(art) == jck.prior_fingerprint(jart)


def _trained(name, seed=0, n_em_iters=2):
    """A small port-trained state of config ``name`` on 2 synthetic
    datapoints (rate control off)."""
    cfg = get_config(name)
    X, Y = (torch.from_numpy(a) for a in synthetic_dataset(cfg, 2, seed=seed))
    res = tr.em_train(torch.Generator().manual_seed(seed), cfg, X, Y, 2.0,
                      n_em_iters=n_em_iters, first_epochs=3, later_epochs=2, lr=2e-3,
                      rate_control=False)
    return cfg, X, res


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("name", ["tiny", "tiny_patch"])
def test_train_states_load_across_packages(tmp_path, name, version):
    """A train state written by the port loads in the JAX package's
    ``load_train_state`` and back, leaf for leaf, with kl_beta, the EM
    count, the controller and schedule_total (None in version 1); one
    written by the JAX package loads in the port alike."""
    cfg, _, res = _trained(name)
    jcfg = jax_get_config(name)
    controller = {"aim": 1.07, "in_window": True, "seen_above": False} if version == 2 else None
    total = 550 if version == 2 else None
    path = str(tmp_path / "ts.npz")
    train_state.save_train_state(path, res.state, res.priors, 3.5e-7, 12, controller=controller,
                                 schedule_total=total)
    if version == 1:  # what the JAX package wrote before it kept the controller
        with np.load(path) as z:
            arrays = dict(z)
        header = json.loads(bytes(arrays["__header__"]).decode())
        assert "controller" not in header and "schedule_total" not in header
        header["version"] = 1
        arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
        np.savez(path, **arrays)
    want_extra = {"controller": controller, "schedule_total": total}
    js, jp, jbeta, jdone, jextra = jts.load_train_state(path, jcfg)
    assert (jbeta, jdone, jextra) == (3.5e-7, 12, want_extra)
    st, pr = convert.prior_state_leaves(res.state, res.priors)
    jleaves = jax.tree_util.tree_leaves(js) + jax.tree_util.tree_leaves(jp)
    for a, b in zip(st + pr, jleaves, strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = str(tmp_path / "back.npz")
    jts.save_train_state(back, js, jp, jbeta, jdone, controller=controller, schedule_total=total)
    state, priors, beta, done, extra = train_state.load_train_state(back, cfg, "cpu")
    assert (beta, done, extra) == (3.5e-7, 12, want_extra)
    for a, b in zip(state.leaves() + priors.leaves(), res.state.leaves() + res.priors.leaves(),
                    strict=True):
        assert torch.equal(a, b)


def test_newer_train_state_is_rejected(tmp_path):
    cfg, _, res = _trained("tiny", n_em_iters=1)
    path = str(tmp_path / "ts.npz")
    train_state.save_train_state(path, res.state, res.priors, 1e-8, 1)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["__header__"] = np.frombuffer(json.dumps({"version": 3}).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(SnapshotRejected):
        train_state.load_train_state(path, cfg, "cpu")
    with pytest.raises(ValueError, match="leaves"):
        convert.prior_state_from(*convert.prior_state_leaves(res.state, res.priors),
                                 get_config("tiny_patch"), "cpu")


@pytest.mark.parametrize("name", ["tiny", "tiny_patch"])
def test_port_trained_priors_load_in_jax_and_decode_alike(tmp_path, name):
    """A prior the port trained loads in the JAX package (the same artifact
    and fingerprint), and a bitstream of random indices, written by the
    port and read by the JAX package, decodes in both packages, each with
    its own codebooks, within DECODE_TOL."""
    cfg, X, res = _trained(name)
    art = build_prior_artifact(res.state, res.priors, res.kl_beta, cfg, codebook_seed=3)
    path = str(tmp_path / "prior.npz")
    checkpoint.save_prior_artifact(path, art)
    jart = jck.load_prior_artifact(path)
    _artifacts_equal(art, jart)
    assert jck.prior_fingerprint(jart) == checkpoint.prior_fingerprint(art)
    R = X.shape[0]
    codec, state0 = decoder.init_codec(art, R, device="cpu")
    rng = np.random.default_rng(1)
    idx = {n: rng.integers(0, 2**cfg.bits_per_group, (state0.level(n).q.loc.shape[0],
                                                      codec.meta(n).n_groups))
           for n in codec.level_names}
    stream = str(tmp_path / "b.rctb")
    bitstream.write_bitstream(stream, idx, config_name=cfg.name, codebook_seed=3,
                              codebook_kind=art.codebook_kind, bits_per_group=cfg.bits_per_group)
    _, jidx = jax_bitstream.read_bitstream(stream)
    want = np.asarray(jenc.decode(jenc.init_codec(jart, R)[0], jidx, jnp.asarray(X.numpy()),
                                  jart.config))
    got = decoder.decode(codec, idx, X, cfg).numpy()
    assert got.shape == (R, cfg.n_pixels, cfg.output_dim)
    np.testing.assert_allclose(got, want, **DECODE_TOL)


# ------------------------------------------------------------------ CLIs


@pytest.fixture(scope="module")
def png_dirs(tmp_path_factory):
    """Three smooth PNGs each of TINY (16 x 16) and TINY_PATCH (32 x 32, 4
    patch rows), written by the port's own PNG writer."""
    root = tmp_path_factory.mktemp("train_cli")
    for name, hw in (("tiny", (16, 16)), ("tiny_patch", (32, 32))):
        os.makedirs(root / name)
        rng = np.random.default_rng(0)
        yy, xx = np.meshgrid(*(np.linspace(0, 1, s) for s in hw), indexing="ij")
        for i in range(3):
            img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx
                                                            + rng.uniform(0.5, 2) * yy))
                            for _ in range(3)], -1)
            write_png(str(root / name / f"{i}.png"), img)
    return root


@pytest.mark.parametrize("name", ["tiny", "tiny_patch"])
def test_cli_train_end_to_end(png_dirs, tmp_path, name, capsys, monkeypatch):
    """``cli.train --device cpu`` on a directory of PNGs: 2 of the 3 images
    (the seeded subset), the JAX CLI's artifact and history file names and
    log lines, an artifact that the JAX package loads and whose config is
    the dataset's; with ``--n_devices 2`` two ranks train a datapoint each
    (queue 1, item 7) and rank 0 writes the same files."""
    out = tmp_path / "out"
    argv = ["--train_dir", str(png_dirs / name), "--dataset", name, "--max_bitrate", "2.0",
            "--saving_dir", str(out), "--device", "cpu", "--n_em_iters", "2",
            "--first_epochs", "3", "--later_epochs", "2", "--lr", "2e-3"]
    rows = 2 * get_config(name).patches_per_datapoint
    res = train_cli.main(argv + ["--train_size", str(rows)])
    stem = f"train_size_{rows}_max_bitrate=2.000"
    assert sorted(os.listdir(out)) == [f"LOSS_{stem}.json", f"PRIOR_{stem}.npz"]
    with open(out / f"LOSS_{stem}.json") as f:
        assert json.load(f) == res.elbo_history and len(res.elbo_history) == 2
    log = capsys.readouterr().out
    assert f"Prior is trained on {rows} patches/datapoints." in log
    assert "[0] Training PSNR" in log and "[1] Training PSNR" in log
    jart = jck.load_prior_artifact(str(out / f"PRIOR_{stem}.npz"))
    assert jart.config.name == name and jart.codebook_seed == 42
    art = checkpoint.load_prior_artifact(str(out / f"PRIOR_{stem}.npz"))
    assert art.w.grouping.n_params == get_config(name).n_coded_params
    monkeypatch.setattr(launch, "spawn", functools.partial(launch.spawn, timeout_s=300))
    two = tmp_path / "two"
    argv2 = [str(two) if a == str(out) else a for a in argv]
    assert train_cli.main(argv2 + ["--train_size", str(rows), "--n_devices", "2"]) is None
    assert sorted(os.listdir(two)) == sorted(os.listdir(out))
    jart2 = jck.load_prior_artifact(str(two / f"PRIOR_{stem}.npz"))
    assert jart2.config.name == name and len(jart2.A) == len(jart.A)
    with open(two / f"LOSS_{stem}.json") as f:
        assert len(json.load(f)) == 2


def _sweep_argv(name, tmp_path, *extra):
    return ["--dataset", name, "--device", "cpu", "--synthetic", "2", "--n_test", "1",
            "--bitrates", "2.0", "--n_em_iters", "2", "--first_epochs", "3",
            "--later_epochs", "2", "--lr", "2e-3", "--n_encode_epochs", "3",
            "--finetune_epochs", "1", "--sample_size", "2", "--seed", "5",
            "--out", str(tmp_path / "rd.json"), *extra]


@pytest.mark.parametrize("name", ["tiny", "tiny_patch"])
def test_rd_sweep_trains_saves_and_encodes(tmp_path, name):
    """``cli.rd_sweep --synthetic``: with ``--skip_encode`` it trains and
    saves the prior only; with ``--load_prior_dir`` it encodes with it (every
    group of every level, the realized rate that of the group counts, media
    exported), and a resumed ``--state_dir`` encode equals it."""
    priors = tmp_path / "priors"
    assert rd_sweep.main(_sweep_argv(name, tmp_path, "--skip_encode", "--save_prior_dir",
                                     str(priors))) == []
    assert os.listdir(priors) == [f"PRIOR_rd_{name}_bitrate=2.npz"]
    points = rd_sweep.main(_sweep_argv(name, tmp_path, "--load_prior_dir", str(priors),
                                       "--export_dir", str(tmp_path / "media"),
                                       "--state_dir", str(tmp_path / "enc")))
    (p,) = points
    cfg = get_config(name)
    assert p["target_bitrate"] == 2.0 and p["n_rows"] == cfg.patches_per_datapoint
    assert p["actual_bitrate"] == pytest.approx(cfg.bitrate_of_groups(
        p["n_groups"]["w"], p["n_groups"].get("h", 0), p["n_groups"].get("hh", 0)))
    assert np.isfinite(p["distortion_mean"]) and len(p["exported"]) == 1
    with open(tmp_path / "rd.json") as f:
        assert json.load(f)["points"][0]["n_groups"] == p["n_groups"]
    # the encode state is complete: run again, it resumes with every group coded
    again = rd_sweep.main(_sweep_argv(name, tmp_path, "--load_prior_dir", str(priors),
                                      "--state_dir", str(tmp_path / "enc")))
    assert again[0]["distortion_mean"] == p["distortion_mean"]


class Crash(RuntimeError):
    pass


def test_rd_sweep_resumes_training_after_a_crash(tmp_path, monkeypatch):
    """``--train_state_dir`` with ``--em_chunk 1``: crashed after the first
    train-state snapshot, relaunched twice from copies of it: both relaunches
    restore the controller and the EM count, continue to the end, and
    agree bit for bit (their saved priors and final train states)."""
    save = train_state.save_train_state
    saved_controllers = []

    def crashing(path, state, priors, kl_beta, em_iter, controller=None, **kw):
        save(path, state, priors, kl_beta, em_iter, controller=controller, **kw)
        saved_controllers.append(dict(controller))
        raise Crash(em_iter)

    argv = _sweep_argv("tiny", tmp_path, "--em_chunk", "1", "--probe_every", "1",
                       "--n_em_iters", "3", "--skip_encode")
    monkeypatch.setattr(train_state, "save_train_state", crashing)
    with pytest.raises(Crash):
        rd_sweep.main(argv + ["--train_state_dir", str(tmp_path / "ts0")])
    monkeypatch.setattr(train_state, "save_train_state", save)
    snap = tmp_path / "ts0" / "train_state_tiny_2.npz"
    *_, done, extra = train_state.load_train_state(str(snap), get_config("tiny"), "cpu")
    assert done == 1 and extra == {"controller": saved_controllers[0], "schedule_total": 3}

    em_train = tr.em_train
    passed = []

    def watching(*a, **kw):
        passed.append((kw["controller"], kw["em_iter_offset"], kw["n_em_iters"]))
        return em_train(*a, **kw)

    monkeypatch.setattr(tr, "em_train", watching)
    finals = []
    for k in (1, 2):
        ts = tmp_path / f"ts{k}"
        os.makedirs(ts)
        shutil.copy(snap, ts / snap.name)
        rd_sweep.main(argv + ["--train_state_dir", str(ts), "--save_prior_dir",
                              str(tmp_path / f"p{k}")])
        finals.append(train_state.load_train_state(str(ts / snap.name), get_config("tiny"),
                                                   "cpu"))
    assert passed == [(saved_controllers[0], 1, 2)] * 2
    assert finals[0][3] == finals[1][3] == 3
    assert finals[0][4] == finals[1][4]
    for a, b in zip(finals[0][0].leaves() + finals[0][1].leaves(),
                    finals[1][0].leaves() + finals[1][1].leaves()):
        assert torch.equal(a, b)
    arts = [checkpoint.load_prior_artifact(str(tmp_path / f"p{k}" / "PRIOR_rd_tiny_bitrate=2.npz"))
            for k in (1, 2)]
    _artifacts_equal(arts[0], arts[1])


def test_rd_sweep_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Nothing is left to refuse: every ``--precision`` runs
    (``test_torch_precision.py::test_clis_pass_the_mode_on``) and so does
    ``--n_devices 2``: the two training datapoints sharded, the one test
    datapoint on both ranks, rank 0 writing the curve. A count above the
    visible devices raises."""
    monkeypatch.setattr(launch, "spawn", functools.partial(launch.spawn, timeout_s=300))
    assert rd_sweep.main(_sweep_argv("tiny", tmp_path, "--n_devices", "2")) is None
    with open(tmp_path / "rd.json") as f:
        (p,) = json.load(f)["points"]
    assert p["n_rows"] == 1 and np.isfinite(p["distortion_mean"])
    with pytest.raises(ValueError, match="requested but only"):
        rd_sweep.main(_sweep_argv("tiny", tmp_path, "--n_devices", "100000"))
