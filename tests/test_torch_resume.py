"""The port's encode snapshots and resume against the JAX package's, on the
CPU at TINY size: the prior fingerprint, the ``.npz`` format both ways
(state, header, Adam leaves), a resumed encode against the uninterrupted
one, and the snapshots a resume must not use.

Tolerances: snapshot arrays and fingerprints are equal; a resumed encode
equals the uninterrupted one bit for bit (the port on the CPU repeats
itself exactly given the generator).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.io import encode_state as jes
from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.coding import decoder, encoder, progressive
from recombiner_tpu_torch.io import checkpoint, convert, encode_state
from recombiner_tpu_torch.io.atomic import SnapshotRejected, load_snapshot_or_none
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encode import _artifacts, _images

R = 2


def _state_arrays(ls):
    return {"loc": ls.q.loc, "log_scale": ls.q.log_scale,
            **{f: getattr(ls, f) for f in encode_state._FIELDS}}


def _perturbed_jax_state(jart):
    rng = np.random.default_rng(3)
    jcodec, jstate = jenc.init_codec(jart, R)
    D, G = jcodec.w.D, jcodec.w.n_groups
    compressed = np.zeros((R, G), bool)
    compressed[0, :4] = True
    w = jstate.w.replace(
        q=jstate.w.q.replace(loc=jstate.w.q.loc + rng.normal(0, 0.01, (R, D)).astype(np.float32)),
        kl_beta=jnp.asarray(rng.uniform(1e-4, 1e-2, (R, G)).astype(np.float32)),
        compressed=jnp.asarray(compressed),
        indices=jnp.asarray(rng.integers(0, 256, (R, G)).astype(np.int32)))
    return jstate.replace(w=w)


def test_prior_fingerprints_equal_the_jax_packages(tmp_path):
    """Both formulas, on artifacts built alike and on one artifact file
    loaded by each package; another prior fingerprints otherwise."""
    jart, art = _artifacts()
    assert checkpoint.prior_fingerprint(art) == jck.prior_fingerprint(jart)
    assert checkpoint.accepted_fingerprints(art) == jck.accepted_fingerprints(jart)
    path = str(tmp_path / "prior.npz")
    checkpoint.save_prior_artifact(path, art)
    assert (checkpoint.accepted_fingerprints(checkpoint.load_prior_artifact(path))
            == jck.accepted_fingerprints(jck.load_prior_artifact(path)))
    other = _artifacts(seed=6)[1]
    assert checkpoint.prior_fingerprint(other) != checkpoint.prior_fingerprint(art)


def _jax_opt_state(jstate, scheduled):
    """optax's state for ``_make_opt`` after two updates, and its leaves."""
    sched = ("cosine", 6e-4, 2e-5, 100) if scheduled else None
    opt = jenc._make_opt(2e-4, sched)
    qs = jenc._trainables(jstate)
    o = opt.init(qs)
    for s in (1.0, -0.5):
        _, o = opt.update(jax.tree_util.tree_map(lambda a: s * jnp.ones_like(a), qs), o)
    return opt, qs, o


@pytest.mark.parametrize("scheduled", [False, True])
def test_jax_snapshot_loads_in_the_port(tmp_path, scheduled):
    """A snapshot the JAX package writes (with phase1_lr's scheduled Adam or
    plain Adam): state, header and Adam leaves, whose order is optax's
    (``jax.tree_util.tree_leaves`` of ``_make_opt(...).init``)."""
    jart, _ = _artifacts()
    jstate = _perturbed_jax_state(jart)
    _, _, o = _jax_opt_state(jstate, scheduled)
    leaves = jax.tree_util.tree_leaves(o)
    path = str(tmp_path / "jax_snap")
    jes.save_encode_state(path, jstate, extra={"phase1_epochs_done": 7, "resume_key": [1, 2]},
                          opt_leaves=leaves)
    state, header, opt_leaves = encode_state.load_encode_state_full(path + ".npz", device="cpu")
    for k, v in _state_arrays(state.w).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(_state_arrays(jstate.w)[k]), k)
    assert header["phase1_epochs_done"] == 7 and header["resume_key"] == [1, 2]
    assert encode_state.generator_state(header, "cpu") is None
    adam = encoder.AdamState.from_leaves(opt_leaves, scheduled, "cpu")
    assert adam.count == 2
    want = [o[0].mu["w"].loc, o[0].mu["w"].log_scale, o[0].nu["w"].loc, o[0].nu["w"].log_scale]
    for got, w in zip(adam.mu + adam.nu, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    # written back by the port, the leaves are the ones it read
    for a, b in zip(adam.leaves(scheduled), leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError):
        encoder.AdamState.from_leaves(opt_leaves, not scheduled, "cpu")


@pytest.mark.parametrize("scheduled", [False, True])
def test_port_snapshot_loads_in_the_jax_package(tmp_path, scheduled):
    """A snapshot the port writes: the JAX package reads its state and header,
    and its Adam leaves unflatten into ``_make_opt``'s state tree and carry on
    there."""
    jart, _ = _artifacts()
    jstate = _perturbed_jax_state(jart)
    state = convert.codec_state_from(jstate, "cpu")
    opt, qs, o = _jax_opt_state(jstate, scheduled)
    adam = encoder.AdamState(2, [torch.tensor(np.asarray(o[0].mu["w"].loc)),
                                 torch.tensor(np.asarray(o[0].mu["w"].log_scale))],
                             [torch.tensor(np.asarray(o[0].nu["w"].loc)),
                              torch.tensor(np.asarray(o[0].nu["w"].log_scale))])
    path = str(tmp_path / "port_snap.npz")
    gen = torch.Generator().manual_seed(4)
    encode_state.save_encode_state(
        path, state, extra={"phase1_epochs_done": 3, "prior_fingerprint": "ab",
                            encode_state.GENERATOR_FIELD: encode_state.generator_record(gen)},
        opt_leaves=adam.leaves(scheduled))
    jst, header, jleaves = jes.load_encode_state_full(path)
    for k, v in _state_arrays(jst.w).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(_state_arrays(jstate.w)[k]), k)
        assert np.asarray(v).dtype == np.asarray(_state_arrays(jstate.w)[k]).dtype, k
    assert header["phase1_epochs_done"] == 3 and "resume_key" not in header
    treedef = jax.tree_util.tree_structure(opt.init(qs))
    restored = jax.tree_util.tree_unflatten(treedef, jleaves)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(o)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    opt.update(qs, restored)  # the restored tree is one optax takes
    assert torch.equal(encode_state.generator_state(header, "cpu"), gen.get_state())


@pytest.fixture(scope="module")
def prior_and_images(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    _, art = _artifacts()
    checkpoint.save_prior_artifact(str(root / "prior.npz"), art)
    (root / "images").mkdir()
    for i, img in enumerate(_images(R, seed=11)):
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(root / "images" / f"{i}.png")
    return root


@pytest.fixture(scope="module")
def uninterrupted(prior_and_images, tmp_path_factory):
    """Each schedule's encode by the CLI, without a snapshot, run once."""
    runs = {}

    def run(schedule):
        if schedule not in runs:
            out = tmp_path_factory.mktemp(f"uninterrupted_{schedule}")
            runs[schedule] = compress_cli.main(_argv(prior_and_images, out, SCHEDULES[schedule]))
        return runs[schedule]

    return run


class Crash(RuntimeError):
    pass


def _argv(root, out, extra):
    return ["--test_dir", str(root / "images"), "--test_idx", "0", "--prior_path",
            str(root / "prior.npz"), "--save_dir", str(out), "--device", "cpu",
            "--sample_size", "2", "--seed", "3", *extra]


# A TINY image is one row, so test batches here hold one datapoint each.
SCHEDULES = {
    # the quality preset's knobs, cut to a few epochs: an adaptive, cosine
    # phase 1 in chunks of 10 epochs and fused, plateau-stopped finetunes
    # at a cosine lr; the stop fires in phase 1 (window 5)
    "quality": ["--schedule", "quality", "--n_epochs", "60", "--p1_stop", "5", "1e-2", "10",
                "--ft_stop", "2", "1e-3", "2", "--finetune_epochs", "4", "--fused_steps", "4"],
    # the reference schedule's fixed budgets with CRN finetunes, unfused,
    # a snapshot every 5 groups
    "reference_crn": ["--n_epochs", "20", "--finetune_epochs", "2", "--finetune_crn",
                      "--save_every", "5"],
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("crash_in", ["phase1", "phase1_end", "coding"])
def test_resume_after_a_crash_equals_the_uninterrupted_encode(prior_and_images, uninterrupted,
                                                              tmp_path, monkeypatch, schedule,
                                                              crash_in):
    """The CLI with --state_path, crashed (by the snapshot writer) after its
    first snapshot in phase 1, after the snapshot that ends phase 1 (for
    the quality run, the one its plateau stop writes), or after the first
    snapshot of the coding loop, then run again: the final indices and
    posteriors equal the run that was not interrupted, bit for bit."""
    extra = SCHEDULES[schedule] + ["--state_path", str(tmp_path / "state.npz")]
    want = uninterrupted(schedule)
    # phase 1 in chunks of 10 epochs, so that it takes several snapshots
    # (the uninterrupted run takes one chunk: chunking changes no number)
    monkeypatch.setattr(compress_cli, "compress",
                        functools.partial(progressive.compress, chunk_epochs=10))

    save = encode_state.save_encode_state

    n_epochs = int(SCHEDULES[schedule][SCHEDULES[schedule].index("--n_epochs") + 1])

    def crash_after_first(path, state, **kw):
        save(path, state, **kw)
        extra = kw["extra"]
        phase = ("coding" if "level" in extra else
                 "phase1_end" if extra["phase1_epochs_done"] == n_epochs else "phase1")
        if phase == crash_in:
            raise Crash(phase)

    monkeypatch.setattr(encode_state, "save_encode_state", crash_after_first)
    with pytest.raises(Crash):
        compress_cli.main(_argv(prior_and_images, tmp_path / "b", extra))
    monkeypatch.setattr(encode_state, "save_encode_state", save)
    _, header, _ = encode_state.load_encode_state_full(str(tmp_path / "state.npz"),
                                                       device="cpu")
    assert ("level" in header) == (crash_in == "coding")
    got = compress_cli.main(_argv(prior_and_images, tmp_path / "b", extra))
    np.testing.assert_array_equal(got.indices["w"], want.indices["w"])
    for f in ("loc", "log_scale"):
        assert torch.equal(getattr(got.state.w.q, f), getattr(want.state.w.q, f)), f
    np.testing.assert_array_equal(got.reconstruction, want.reconstruction)


def test_snapshots_a_resume_must_not_use(prior_and_images, tmp_path, capsys):
    """A snapshot of another prior is refused (and kept, not quarantined);
    the CLI warns and encodes from scratch. A torn snapshot is quarantined
    and the encode starts from scratch."""
    root = prior_and_images
    art = checkpoint.load_prior_artifact(str(root / "prior.npz"))
    path = str(tmp_path / "state.npz")
    _, state = decoder.init_codec(art, 1, device="cpu")
    encode_state.save_encode_state(path, state, extra={"prior_fingerprint": "0123456789abcdef"})
    with pytest.raises(encode_state.FingerprintMismatch):
        load_snapshot_or_none(path, lambda p: encode_state.load_encode_state_full(
            p, checkpoint.accepted_fingerprints(art), device="cpu"))
    assert os.path.exists(path)
    assert issubclass(encode_state.FingerprintMismatch, SnapshotRejected)
    argv = _argv(root, tmp_path / "out", ["--n_epochs", "2", "--finetune_epochs", "0",
                                          "--state_path", path])
    res = compress_cli.main(argv)
    assert "refusing to resume" in capsys.readouterr().out
    assert res.state.w.compressed.all()

    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    loaded, reason = load_snapshot_or_none(
        path, lambda p: encode_state.load_encode_state_full(p, device="cpu"))
    assert loaded is None and "unreadable" in reason
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 3])
    res = compress_cli.main(argv)
    assert res.state.w.compressed.all() and "unreadable" in capsys.readouterr().out
