"""The port's adaptive and quality schedules against the JAX package's, on
the CPU at TINY size: ``optimize_adaptive`` (the plateau stop),
``encode_chunk`` (the coding steps with fixed and plateau-stopped
finetunes, CRN and the cosine finetune lr), ``resolve_schedule``, and whole
encodes on both presets decoded by both packages.

JAX's noise is replayed through an explicit noise source: the test splits
the keys as the JAX function does (``k, sub = split(k)`` per epoch in
``optimize_adaptive`` and the adaptive finetunes, one pre-split array per
fixed finetune) and hands each epoch's draws to the port as numpy.
Tolerances: stop epochs, epochs run, indices and coded masks are equal;
posteriors and window sums within ``_close`` (rtol 1e-5, atol 1e-5 x the
largest entry: f32 sums in another order); decoded reconstructions within
``DECODE_TOL``. The plateau tests of ``optimize_adaptive`` sit at least 10%
of ``rel_tol`` away from their threshold on these inputs, so that f32
rounding cannot flip them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from recombiner_tpu.cli import compress as jax_compress_cli
from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.coords import grid_fourier_features
from recombiner_tpu.io import bitstream as jax_bitstream
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.coding import decoder, encoder
from recombiner_tpu_torch.io import bitstream, checkpoint, convert
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encode import DECODE_TOL, _artifacts, _close, _images, _replayed_noise

R, S = 3, 2
LR = 2e-3


@pytest.fixture(scope="module")
def setup():
    jart, art = _artifacts()
    cfg = jart.config
    jcodec, jstate = jenc.init_codec(jart, R)
    codec, _ = decoder.init_codec(art, R, device="cpu")
    codec = convert.with_codebook(codec, jcodec.w)
    X = np.ascontiguousarray(np.broadcast_to(
        grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim),
        (R, cfg.n_pixels, cfg.fourier_dim)))
    Y = _images(R).reshape(R, cfg.n_pixels, 3)
    return jart, art, jcodec, jstate, codec, X, Y


def _copy(jstate):
    """A copy for a JAX function that donates its state argument."""
    return jax.tree_util.tree_map(jnp.copy, jstate)


class Replay:
    """Each call returns the next epoch's noise of JAX's ``k, sub = split(k)``
    chain from ``key``."""

    def __init__(self, key, cfg):
        self.key, self.cfg = key, cfg

    def __call__(self):
        self.key, sub = jax.random.split(self.key)
        return _replayed_noise(sub, self.cfg, R, S)


def _jax_adaptive(setup, key, epoch0, max_epoch, min_epoch, rel_tol, es, window, monitor,
                  state=None, opt_state=None):
    jart, _, jcodec, jstate, _, X, Y = setup
    state = _copy(jstate) if state is None else state
    return jenc.optimize_adaptive(
        jcodec, state, jnp.asarray(X), jnp.asarray(Y), key, epoch0, max_epoch, min_epoch, rel_tol,
        es, cfg=jart.config, lr=LR, sample_size=S, window=window, monitor=monitor,
        opt_state=opt_state)


def _port_adaptive(setup, source, epoch0, max_epoch, min_epoch, rel_tol, es, window, monitor,
                   state=None, opt_state=None):
    jart, art, _, jstate, codec, X, Y = setup
    st = convert.codec_state_from(jstate, "cpu") if state is None else state
    return encoder.optimize_adaptive(
        codec, st, torch.from_numpy(X), torch.from_numpy(Y), art.config, source, epoch0,
        max_epoch, min_epoch, rel_tol, es, lr=LR, sample_size=S, window=window,
        opt_state=opt_state, monitor=monitor)


def _assert_same_run(got, want, what):
    st, _, es, i, stopped = got
    jst, _, _, jes, ji, jstopped = want
    assert (i, stopped) == (int(ji), bool(jstopped)), what
    _close(np.array(es), np.array([float(v) for v in jes]), f"{what}: es_carry")
    _close(st.w.q.loc.numpy(), jst.w.q.loc, f"{what}: loc")
    _close(st.w.q.log_scale.numpy(), jst.w.q.log_scale, f"{what}: log_scale")
    np.testing.assert_array_equal(st.w.kl_beta.numpy(), np.asarray(jst.w.kl_beta))


@pytest.mark.parametrize("case,rel_tol,window,min_epoch,monitor,stop_at", [
    ("never stops", -math.inf, 4, 0, "loss", 24),
    ("first eligible boundary", math.inf, 4, 0, "mse", 8),
    ("first eligible boundary after min_epoch", math.inf, 4, 10, "loss", 12),
    ("plateau of the mse", 0.045, 5, 10, "mse", 40),
    ("plateau of the loss", 0.003, 4, 10, "loss", 12),
])
def test_optimize_adaptive_stops_where_jax_does(setup, case, rel_tol, window, min_epoch,
                                                monitor, stop_at):
    """One call from epoch 0 with a ceiling of 24 (60 for the mse plateau):
    the same stop epoch, carry and posteriors as the JAX package's."""
    jart = setup[0]
    key = jax.random.key(0)
    max_epoch = 60 if case == "plateau of the mse" else 24
    es = (math.inf, 0.0)
    want = _jax_adaptive(setup, key, 0, max_epoch, min_epoch, rel_tol, es, window, monitor)
    got = _port_adaptive(setup, Replay(key, jart.config), 0, max_epoch, min_epoch, rel_tol, es,
                         window, monitor)
    _assert_same_run(got, want, case)
    assert got[3] == stop_at and got[4] == (stop_at < max_epoch)


def test_optimize_adaptive_in_chunks_runs_as_jax_does(setup):
    """Two chunks with global epoch counts (17 is no multiple of the window
    or of the annealing gap), threading Adam, the carry and the key: the
    same stop as the JAX package's chunks and as the port's single call."""
    jart = setup[0]
    key = jax.random.key(0)
    args = dict(min_epoch=10, rel_tol=0.045, window=5, monitor="mse")
    j1 = _jax_adaptive(setup, key, 0, 17, es=(math.inf, 0.0), **args)
    j2 = _jax_adaptive(setup, j1[2], 17, 60, es=j1[3], state=j1[0], opt_state=j1[1], **args)
    src = Replay(key, jart.config)
    p1 = _port_adaptive(setup, src, 0, 17, es=(math.inf, 0.0), **args)
    assert p1[3] == 17 and not p1[4]
    p2 = _port_adaptive(setup, src, 17, 60, es=p1[2], state=p1[0], opt_state=p1[1], **args)
    _assert_same_run(p2, j2, "second chunk")
    one = _port_adaptive(setup, Replay(key, jart.config), 0, 60, es=(math.inf, 0.0), **args)
    assert one[3:] == p2[3:] == (40, True)
    assert torch.equal(one[0].w.q.loc, p2[0].w.q.loc)


class FinetuneReplay:
    """The port's per-finetune noise (``encode_chunk``'s ``noise``) replaying
    the JAX encode_chunk's keys: ``k, ft_key = split(k)`` per step (or the
    CRN key every time), then the fixed finetune's pre-split array or the
    adaptive finetune's per-epoch chain."""

    def __init__(self, key, crn_key, crn, window, n_ft, cfg):
        self.key, self.crn_key, self.crn = key, crn_key, crn
        self.window, self.n_ft, self.cfg = window, n_ft, cfg

    def __call__(self):
        if self.crn:
            ft_key = self.crn_key
        else:
            self.key, ft_key = jax.random.split(self.key)
        if self.window > 0:
            return Replay(ft_key, self.cfg)
        _, sub = jax.random.split(ft_key)
        keys = iter(jax.random.split(sub, self.n_ft))
        return lambda: _replayed_noise(next(keys), self.cfg, R, S)


@pytest.mark.parametrize("window,crn,lr_schedule", [
    (0, False, None), (0, True, None), (3, False, None), (3, True, None), (3, False, "cosine"),
])
def test_encode_chunk_codes_what_jax_codes(setup, window, crn, lr_schedule):
    """Four group steps with fixed (6 epochs) or plateau-stopped (ceiling 12,
    window 3) finetunes, CRN off and on, constant and cosine finetune lr,
    from one state and one codebook: equal indices, coded masks and epochs
    run, and the coded samples within ``_close``. (The posteriors are not
    compared here: after up to 48 Adam epochs at lr 2e-3 the two packages'
    rounding differences reach about 2e-5 of the largest entry; the
    ``optimize_adaptive`` tests compare them over fewer epochs.)"""
    jart, art, jcodec, jstate, codec, X, Y = setup
    cfg = jart.config
    key, crn_key = jax.random.key(7), jax.random.key(8)
    n_ft = 12 if window else 6
    kw = dict(n_steps=4, n_ft=n_ft, lr=LR, sample_size=S, window=window,
              lr_schedule=lr_schedule)
    jst, _, jran = jenc.encode_chunk(jcodec, _copy(jstate), jnp.asarray(X), jnp.asarray(Y), key,
                                     crn_key, 3, 2e-3, cfg=cfg, level="w", crn=crn, **kw)
    st, ran = encoder.encode_chunk(
        codec, convert.codec_state_from(jstate, "cpu"), torch.from_numpy(X),
        torch.from_numpy(Y), art.config, FinetuneReplay(key, crn_key, crn, window, n_ft, cfg),
        3, 2e-3, **kw)
    np.testing.assert_array_equal(ran, np.asarray(jran))
    np.testing.assert_array_equal(st.w.indices.numpy(), np.asarray(jst.w.indices))
    np.testing.assert_array_equal(st.w.compressed.numpy(), np.asarray(jst.w.compressed))
    assert st.w.compressed.sum() == 4 * R
    _close(st.w.frozen_val.numpy(), jst.w.frozen_val, "frozen values")
    if window:
        assert (ran < n_ft).any()


def test_crn_restarts_one_stream_without_drawing_from_the_main_one():
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    noise = encoder.finetune_noise(gen, crn=True)
    a = torch.randn(4, generator=noise())
    b = torch.randn(4, generator=noise())
    assert torch.equal(a, b) and torch.equal(gen.get_state(), before)
    assert not torch.equal(a, torch.randn(4, generator=torch.Generator().manual_seed(5)))
    assert encoder.finetune_noise(gen)() is gen


_BASE = ["--test_dir", "d", "--test_idx", "0", "--prior_path", "p.npz", "--save_dir", "o"]


@pytest.mark.parametrize("schedule", ["reference", "adaptive", "quality"])
@pytest.mark.parametrize("extra", [
    [],
    ["--n_epochs", "900", "--p1_lr", "1e-3", "1e-5", "--p1_samples", "2"],
    ["--p1_stop", "100", "1e-2", "300", "--ft_stop", "10", "1e-2", "20", "--fused_steps", "2",
     "--ft_lr", "3e-4", "--ft_lr_schedule", "cosine"],
])
def test_resolve_schedule_matches_jax(schedule, extra):
    argv = _BASE + ["--schedule", schedule] + extra
    assert compress_cli.resolve_schedule(compress_cli.parse_args(argv)) == \
        jax_compress_cli.resolve_schedule(jax_compress_cli.parse_args(argv))


def test_presets_are_the_jax_packages():
    assert compress_cli.ADAPTIVE_PRESET == jax_compress_cli.ADAPTIVE_PRESET
    assert compress_cli.QUALITY_PRESET == jax_compress_cli.QUALITY_PRESET
    assert compress_cli.SCHEDULE_PRESETS == jax_compress_cli.SCHEDULE_PRESETS


@pytest.mark.parametrize("schedule,extra", [
    ("adaptive", ["--n_epochs", "30", "--p1_stop", "5", "1e-2", "10", "--finetune_epochs", "6",
                  "--ft_stop", "2", "1e-3", "2"]),
    ("quality", ["--n_epochs", "30", "--p1_stop", "5", "1e-2", "10", "--finetune_epochs", "6",
                 "--ft_stop", "2", "1e-3", "2", "--fused_steps", "2"]),
])
def test_tiny_preset_encode_decodes_in_both_packages(tmp_path, schedule, extra):
    """The port's CLI on a TINY preset (depth cut): its bitstream decodes in
    both packages to compress's reconstruction (DECODE_TOL), the adaptive
    stops fire, and the finetunes run under their budget."""
    jart, art = _artifacts()
    prior = str(tmp_path / "prior.npz")
    checkpoint.save_prior_artifact(prior, art)
    (tmp_path / "images").mkdir()
    for i, img in enumerate(_images(2, seed=9)):
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(tmp_path / "images" / f"{i}.png")
    out = tmp_path / "out"
    res = compress_cli.main(["--test_dir", str(tmp_path / "images"), "--test_idx", "0",
                             "--prior_path", prior, "--save_dir", str(out), "--device", "cpu",
                             "--sample_size", "2", "--schedule", schedule, *extra])
    t = res.timings
    assert t["phase1_epochs"] < 30 and t["finetune_epochs"] < t["finetune_budget"] == 6 * 32
    path = str(out / "bitstream_test_id_0.rctb")
    _, idx_t = bitstream.read_bitstream(path)
    _, idx_j = jax_bitstream.read_bitstream(path)
    jart = jck.load_prior_artifact(prior)
    X = grid_fourier_features(art.config.pixel_sizes, art.config.fourier_dim)[None]
    y_port = decoder.decode(decoder.init_codec(art, 1, device="cpu")[0], idx_t, X,
                            art.config).numpy()
    y_jax = np.asarray(jenc.decode(jenc.init_codec(jart, 1)[0], idx_j, jnp.asarray(X),
                                   jart.config))
    np.testing.assert_allclose(y_port, res.reconstruction, rtol=0, atol=0)
    np.testing.assert_allclose(y_jax, res.reconstruction, **DECODE_TOL)
