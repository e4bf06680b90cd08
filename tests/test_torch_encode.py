"""The port's encode slice against the JAX package's, on the CPU at TINY size.

Both packages start from one prior (built from the same numpy values) and,
where a test needs it, one state and one codebook carried across with
``recombiner_tpu_torch.io.convert``. JAX's noise is replayed: the test draws
it with ``jax.random`` from the keys ``predict`` splits internally and hands
it to the port as numpy. Tolerances (each test says which it uses):

- ``_close``: rtol 1e-5, atol 1e-5 x the largest entry: f32 sums in another
  order (the conv stack, the SIREN chain at w0 = 30, the KL sums);
- indices, coded masks and betas of an encode step: equal;
- a decoded reconstruction: atol 3e-5, rtol 1e-5, that of
  tests/test_torch_decode.py.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.coding import progressive as jprog
from recombiner_tpu.cli import compress as jax_compress_cli
from recombiner_tpu.coding.gumbel import gumbel_chain as jax_gumbel_chain
from recombiner_tpu.config import TINY as JTINY
from recombiner_tpu.coords import grid_fourier_features
from recombiner_tpu.io import bitstream as jax_bitstream
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.metrics import metric as jax_metric
from recombiner_tpu.models.gaussian import Gaussian as JGaussian
from recombiner_tpu.models.gaussian import kl_gaussian as jax_kl_gaussian
from recombiner_tpu.priors.grouping import compute_grouping as jax_compute_grouping
from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.cli import decompress as decompress_cli
from recombiner_tpu_torch.coding import decoder, encoder, progressive
from recombiner_tpu_torch.coding.gumbel import gumbel_chain
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.io import bitstream, checkpoint, convert
from recombiner_tpu_torch.metrics import metric
from recombiner_tpu_torch.models.gaussian import Gaussian, kl_gaussian
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.priors.grouping import compute_grouping
from recombiner_tpu_torch.utils import platform

DECODE_TOL = dict(atol=3e-5, rtol=1e-5)
R, S = 3, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """TINY tensors gain nothing from torch's intra-op threads, and with one
    thread pool per test worker they oversubscribe the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


def _artifacts(seed=5):
    """One TINY prior as the JAX package's artifact and as the port's."""
    cfg = JTINY
    rng = np.random.default_rng(seed)
    D = cfg.n_coded_params
    p_loc = rng.normal(0, 0.02, D).astype(np.float32)
    p_scale = rng.uniform(0.005, 0.05, D).astype(np.float32)
    avg_log_scale = rng.normal(-4, 0.1, D).astype(np.float32)
    kl_bits = rng.exponential(0.5, D)
    A = [rng.uniform(-0.1, 0.1, (d, d)).astype(np.float32) for d in cfg.layer_param_counts]
    up = {}
    for i, (cin, cout, k) in enumerate([(128, 64, 5), (64, 64, 3), (64, 16, 3)]):
        b = 1 / np.sqrt(cin * k * k)
        up[f"conv{i}"] = {"w": rng.uniform(-b, b, (k, k, cin, cout)).astype(np.float32),
                          "b": rng.uniform(-b, b, cout).astype(np.float32)}
    jart = jck.PriorArtifact(
        config=cfg, kl_beta=1e-3, w=jck.LevelArtifact(
            p_loc, p_scale, avg_log_scale, jax_compute_grouping(kl_bits, cfg.bits_per_group)),
        h=None, hh=None, A=A, up=up, codebook_seed=42)
    art = checkpoint.PriorArtifact(
        config=get_config("tiny"), kl_beta=1e-3, w=checkpoint.LevelArtifact(
            p_loc, p_scale, avg_log_scale, compute_grouping(kl_bits, cfg.bits_per_group)),
        h=None, hh=None, A=A, up=up, codebook_seed=42)
    return jart, art


def _images(n, seed=2):
    """Smooth [0.1, 0.9] images of TINY's 16 x 16 x 3, as (Y (n, P, 3))."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16), indexing="ij")
    imgs = np.stack([np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx
                                                               + rng.uniform(0.5, 2) * yy)
                                                  + rng.uniform(0, 6))
                               for _ in range(3)], -1) for _ in range(n)])
    return imgs.astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """Both packages' codecs and one perturbed state (posteriors moved off the
    prior, random betas, some groups coded, row 2 fully coded)."""
    jart, art = _artifacts()
    cfg = jart.config
    jcodec, jstate = jenc.init_codec(jart, R)
    codec, _ = decoder.init_codec(art, R, device="cpu")
    rng = np.random.default_rng(1)
    D, G = jcodec.w.D, jcodec.w.n_groups
    compressed = np.zeros((R, G), bool)
    compressed[0, :5] = True
    compressed[2, :] = True
    jstate = jstate.replace(w=jstate.w.replace(
        q=JGaussian(jstate.w.q.loc + rng.normal(0, 0.01, (R, D)).astype(np.float32),
                    jstate.w.q.log_scale + rng.normal(0, 0.3, (R, D)).astype(np.float32)),
        kl_beta=jnp.asarray(rng.uniform(1e-4, 1e-2, (R, G)).astype(np.float32)),
        compressed=jnp.asarray(compressed)))
    X = np.ascontiguousarray(np.broadcast_to(
        grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim),
        (R, cfg.n_pixels, cfg.fourier_dim)))
    Y = _images(R).reshape(R, cfg.n_pixels, 3)
    return jart, art, jcodec, jstate, codec, X, Y


def test_kl_gaussian_and_gumbel_chain_match_jax():
    rng = np.random.default_rng(0)
    a = [rng.uniform(0.01, 1.0, 50).astype(np.float32) for _ in range(4)]
    _close(kl_gaussian(*map(torch.from_numpy, a)).numpy(), jax_kl_gaussian(*map(jnp.asarray, a)))
    np.testing.assert_array_equal(gumbel_chain(2**16, 42), jax_gumbel_chain(2**16, 42))


def test_level_meta_matches_jax(setup):
    _, _, jcodec, _, codec, _, _ = setup
    for f in ("param2group", "group2param", "group_of_col", "group_start", "group_size"):
        np.testing.assert_array_equal(getattr(codec.w, f).numpy(), getattr(jcodec.w, f))
    np.testing.assert_array_equal(codec.w.gumbel.numpy(), jcodec.w.gumbel)


def test_kl_and_annealing_match_jax(setup):
    """group_kl, beta_weighted_kl and update_betas (``_close``; the betas equal)."""
    _, art, jcodec, jstate, codec, _, _ = setup
    ls = convert.codec_state_from(jstate, "cpu").w
    _close(encoder.group_kl(ls, codec.w).numpy(), jenc.group_kl(jstate.w, jcodec.w), "group_kl")
    _close(encoder.beta_weighted_kl(ls, codec.w).item(),
           jenc.beta_weighted_kl(jstate.w, jcodec.w), "beta_weighted_kl")
    for bits in (art.config.bits_per_group, 3.0):
        got = encoder.update_betas(ls, codec.w, bits).kl_beta.numpy()
        want = np.asarray(jenc.update_betas(jstate.w, jcodec.w, bits).kl_beta)
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, ls.kl_beta.numpy())  # a 3-bit budget moves betas


def _replayed_noise(key, cfg, R, S):
    """The noise JAX's predict draws from ``key`` (encoder.py:305-323 and
    models/mappings.py:146-147), as numpy."""
    k_lpe, k_w = jax.random.split(key)
    lpe = jax.random.normal(k_lpe, (R, S, *cfg.lpe_spatial, cfg.latent_dim))
    k1, _, _ = jax.random.split(k_w, 3)
    w = jax.random.normal(k1, (R, S, cfg.n_inr_params))
    return np.array(lpe), np.array(w)


def test_one_elbo_epoch_matches_jax(setup):
    """Loss, its scaled-mse term and the gradients of one epoch against
    jax.value_and_grad of ``_elbo_loss_fn(with_aux=True)``, with JAX's noise
    replayed (``_close``)."""
    jart, art, jcodec, jstate, codec, X, Y = setup
    key = jax.random.key(3)
    loss_fn = jenc._elbo_loss_fn(jcodec, jnp.asarray(X), jnp.asarray(Y), jart.config, S, None,
                                 False, with_aux=True)
    (jloss, jmse), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        {"w": jstate.w.q}, jstate, key)

    st = convert.codec_state_from(jstate, "cpu")
    params = [st.w.q.loc.requires_grad_(), st.w.q.log_scale.requires_grad_()]
    loss, mse = encoder.elbo_loss(codec, st, torch.from_numpy(X), torch.from_numpy(Y),
                                  art.config, S, noise=_replayed_noise(key, jart.config, R, S))
    g_loc, g_log_scale = torch.autograd.grad(loss, params)
    _close(loss.item(), jloss, "loss")
    _close(mse.item(), jmse, "mse")
    _close(g_loc.numpy(), jgrads["w"].loc, "d loc")
    _close(g_log_scale.numpy(), jgrads["w"].log_scale, "d log_scale")


@pytest.mark.parametrize("schedule", [None, ("cosine", 6e-4, 2e-5, 4)])
def test_adam_matches_optax(schedule):
    """Six steps of the port's Adam against optax's, on the same gradients
    (``_close``); with a schedule, past its end."""
    rng = np.random.default_rng(4)
    p0 = [rng.normal(0, 1, (3, 7)).astype(np.float32), rng.normal(0, 1, 5).astype(np.float32)]
    grads = [[rng.normal(0, s, p.shape).astype(np.float32) for p in p0] for s in (1, 1e-3, 10,
                                                                                  1, 1, 1)]
    opt = jenc._make_opt(2e-4, schedule)
    jp = [jnp.asarray(p) for p in p0]
    jst = opt.init(jp)
    tp = [torch.tensor(p) for p in p0]
    rate = encoder.cosine_lr(*schedule[1:]) if schedule else 2e-4
    st = encoder.adam_init(tp)
    for g in grads:
        upd, jst = opt.update([jnp.asarray(x) for x in g], jst)
        jp = optax.apply_updates(jp, upd)
        st = encoder.adam_step(tp, [torch.tensor(x) for x in g], st, rate)
    assert st.count == len(grads)
    for got, want in zip(tp, jp):
        _close(got.numpy(), want)


def test_optimize_anneals_after_the_gradient_each_call(setup):
    """i % KL_ADJUST_GAP == 0 anneals on the pre-step state, and i restarts
    at 0 in each call."""
    _, art, jcodec, jstate, codec, X, Y = setup
    cfg = art.config
    X, Y = torch.from_numpy(X), torch.from_numpy(Y)
    st = convert.codec_state_from(jstate, "cpu")
    gen = torch.Generator().manual_seed(0)
    want = encoder.update_betas(st.w, codec.w, cfg.bits_per_group).kl_beta
    one = encoder.optimize(codec, st, X, Y, cfg, gen, n_epochs=2, sample_size=S)
    torch.testing.assert_close(one.w.kl_beta, want, rtol=0, atol=0)
    assert not torch.equal(one.w.q.loc, st.w.q.loc)
    two = encoder.optimize(codec, one, X, Y, cfg, gen, n_epochs=1, sample_size=S)
    torch.testing.assert_close(two.w.kl_beta,
                               encoder.update_betas(one.w, codec.w, cfg.bits_per_group).kl_beta,
                               rtol=0, atol=0)
    assert torch.equal(st.w.kl_beta, convert.codec_state_from(jstate, "cpu").w.kl_beta)


def test_encode_step_level_indices_equal_jax(setup):
    """One encode step from one state and one codebook: indices, coded
    groups and betas equal; frozen values equal (``_close``); row 2, fully coded,
    is left as it was."""
    _, _, jcodec, jstate, codec, _, _ = setup
    codec = convert.with_codebook(codec, jcodec.w)
    want = jenc.encode_step_level(jstate.w, jcodec.w)
    ls = convert.codec_state_from(jstate, "cpu").w
    got = encoder.encode_step_level(ls, codec.w)
    np.testing.assert_array_equal(got.indices.numpy(), want.indices)
    np.testing.assert_array_equal(got.compressed.numpy(), want.compressed)
    np.testing.assert_array_equal(got.kl_beta.numpy(), want.kl_beta)
    np.testing.assert_array_equal(got.frozen_mask.numpy(), want.frozen_mask)
    _close(got.frozen_val.numpy(), want.frozen_val)
    assert (got.compressed.sum(1) - ls.compressed.sum(1)).tolist() == [1, 1, 0]
    assert torch.equal(got.frozen_val[2], ls.frozen_val[2])
    # and again from there: the second step picks the next groups alike
    got2 = encoder.encode_step(codec, decoder.CodecState(w=got, h=None, hh=None))
    want2 = jenc.encode_step_level(want, jcodec.w)
    np.testing.assert_array_equal(got2.w.indices.numpy(), want2.indices)


def test_tiny_compress_decodes_in_both_packages(setup, tmp_path):
    """A TINY encode by the port (CPU): its bitstream decodes in both
    packages to the same reconstruction (DECODE_TOL) and to compress's own;
    the bpp equals the JAX package's; the mean PSNR is within 0.25 dB of the
    JAX package's encode at the same budgets (the two draw different noise;
    the difference measured on this case is about 0.03 dB)."""
    jart, art, _, _, _, X, Y = setup
    cfg, jcfg = art.config, jart.config
    budgets = dict(n_optimize_epochs=50, sample_size=2, lr=2e-3, finetune_overrides={"w": 2})
    codec, state = decoder.init_codec(art, R, device="cpu")
    res = progressive.compress(codec, state, X, Y, cfg, torch.Generator().manual_seed(0),
                               **budgets)
    assert res.indices["w"].shape == (R, codec.w.n_groups)
    assert res.state.w.compressed.all()
    assert res.timings["phase1_epochs"] == 50
    assert res.timings["finetune_epochs"] == 2 * codec.w.n_groups

    path = str(tmp_path / "bitstream_test_id_0.rctb")
    bitstream.write_bitstream(path, res.indices, config_name=cfg.name,
                              codebook_seed=art.codebook_seed, bits_per_group=cfg.bits_per_group)
    _, idx_t = bitstream.read_bitstream(path)
    _, idx_j = jax_bitstream.read_bitstream(path)
    y_port = decoder.decode(decoder.init_codec(art, R, device="cpu")[0], idx_t, X, cfg).numpy()
    y_jax = np.asarray(jenc.decode(jenc.init_codec(jart, R)[0], idx_j, jnp.asarray(X), jcfg))
    np.testing.assert_allclose(y_port, res.reconstruction, rtol=0, atol=0)
    np.testing.assert_allclose(y_port, y_jax, **DECODE_TOL)
    np.testing.assert_allclose(res.distortion, jax_metric(Y, y_jax, "tiny"), atol=1e-3)

    jcodec, jstate = jenc.init_codec(jart, R)
    jres = jprog.compress(jcodec, jstate, jnp.asarray(X), jnp.asarray(Y), jcfg,
                          jax.random.key(0), **budgets)
    assert res.bitrate == jres.bitrate
    assert abs(np.mean(res.distortion) - np.mean(jres.distortion)) < 0.25


def test_compress_raises_on_what_later_slices_port(setup):
    """``remat=True`` raised here until the patch slice ported it; now it
    runs, and recomputing the forward in the backward changes no number:
    the indices and posteriors equal those of the run without it."""
    _, art, _, _, codec, X, Y = setup
    state = decoder.init_codec(art, R, device="cpu")[1]
    res = [progressive.compress(codec, state, X, Y, art.config, torch.Generator().manual_seed(1),
                                n_optimize_epochs=3, sample_size=S,
                                finetune_overrides={"w": 1}, remat=remat)
           for remat in (True, False)]
    np.testing.assert_array_equal(res[0].indices["w"], res[1].indices["w"])
    assert torch.equal(res[0].state.w.q.loc, res[1].state.w.q.loc)
    assert torch.equal(res[0].state.w.q.log_scale, res[1].state.w.q.log_scale)


def test_small_copies_match_jax():
    cfg, jcfg = get_config("tiny"), JTINY
    assert progressive.finetune_epochs(cfg, 125, "w") == jprog.finetune_epochs(jcfg, 125, "w")
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0, 1, (4, 30, 3)), rng.uniform(-0.1, 1.1, (4, 30, 3))
    for name in ("cifar", "kodak", "audio", "protein"):
        np.testing.assert_array_equal(metric(a, b, name), jax_metric(a, b, name))


def test_cli_compress_on_png_dir(tmp_path, monkeypatch):
    """The port's compress CLI with --device cpu on a directory of PNGs (one
    test batch: one image for TINY), then its decompress CLI on the
    bitstream it wrote; with ``--n_devices 2`` two ranks encode the one
    image (replicated: it does not divide) and rank 0 writes the same
    bitstream."""
    from PIL import Image

    jart, art = _artifacts()
    prior = str(tmp_path / "prior.npz")
    checkpoint.save_prior_artifact(prior, art)
    images = tmp_path / "images"
    images.mkdir()
    for i, img in enumerate(_images(2, seed=7)):
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(images / f"{i:02d}.png")
    out = tmp_path / "out"
    res = compress_cli.main(["--test_dir", str(images), "--test_idx", "0", "--prior_path", prior,
                             "--save_dir", str(out), "--device", "cpu", "--n_epochs", "5",
                             "--finetune_epochs", "1", "--sample_size", "2", "--seed", "1"])
    names = sorted(os.listdir(out))
    assert names == ["Distortion_test_id_0.csv", "GroupIndex_test_id_0.csv",
                     "bitstream_test_id_0.rctb"]
    header, idx = jax_bitstream.read_bitstream(str(out / "bitstream_test_id_0.rctb"))
    assert header["config"] == "tiny" and header["test_idx"] == 0
    np.testing.assert_array_equal(idx["w"], res.indices["w"])
    np.testing.assert_array_equal(np.loadtxt(out / "GroupIndex_test_id_0.csv", delimiter=",",
                                             ndmin=2),
                                  res.indices["w"])
    y = decompress_cli.main(["--bitstream", str(out / "bitstream_test_id_0.rctb"),
                             "--prior_path", prior, "--save_dir", str(out), "--device", "cpu"])
    np.testing.assert_allclose(y, res.reconstruction, rtol=0, atol=0)
    # --remat runs (it raised before the patch slice) and changes no number
    again = compress_cli.main(["--test_dir", str(images), "--test_idx", "0", "--prior_path",
                               prior, "--save_dir", str(tmp_path / "remat"), "--device", "cpu",
                               "--n_epochs", "5", "--finetune_epochs", "1", "--sample_size", "2",
                               "--seed", "1", "--remat"])
    np.testing.assert_array_equal(again.indices["w"], res.indices["w"])
    np.testing.assert_array_equal(again.reconstruction, res.reconstruction)
    monkeypatch.setattr(launch, "spawn", functools.partial(launch.spawn, timeout_s=300))
    two = tmp_path / "two"
    assert compress_cli.main(["--test_dir", str(images), "--test_idx", "0", "--prior_path",
                              prior, "--save_dir", str(two), "--device", "cpu", "--n_epochs",
                              "5", "--finetune_epochs", "1", "--sample_size", "2", "--seed", "1",
                              "--n_devices", "2"]) is None
    assert sorted(os.listdir(two)) == names
    with open(two / "bitstream_test_id_0.rctb", "rb") as f, \
            open(out / "bitstream_test_id_0.rctb", "rb") as g:
        assert f.read() == g.read()


def test_predict_sample_form_matches_jax(setup):
    """predict with JAX's noise replayed, S = 2 (``_close``), and the generator form
    draws fresh noise of the same shapes."""
    jart, art, jcodec, jstate, codec, X, _ = setup
    key = jax.random.key(9)
    want = jenc.predict(jcodec, jstate, jnp.asarray(X), key, jart.config, sample_size=S)
    st = convert.codec_state_from(jstate, "cpu")
    with torch.no_grad():
        got = decoder.predict(codec, st, torch.from_numpy(X), art.config, S,
                              noise=_replayed_noise(key, jart.config, R, S))
        a = decoder.predict(codec, st, torch.from_numpy(X), art.config, S,
                            generator=torch.Generator().manual_seed(1))
        b = decoder.predict(codec, st, torch.from_numpy(X), art.config, S,
                            generator=torch.Generator().manual_seed(1))
    _close(got.numpy(), want)
    assert a.shape == got.shape and torch.equal(a, b) and not torch.equal(a, got)
    assert dataclasses.is_dataclass(st) and isinstance(st.w.q, Gaussian)


def test_optimize_runs_in_exact_f32(setup, monkeypatch):
    """With ``precision='highest'``, or with None under an exact ambient
    (``--precision highest``), TF32 is off in cuBLAS and cuDNN for every
    epoch, whatever the caller had set, and restored after; with None under
    the default ambient it is on (TF32, the card's ambient f32)."""
    _, art, _, jstate, codec, X, Y = setup
    seen = []
    loss = encoder.elbo_loss

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return loss(*a, **k)

    monkeypatch.setattr(encoder, "elbo_loss", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(platform, "AMBIENT", "high")

    def run(precision):
        encoder.optimize(codec, convert.codec_state_from(jstate, "cpu"), torch.from_numpy(X),
                         torch.from_numpy(Y), art.config, torch.Generator(), n_epochs=2,
                         sample_size=1, precision=precision)

    run("highest")
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    run(None)
    assert seen[2:] == [(True, True)] * 2
    platform.apply_matmul_precision("highest")
    run(None)
    assert seen[4:] == [(False, False)] * 2
    assert not torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("adaptive", [False, True])
def test_epochs_run_on_deterministic_cudnn_algorithms(setup, monkeypatch, adaptive):
    """optimize and optimize_adaptive restrict cuDNN to deterministic
    algorithms for every epoch, whatever the caller had set, and restore it
    after: cuDNN's own choice for the conv stack's data gradient sums in no
    fixed order on the card, and a resumed encode must repeat."""
    _, art, _, jstate, codec, X, Y = setup
    seen = []
    loss = encoder.elbo_loss

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.deterministic)
        return loss(*a, **k)

    monkeypatch.setattr(encoder, "elbo_loss", spy)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    args = (codec, convert.codec_state_from(jstate, "cpu"), torch.from_numpy(X),
            torch.from_numpy(Y), art.config, torch.Generator())
    if adaptive:
        encoder.optimize_adaptive(*args, 0, 2, 0, 0.0, (np.inf, 0.0), sample_size=1, window=1)
    else:
        encoder.optimize(*args, n_epochs=2, sample_size=1)
    assert seen == [True] * 2
    assert torch.backends.cudnn.deterministic is False


_CLI_BASE = ["--test_dir", "d", "--test_idx", "0", "--prior_path", "p.npz", "--save_dir", "o"]


@pytest.mark.parametrize("extra", [
    [],
    ["--no-remat"],
    ["--no-finetune_crn"],
    ["--no-remat", "--no-finetune_crn", "--sync_every", "1", "--save_every", "10",
     "--p1_monitor", "mse", "--fused_steps", "8", "--n_devices", "1", "--precision", "highest"],
    ["--precision", "scoped"],
    ["--precision", "scoped_high"],
    ["--precision", "default"],
    ["--precision", "high"],
])
def test_cli_takes_the_jax_clis_reference_invocations(extra):
    """The JAX CLI's default invocation and its --no-* forms parse in both
    packages with equal values for every shared flag, and the port runs
    them (the device count they ask for is one the port starts)."""
    jargs = vars(jax_compress_cli.parse_args(_CLI_BASE + extra))
    args = vars(compress_cli.parse_args(_CLI_BASE + extra))
    assert set(jargs) == set(args)
    assert jargs == args
    assert launch.requested_world(args["n_devices"], "cpu") >= 1


@pytest.mark.parametrize("extra,queue", [
    (["--n_devices", "2"], "scale-out"),
])
def test_cli_raises_on_each_value_the_port_does_not_run(extra, queue):
    """The JAX CLI parses the invocation, and since the scale-out slice the
    port runs it (``test_cli_compress_on_png_dir`` runs ``--n_devices 2
    --device cpu``); only a count above the visible devices raises, before
    any work, as the JAX package's ``make_mesh`` does."""
    jax_compress_cli.parse_args(_CLI_BASE + extra)
    args = compress_cli.parse_args(_CLI_BASE + extra)
    assert launch.requested_world(args.n_devices, "cpu") == 2, queue
    too_many = str(launch.visible_devices("cpu") + 1)
    with pytest.raises(ValueError, match=f"--n_devices {too_many} requested but only"):
        compress_cli.main(_CLI_BASE + ["--n_devices", too_many, "--device", "cpu"])


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """A TINY prior saved by the port and a directory of 16 x 16 PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("cli")
    _, art = _artifacts()
    checkpoint.save_prior_artifact(str(root / "prior.npz"), art)
    (root / "images").mkdir()
    for i, img in enumerate(_images(1, seed=7)):
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(root / "images" / f"{i}.png")
    return root


@pytest.mark.parametrize("extra", [
    ["--finetune_crn"],
    ["--state_path", "{root}/state.npz"],
    ["--p1_stop", "2", "1e-3", "2"],
    ["--ft_stop", "1", "1e-3", "1"],
    ["--p1_lr", "6e-4", "2e-5"],
    ["--p1_samples", "1"],
    ["--ft_lr", "4e-4"],
    ["--ft_lr_schedule", "cosine"],
    ["--schedule", "quality"],
    ["--remat"],
])
def test_cli_runs_each_value_this_slice_ports(extra, png_dir, tmp_path, setup):
    """Each flag value that the adaptive/quality/resume slice ports parses
    alike in both packages and runs (a few epochs
    on TINY); ``--ft_lr`` and ``--ft_lr_schedule`` without the fused path
    raise the JAX package's ValueError, as its ``compress`` does."""
    extra = [a.format(root=tmp_path) for a in extra]
    base = ["--test_dir", str(png_dir / "images"), "--test_idx", "0", "--prior_path",
            str(png_dir / "prior.npz"), "--save_dir", str(tmp_path / "out"), "--device", "cpu",
            "--n_epochs", "4", "--finetune_epochs", "2", "--sample_size", "2"]
    assert vars(jax_compress_cli.parse_args(base + extra)) == vars(
        compress_cli.parse_args(base + extra))
    if extra[0] in ("--ft_lr", "--ft_lr_schedule"):
        with pytest.raises(ValueError, match="require the fused coding path"):
            compress_cli.main(base + extra)
        jart, _, jcodec, jstate = setup[:4]
        with pytest.raises(ValueError, match="require the fused coding path"):
            jprog.compress(jcodec, jstate, None, None, jart.config, jax.random.key(0),
                           n_optimize_epochs=0, finetune_overrides={"w": 2},
                           finetune_lr=4e-4 if extra[0] == "--ft_lr" else None,
                           finetune_lr_schedule="cosine" if extra[1] == "cosine" else None)
        return
    res = compress_cli.main(base + extra)
    assert res.state.w.compressed.all()
    assert sorted(os.listdir(tmp_path / "out")) == [
        "Distortion_test_id_0.csv", "GroupIndex_test_id_0.csv", "bitstream_test_id_0.rctb"]
