"""The port's patch path (the three-level latent hierarchy, cross-patch row
permutations, the stitched conv canvas, remat) against the JAX package's,
on the CPU: TINY_PATCH from ``tests/fixtures/tiny_patch_prior.npz`` (two
32 x 32 images, 8 rows of 16 x 16 patches) and, for the init, the stitch
and decode, the committed kodak_mini prior.

Both packages load one prior file. Where an encode is compared, each
level's codebook is carried across (``convert.with_codebook``) and JAX's
noise is replayed: the test splits the keys as ``predict`` does (``k_lpe,
k_w``, then ``k1, k2, k3`` for w, h, hh) and hands the draws to the port as
numpy. Tolerances (each test says which it uses):

- ``_close``: rtol 1e-5, atol 1e-5 x the largest entry (f32 sums in another
  order: the conv stack, the SIREN chain at w0 = 30, the KL sums);
- permutations, metadata, indices, coded masks and betas: equal;
- codebooks: within 3 ulp (``tests/test_torch_codebook.py``);
- a decoded reconstruction: ``DECODE_TOL`` (atol 3e-5, rtol 1e-5);
- remat on against off, and a resumed encode against an uninterrupted one:
  bit for bit.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from recombiner_tpu import native as jax_native
from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.coding import progressive as jprog
from recombiner_tpu.config import get_config as jax_get_config
from recombiner_tpu.coords import patchify as jax_patchify
from recombiner_tpu.data import pipeline as jax_pipeline
from recombiner_tpu.io import bitstream as jax_bitstream
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.io import encode_state as jes
from recombiner_tpu.models import mappings as jmap
from recombiner_tpu.models.gaussian import Gaussian as JGaussian
from recombiner_tpu.utils import memory as jax_memory
from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.cli import decompress as decompress_cli
from recombiner_tpu_torch.coding import decoder, encoder, progressive
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.coords import patchify, unpatchify
from recombiner_tpu_torch.data import pipeline
from recombiner_tpu_torch.io import bitstream, checkpoint, convert, encode_state
from recombiner_tpu_torch.models import mappings
from recombiner_tpu_torch.utils import memory
from test_torch_codebook import MAX_ULP, _ulp
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encode import DECODE_TOL, _close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tiny_patch_prior.npz")
KODAK_MINI = os.path.join(ROOT, "docs", "schedule_priors", "PRIOR_rd_kodak_mini_bitrate=2.npz")
LEVELS = ("w", "h", "hh")
R, S = 8, 2  # two TINY_PATCH images of 2 x 2 patches
LR = 2e-3


def _images(n, hw, seed):
    """n smooth images (hw, 3) in [0.1, 0.9] from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(*(np.linspace(0, 1, s) for s in hw), indexing="ij")
    f = rng.uniform(0.5, 3.0, (n, 3, 2))
    ph = rng.uniform(0, 2 * np.pi, (n, 3))
    return (0.5 + 0.4 * np.sin(2 * np.pi * (f[..., 0, None, None] * xx + f[..., 1, None, None]
                                            * yy) + ph[..., None, None])
            ).transpose(0, 2, 3, 1).astype(np.float32)


def _copy(jstate):
    """A copy for a JAX function that donates its state argument."""
    return jax.tree_util.tree_map(jnp.copy, jstate)


def _perturbed(jcodec, jstate, seed=1):
    """Posteriors moved off the prior and random betas at every level; some
    groups coded: w row 0's first three and all of row 7, h row 1's first
    two, hh row 1's first four."""
    rng = np.random.default_rng(seed)
    coded = {"w": [(0, 3), (7, None)], "h": [(1, 2)], "hh": [(1, 4)]}
    out = {}
    for name in LEVELS:
        ls, meta = jstate.level(name), jcodec.meta(name)
        n, D, G = ls.q.loc.shape[0], meta.D, meta.n_groups
        compressed = np.zeros((n, G), bool)
        for row, upto in coded[name]:
            compressed[row, :upto] = True
        out[name] = ls.replace(
            q=JGaussian(ls.q.loc + rng.normal(0, 0.01, (n, D)).astype(np.float32),
                        ls.q.log_scale + rng.normal(0, 0.3, (n, D)).astype(np.float32)),
            kl_beta=jnp.asarray(rng.uniform(1e-4, 1e-2, (n, G)).astype(np.float32)),
            compressed=jnp.asarray(compressed))
    return jstate.replace(**out)


@pytest.fixture(scope="module")
def tiny():
    """Both packages' TINY_PATCH codecs (the port's with JAX's codebooks),
    one perturbed state, and the two images' points."""
    jart = jck.load_prior_artifact(FIXTURE)
    art = checkpoint.load_prior_artifact(FIXTURE)
    jcodec, jstate = jenc.init_codec(jart, R)
    codec, state = decoder.init_codec(art, R, device="cpu")
    carried = codec
    for name in LEVELS:
        carried = convert.with_codebook(carried, jcodec.meta(name), name)
    imgs = _images(2, (32, 32), seed=4)
    X, Y = pipeline.points_from_data(imgs, art.config)
    return types.SimpleNamespace(jart=jart, art=art, cfg=art.config, jcfg=jart.config,
                                 jcodec=jcodec, jstate0=jstate, codec=carried, own=codec,
                                 state0=state, jstate=_perturbed(jcodec, jstate), imgs=imgs,
                                 X=X, Y=Y)


@pytest.fixture(scope="module")
def kodak_mini():
    """Both packages' kodak_mini codecs for one image (4 patch rows)."""
    jart = jck.load_prior_artifact(KODAK_MINI)
    art = checkpoint.load_prior_artifact(KODAK_MINI)
    return types.SimpleNamespace(jart=jart, art=art, jcodec=jenc.init_codec(jart, 4)[0],
                                 codec=decoder.init_codec(art, 4, device="cpu")[0])


def _noise(key, codec, rows, cfg, S=S):
    """The noise JAX's ``predict`` draws from ``key`` (encoder.py:304,
    models/mappings.py:147): LPE, w, h, hh, as numpy."""
    k_lpe, k_w = jax.random.split(key)
    k1, k2, k3 = jax.random.split(k_w, 3)
    shapes = [(k_lpe, (rows, S, *cfg.lpe_spatial, cfg.latent_dim)),
              (k1, (rows, S, cfg.n_inr_params)),
              (k2, (cfg.rows_level2(rows), S, codec.h.D)),
              (k3, (cfg.rows_level3(rows), S, codec.hh.D))]
    return [np.array(jax.random.normal(k, s)) for k, s in shapes]


def _port_state(jstate):
    return convert.codec_state_from(jstate, "cpu")


# ------------------------------------------------------------ metadata


@pytest.mark.parametrize("n_rows,n_cols", [(8, 491), (96, 300), (1, 5)])
def test_patch_permutations_equal_the_jax_packages(n_rows, n_cols):
    """Bit-equal to ``native.patch_permutations`` (the g++ helper) and to the
    JAX package's RandomState fallback; each column a permutation, ``inv``
    its inverse."""
    perm, inv = decoder.patch_permutations(n_rows, n_cols)
    want = jax_native.patch_permutations(n_rows, n_cols)
    assert want is not None, "the JAX package's native helper did not build"
    np.testing.assert_array_equal(perm, want[0])
    np.testing.assert_array_equal(inv, want[1])
    for c in range(n_cols):
        order = np.random.RandomState(c).choice(n_rows, n_rows, False)
        np.testing.assert_array_equal(perm[:, c], order)
    rows = np.arange(n_rows)
    assert (np.sort(perm, axis=0) == rows[:, None]).all()
    np.testing.assert_array_equal(np.take_along_axis(inv, perm, 0), np.broadcast_to(
        rows[:, None], perm.shape))


def test_jax_fallback_permutations_build_the_same_level_meta(tiny, monkeypatch):
    """With the JAX package's native helper off, its ``_make_level_meta``
    takes the RandomState fallback: perm_g2p and beta_row equal the port's."""
    monkeypatch.setattr(jax_native, "patch_permutations", lambda *a: None)
    for name in ("w", "h"):
        rows = {"w": R, "h": tiny.cfg.rows_level2(R)}[name]
        jmeta = jenc._make_level_meta(getattr(tiny.jart, name), name, rows, True, 42, 42, 8,
                                      "threefry")
        meta = tiny.codec.meta(name)
        np.testing.assert_array_equal(meta.perm_g2p.numpy(), np.asarray(jmeta.perm_g2p))
        np.testing.assert_array_equal(meta.beta_row.numpy(), np.asarray(jmeta.beta_row))


def _assert_meta_equal(codec, jcodec):
    for name in LEVELS:
        meta, jmeta = codec.meta(name), jcodec.meta(name)
        for f in ("D", "Dpad", "Gmax", "n_groups"):
            assert getattr(meta, f) == getattr(jmeta, f), (name, f)
        for f in ("pp_loc", "pp_scale", "p_loc", "p_scale", "group_start", "group_size",
                  "group_idx", "param2group", "group2param", "group_of_col", "gumbel"):
            np.testing.assert_array_equal(getattr(meta, f).numpy(), np.asarray(getattr(jmeta, f)),
                                          err_msg=f"{name}.{f}")
        for f in ("perm_g2p", "beta_row"):
            if getattr(jmeta, f) is None:
                assert getattr(meta, f) is None, (name, f)
            else:
                np.testing.assert_array_equal(getattr(meta, f).numpy(),
                                              np.asarray(getattr(jmeta, f)), err_msg=name)
        assert _ulp(meta.eps.numpy(), np.asarray(jmeta.eps)).max() <= MAX_ULP, name
    assert codec.level_names == jcodec.level_names == LEVELS
    assert codec.hh.perm_g2p is None and codec.w.perm_g2p is not None


def test_init_codec_builds_the_jax_packages_levels_on_the_fixture(tiny):
    """Every level's metadata equal (perm_g2p and beta_row on w and h, none
    on hh), each level's own codebook within 3 ulp; the fresh state's rows
    per level and its values equal."""
    _assert_meta_equal(tiny.own, tiny.jcodec)
    for name in LEVELS:
        ls, jls = tiny.state0.level(name), tiny.jstate0.level(name)
        for f, a in convert.level_arrays(ls).items():
            want = getattr(jls.q, f) if f in ("loc", "log_scale") else getattr(jls, f)
            np.testing.assert_array_equal(a, np.asarray(want), err_msg=f"{name}.{f}")
    assert [tiny.state0.level(n).q.loc.shape[0] for n in LEVELS] == [8, 4, 2]


def test_init_codec_builds_the_jax_packages_levels_on_kodak_mini(kodak_mini):
    _assert_meta_equal(kodak_mini.codec, kodak_mini.jcodec)
    assert [kodak_mini.codec.meta(n).D for n in LEVELS] == [3779, 3267, 3267]
    assert [kodak_mini.codec.meta(n).n_groups for n in LEVELS] == [99, 25, 58]


# ------------------------------------------------------ data and mappings


def test_patchify_round_trips_and_the_pipeline_matches_jax(tiny):
    rng = np.random.default_rng(0)
    for shape, ps in (((32, 48, 3), (16, 16)), ((512, 768, 3), (64, 64)), ((40, 70, 2), (16, 16))):
        datum = rng.uniform(0, 1, shape).astype(np.float32)
        got = patchify(datum, ps)
        np.testing.assert_array_equal(got, jax_patchify(datum, ps))
        nums = [shape[i] // ps[i] for i in range(2)]
        np.testing.assert_array_equal(unpatchify(got, nums),
                                      datum[:nums[0] * ps[0], :nums[1] * ps[1]])
    jX, jY = jax_pipeline.points_from_data(tiny.imgs, tiny.jcfg)
    np.testing.assert_array_equal(tiny.X, jX)
    np.testing.assert_array_equal(tiny.Y, jY)
    assert tiny.X.shape == (R, 256, 16) and tiny.Y.shape == (R, 256, 3)


def _jax_up(art):
    return jax.tree_util.tree_map(jnp.asarray, art.up)


@pytest.mark.parametrize("prior,rows", [("tiny", R), ("kodak_mini", 8)])
def test_lpe_to_pe_stitches_as_jax_does(prior, rows, request):
    """The stitched canvas, upsampled and split again, against JAX
    (``_close``), with the prior's conv weights."""
    art = checkpoint.load_prior_artifact(FIXTURE if prior == "tiny" else KODAK_MINI)
    cfg = art.config
    up = convert.torch_params_from_artifact(art, "cpu")[1]
    lpe = np.random.default_rng(1).normal(0, 1, (rows, S, *cfg.lpe_spatial, cfg.latent_dim))
    lpe = lpe.astype(np.float32)
    want = jmap.lpe_to_pe(_jax_up(art), jnp.asarray(lpe), jax_get_config(cfg.name))
    got = mappings.lpe_to_pe(up, torch.from_numpy(lpe), cfg)
    assert got.shape == (rows, S, cfg.n_pixels, cfg.upsample_out)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["tiny_patch", "kodak_mini", "kodak"])
def test_expand_level_matches_jax(name):
    cfg = get_config(name)
    rng = np.random.default_rng(2)
    for lv in (cfg.level2_patch_nums, cfg.level3_patch_nums):
        n = 2 * cfg.patches_per_datapoint // int(np.prod(lv))
        x = rng.normal(0, 1, (n, 3, 5)).astype(np.float32)
        want = jmap.expand_level(jnp.asarray(x), cfg.patch_nums, lv)
        got = mappings.expand_level(torch.from_numpy(x), cfg.patch_nums, lv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_hierarchical_latents_matches_jax_with_replayed_noise(tiny):
    """Three levels summed with JAX's k1, k2, k3 draws (``_close``); the
    gradient of a sum through ``expand_level`` is the ordered sum over each
    group's patches."""
    cfg, st = tiny.cfg, _port_state(tiny.jstate)
    n = cfg.n_inr_params
    key = jax.random.key(5)
    eps = _noise(jax.random.fold_in(key, 0), tiny.codec, R, cfg)
    k_w = jax.random.split(jax.random.fold_in(key, 0))[1]
    lv = {name: (st.level(name).q.loc[:, :n], torch.exp(st.level(name).q.log_scale[:, :n]))
          for name in LEVELS}
    want = jmap.sample_hierarchical_latents(
        k_w, *(jnp.asarray(t.numpy()) for name in LEVELS for t in lv[name]), S, tiny.jcfg)
    h_loc = lv["h"][0].clone().requires_grad_()
    got = mappings.sample_hierarchical_latents(
        *lv["w"], torch.from_numpy(eps[1]), cfg, h=(h_loc, lv["h"][1], torch.from_numpy(eps[2])),
        hh=(*lv["hh"], torch.from_numpy(eps[3])))
    _close(got.detach().numpy(), want)
    (g,) = torch.autograd.grad(got.sum(), h_loc)
    torch.testing.assert_close(g, torch.full_like(g, 2.0 * S), rtol=0, atol=0)


# ------------------------------------------------------------- decode


def test_kodak_mini_decode_matches_jax(kodak_mini):
    """Random indices for all three levels of one kodak_mini image: both
    packages' decodes, each with its own codebooks, within DECODE_TOL."""
    rng = np.random.default_rng(3)
    idx = {n: rng.integers(0, 2**16, (r, kodak_mini.codec.meta(n).n_groups)).astype(np.int32)
           for n, r in zip(LEVELS, (4, 2, 1))}
    cfg = kodak_mini.art.config
    X = pipeline.points_from_datum(np.zeros((64, 64, 3), np.float32), cfg)[0]
    want = np.asarray(jenc.decode(kodak_mini.jcodec, idx, jnp.asarray(X), kodak_mini.jart.config))
    got = decoder.decode(kodak_mini.codec, idx, X, cfg).numpy()
    assert got.shape == (4, 1024, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **DECODE_TOL)
    for name in LEVELS:
        bad = dict(idx)
        bad[name] = np.full_like(idx[name], 2**16)
        with pytest.raises(ValueError, match=f"level {name}"):
            decoder.decode(kodak_mini.codec, bad, X, cfg)


# -------------------------------------------------------------- encode


def test_one_elbo_epoch_matches_jax(tiny):
    """Loss, its scaled-mse term and the gradient of every level's
    posteriors against ``jax.value_and_grad`` of ``_elbo_loss_fn`` with
    JAX's noise replayed (``_close``); the KL of every level counts."""
    key = jax.random.key(3)
    loss_fn = jenc._elbo_loss_fn(tiny.jcodec, jnp.asarray(tiny.X), jnp.asarray(tiny.Y),
                                 tiny.jcfg, S, None, False, with_aux=True)
    (jloss, jmse), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jenc._trainables(tiny.jstate), tiny.jstate, key)
    st = _port_state(tiny.jstate)
    params = [t.requires_grad_() for name in encoder.trainable_levels(tiny.codec)
              for t in (st.level(name).q.loc, st.level(name).q.log_scale)]
    loss, mse = encoder.elbo_loss(tiny.codec, st, torch.from_numpy(tiny.X),
                                  torch.from_numpy(tiny.Y), tiny.cfg, S,
                                  noise=_noise(key, tiny.codec, R, tiny.cfg))
    grads = torch.autograd.grad(loss, params)
    _close(loss.item(), jloss, "loss")
    _close(mse.item(), jmse, "mse")
    assert encoder.trainable_levels(tiny.codec) == ("h", "hh", "w")
    for k, name in enumerate(("h", "hh", "w")):
        _close(grads[2 * k].numpy(), jgrads[name].loc, f"d {name}.loc")
        _close(grads[2 * k + 1].numpy(), jgrads[name].log_scale, f"d {name}.log_scale")
        assert grads[2 * k].abs().max() > 0, name
    assert loss.item() > mse.item()  # the KLs


def test_kl_and_annealing_match_jax_at_every_level(tiny):
    """group_kl through perm_g2p, beta_weighted_kl through beta_row (no
    gradient into beta), update_betas: ``_close``, the betas equal."""
    st = _port_state(tiny.jstate)
    for name in LEVELS:
        ls, jls, meta, jmeta = st.level(name), tiny.jstate.level(name), tiny.codec.meta(name), \
            tiny.jcodec.meta(name)
        _close(encoder.group_kl(ls, meta).numpy(), jenc.group_kl(jls, jmeta), name)
        ls.kl_beta.requires_grad_()
        bwk = encoder.beta_weighted_kl(ls, meta)
        assert not bwk.requires_grad, "no gradient may flow into beta"
        _close(bwk.item(), jenc.beta_weighted_kl(jls, jmeta), name)
        ls.kl_beta.requires_grad_(False)
        got = encoder.update_betas(ls, meta, 3.0).kl_beta.numpy()
        np.testing.assert_array_equal(got, np.asarray(jenc.update_betas(jls, jmeta, 3.0).kl_beta))


@pytest.mark.parametrize("level", LEVELS)
def test_encode_step_level_matches_jax(tiny, level):
    """One step at each level from one state and codebook: indices, coded
    groups, betas and frozen masks equal, frozen values ``_close``; twice
    from there alike. The cells written are distinct: one per valid lane of
    each coded row that still had groups to code."""
    meta, jmeta = tiny.codec.meta(level), tiny.jcodec.meta(level)
    ls = _port_state(tiny.jstate).level(level)
    jls = tiny.jstate.level(level)
    for _ in range(2):
        want = jenc.encode_step_level(jls, jmeta)
        got = encoder.encode_step_level(ls, meta)
        for f in ("indices", "compressed", "kl_beta", "frozen_mask"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)
        _close(got.frozen_val.numpy(), want.frozen_val)
        new = got.compressed & ~ls.compressed
        assert int((got.frozen_mask - ls.frozen_mask).sum()) == int(
            (new.long() * meta.group_size[None, :]).sum())
        ls, jls = got, want


class CrnReplay:
    """The port's per-finetune noise replaying JAX's CRN finetunes: every
    finetune splits the one CRN key as ``optimize_chunked`` does (``_, sub =
    split(crn_key)``, then ``split(sub, n_ft)``)."""

    def __init__(self, crn_key, n_ft, codec, cfg):
        self.crn_key, self.n_ft, self.codec, self.cfg = crn_key, n_ft, codec, cfg

    def __call__(self):
        keys = iter(jax.random.split(jax.random.split(self.crn_key)[1], self.n_ft))
        return lambda: _noise(next(keys), self.codec, R, self.cfg)


def test_encode_chunk_at_level_h_matches_jax(tiny):
    """Three group steps at level h, each with a 3-epoch CRN finetune of every
    level: equal indices and coded masks at every level, the coded samples
    and every level's posteriors ``_close``."""
    crn_key = jax.random.key(8)
    kw = dict(n_steps=3, n_ft=3, lr=LR, sample_size=S)
    jst, _, jran = jenc.encode_chunk(tiny.jcodec, _copy(tiny.jstate), jnp.asarray(tiny.X),
                                     jnp.asarray(tiny.Y), jax.random.key(7), crn_key, 0, 0.0,
                                     cfg=tiny.jcfg, level="h", crn=True, **kw)
    st, ran = encoder.encode_chunk(tiny.codec, _port_state(tiny.jstate), torch.from_numpy(tiny.X),
                                   torch.from_numpy(tiny.Y), tiny.cfg,
                                   CrnReplay(crn_key, 3, tiny.codec, tiny.cfg), level="h", **kw)
    np.testing.assert_array_equal(ran, np.asarray(jran))
    for name in LEVELS:
        ls, jls = st.level(name), jst.level(name)
        np.testing.assert_array_equal(ls.indices.numpy(), np.asarray(jls.indices), name)
        np.testing.assert_array_equal(ls.compressed.numpy(), np.asarray(jls.compressed), name)
        _close(ls.frozen_val.numpy(), jls.frozen_val, f"{name} frozen values")
        _close(ls.q.loc.numpy(), jls.q.loc, f"{name} loc")
        _close(ls.q.log_scale.numpy(), jls.q.log_scale, f"{name} log_scale")
    coded = st.h.compressed.sum() - _port_state(tiny.jstate).h.compressed.sum()
    assert coded == 3 * st.h.compressed.shape[0]


def test_compress_codes_what_jax_codes(tiny, monkeypatch):
    """A whole TINY_PATCH encode on the reference schedule (its lr 2e-4, 20
    phase-1 epochs, 2-epoch CRN finetunes; levels hh, h, w), JAX's noise
    replayed through phase 1 and every finetune: every level's indices equal
    the JAX package's, so the two bitstreams are the same; the
    reconstructions within DECODE_TOL.

    At the reference lr the encode is stable: a relative perturbation of
    1e-7 of the posteriors after phase 1 stays below 2e-7 through all 31
    group steps. At lr 2e-3 it is not (the fresh Adam of each finetune
    steps a full lr along the sign of gradients that are rounding noise):
    the same perturbation changes 43 of the port's own 96 w indices, so no
    two f32 implementations can agree index for index there."""
    budgets = dict(n_optimize_epochs=20, sample_size=S,
                   finetune_overrides={"w": 2, "h": 2, "hh": 2})
    key = jax.random.key(11)
    jres = jprog.compress(tiny.jcodec, _copy(tiny.jstate0), jnp.asarray(tiny.X),
                          jnp.asarray(tiny.Y), tiny.jcfg, key, **budgets)
    # optimize_chunked: one (key, sub) split for the single chunk, the
    # epochs pre-split from sub; CRN folded into the key after it
    key, sub = jax.random.split(key)
    phase1 = iter(jax.random.split(sub, 20))
    crn = CrnReplay(jax.random.fold_in(key, 0x0C12), 2, tiny.codec, tiny.cfg)
    monkeypatch.setattr(progressive, "finetune_noise", lambda gen, on: crn if on else None)
    res = progressive.compress(tiny.codec, tiny.state0, tiny.X, tiny.Y, tiny.cfg,
                               lambda: _noise(next(phase1), tiny.codec, R, tiny.cfg), **budgets)
    for name in LEVELS:
        np.testing.assert_array_equal(res.indices[name], np.asarray(jres.indices[name]), name)
        assert res.state.level(name).compressed.all(), name
    assert res.bitrate == jres.bitrate
    assert res.timings["finetune_epochs"] == 2 * sum(tiny.codec.meta(n).n_groups for n in LEVELS)
    np.testing.assert_allclose(res.reconstruction, jres.reconstruction, **DECODE_TOL)


def test_compress_defaults_to_crn_finetunes_for_patch_configs(tiny, monkeypatch):
    seen = []
    real = progressive.finetune_noise
    monkeypatch.setattr(progressive, "finetune_noise",
                        lambda gen, crn: seen.append(crn) or real(gen, crn))
    progressive.compress(tiny.codec, tiny.state0, tiny.X, tiny.Y, tiny.cfg,
                         torch.Generator().manual_seed(0), n_optimize_epochs=1, sample_size=1,
                         finetune_overrides={"w": 0, "h": 0, "hh": 0})
    assert seen == [True]


# ---------------------------------------------------------------- remat


@pytest.mark.parametrize("adaptive", [False, True])
def test_remat_changes_no_number(tiny, adaptive):
    """Six epochs from one state and one generator state with remat on and
    off: loss and posteriors bitwise equal; one ELBO gradient bitwise
    equal."""
    X, Y = torch.from_numpy(tiny.X), torch.from_numpy(tiny.Y)
    st = _port_state(tiny.jstate)

    def run(remat):
        gen = torch.Generator().manual_seed(4)
        if adaptive:
            return encoder.optimize_adaptive(tiny.codec, st, X, Y, tiny.cfg, gen, 0, 6, 0, 0.0,
                                             (np.inf, 0.0), lr=LR, sample_size=S, window=3,
                                             remat=remat)[0]
        return encoder.optimize(tiny.codec, st, X, Y, tiny.cfg, gen, n_epochs=6, lr=LR,
                                sample_size=S, remat=remat)

    on, off = run(True), run(False)
    for name in LEVELS:
        for f in ("loc", "log_scale"):
            assert torch.equal(getattr(on.level(name).q, f), getattr(off.level(name).q, f))
        assert torch.equal(on.level(name).kl_beta, off.level(name).kl_beta)
    grads = {}
    for remat in (True, False):
        params = [t.detach().clone().requires_grad_() for name in ("h", "hh", "w")
                  for t in (st.level(name).q.loc, st.level(name).q.log_scale)]
        s = encoder._with_posteriors(st, ("h", "hh", "w"), params)
        loss, _ = encoder.elbo_loss(tiny.codec, s, X, Y, tiny.cfg, S,
                                    generator=torch.Generator().manual_seed(9), remat=remat)
        grads[remat] = (loss.detach(), torch.autograd.grad(loss, params))
    assert torch.equal(grads[True][0], grads[False][0])
    for a, b in zip(grads[True][1], grads[False][1]):
        assert torch.equal(a, b)


def test_compress_with_remat_equals_it_without(tiny):
    res = [progressive.compress(tiny.codec, tiny.state0, tiny.X, tiny.Y, tiny.cfg,
                                torch.Generator().manual_seed(2), n_optimize_epochs=4, lr=LR,
                                sample_size=S, finetune_overrides={"w": 1, "h": 1, "hh": 1},
                                remat=remat) for remat in (True, False)]
    for name in LEVELS:
        np.testing.assert_array_equal(res[0].indices[name], res[1].indices[name])
        assert torch.equal(res[0].state.level(name).q.loc, res[1].state.level(name).q.loc)


@pytest.mark.parametrize("name", ["cifar", "kodak", "kodak_mini", "tiny_patch", "audio",
                                  "video", "protein"])
def test_resolve_remat_matches_jax(name, capsys):
    """The estimate, the auto choice and the messages equal the JAX
    package's over rows, samples, devices and the three flag values."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    for rows in (1, 96, 384, 2000):
        for s in (1, 5):
            for devices in (1, 4):
                assert memory.stored_activation_gb(cfg, rows, s, devices) == \
                    jax_memory.stored_activation_gb(jcfg, rows, s, devices)
                for flag in (None, True, False):
                    got = memory.resolve_remat(flag, cfg, rows, s, devices)
                    got_out = capsys.readouterr().out
                    want = jax_memory.resolve_remat(flag, jcfg, rows, s, devices)
                    want_out = capsys.readouterr().out
                    assert got == want, (rows, s, devices, flag)
                    assert bool(got_out) == bool(want_out)
                    assert got_out.split(" ")[0] == want_out.split(" ")[0]


# ---------------------------------------------------- bitstreams and snapshots


def test_patch_bitstreams_decode_across_packages(tiny, tmp_path):
    """Indices for all three levels written by either package read back
    equal by the other (byte-equal files); both decodes within DECODE_TOL."""
    rng = np.random.default_rng(6)
    idx = {n: rng.integers(0, 256, (r, tiny.codec.meta(n).n_groups)).astype(np.int32)
           for n, r in zip(LEVELS, (R, 4, 2))}
    kw = dict(config_name="tiny_patch", codebook_seed=42, bits_per_group=8)
    pj, pt = str(tmp_path / "j.rctb"), str(tmp_path / "t.rctb")
    jax_bitstream.write_bitstream(pj, idx, **kw)
    bitstream.write_bitstream(pt, idx, **kw)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    (_, from_jax), (_, from_port) = bitstream.read_bitstream(pj), jax_bitstream.read_bitstream(pt)
    for name in LEVELS:
        np.testing.assert_array_equal(from_jax[name], idx[name])
        np.testing.assert_array_equal(from_port[name], idx[name])
    got = decoder.decode(tiny.own, from_jax, tiny.X, tiny.cfg).numpy()
    want = np.asarray(jenc.decode(tiny.jcodec, from_port, jnp.asarray(tiny.X), tiny.jcfg))
    np.testing.assert_allclose(got, want, **DECODE_TOL)


def _jax_opt(jstate, scheduled):
    sched = ("cosine", 6e-4, 2e-5, 100) if scheduled else None
    opt = jenc._make_opt(2e-4, sched)
    qs = jenc._trainables(jstate)
    o = opt.init(qs)
    for s in (1.0, -0.5):
        _, o = opt.update(jax.tree_util.tree_map(lambda a: s * jnp.ones_like(a), qs), o)
    return opt, qs, o


@pytest.mark.parametrize("scheduled", [False, True])
def test_patch_snapshots_load_in_both_packages(tiny, tmp_path, scheduled):
    """A JAX snapshot of a three-level state with its Adam leaves loads in
    the port: every level's arrays equal, and ``AdamState`` reads the leaves
    in optax's order (h, hh, w; loc before log_scale; mu, then nu), which
    its ``leaves`` writes back unchanged. The port's snapshot of the same
    loads in the JAX package and its leaves unflatten into optax's tree."""
    opt, qs, o = _jax_opt(tiny.jstate, scheduled)
    leaves = jax.tree_util.tree_leaves(o)
    assert len(leaves) == 1 + 12 + int(scheduled)
    path = str(tmp_path / "jax_snap")
    jes.save_encode_state(path, tiny.jstate, extra={"phase1_epochs_done": 5}, opt_leaves=leaves)
    state, header, opt_leaves = encode_state.load_encode_state_full(path + ".npz", device="cpu")
    assert header["levels"] == list(LEVELS)
    want = _port_state(tiny.jstate)
    for name in LEVELS:
        for f, a in convert.level_arrays(state.level(name)).items():
            np.testing.assert_array_equal(a, convert.level_arrays(want.level(name))[f], f)
    adam = encoder.AdamState.from_leaves(opt_leaves, scheduled, "cpu", n_levels=3)
    order = [(m, name, f) for m in ("mu", "nu") for name in ("h", "hh", "w")
             for f in ("loc", "log_scale")]
    for t, (m, name, f) in zip(adam.mu + adam.nu, order):
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(getattr(o[0], m)[name], f)))
    for a, b in zip(adam.leaves(scheduled), leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError):
        encoder.AdamState.from_leaves(opt_leaves, scheduled, "cpu", n_levels=1)

    back = str(tmp_path / "port_snap.npz")
    encode_state.save_encode_state(back, state, extra={"phase1_epochs_done": 5},
                                   opt_leaves=adam.leaves(scheduled))
    jst, jheader, jleaves = jes.load_encode_state_full(back)
    for name in LEVELS:
        for f in ("frozen_mask", "frozen_val", "kl_beta", "compressed", "indices"):
            a, b = np.asarray(getattr(jst.level(name), f)), np.asarray(
                getattr(tiny.jstate.level(name), f))
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, (name, f)
        np.testing.assert_array_equal(np.asarray(jst.level(name).q.loc),
                                      np.asarray(tiny.jstate.level(name).q.loc))
    restored = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(opt.init(qs)), jleaves)
    for a, b in zip(jax.tree_util.tree_leaves(restored), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    opt.update(qs, restored)


# ------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """The TINY_PATCH prior and a directory of two 32 x 32 PNGs."""
    root = tmp_path_factory.mktemp("patch_cli")
    (root / "images").mkdir()
    for i, img in enumerate(_images(2, (32, 32), seed=7)):
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(root / "images" / f"{i}.png")
    return root


def _argv(root, out, *extra):
    return ["--test_dir", str(root / "images"), "--test_idx", "1", "--prior_path", FIXTURE,
            "--save_dir", str(out), "--device", "cpu", "--sample_size", "2", "--seed", "3",
            "--n_epochs", "6", "--finetune_epochs", "1", *extra]


def test_cli_encodes_a_patch_image_that_both_packages_decode(png_dir, tmp_path):
    """The compress CLI on one TINY_PATCH image (4 patch rows; CRN on by
    default): the GroupIndex files of all three levels, a bitstream that
    the JAX package decodes within DECODE_TOL of the reconstruction and the
    decompress CLI to it exactly, as (rows, P, out)."""
    out = tmp_path / "out"
    res = compress_cli.main(_argv(png_dir, out))
    assert sorted(os.listdir(out)) == [
        "Distortion_test_id_1.csv", "GroupIndex_test_id_1.csv", "HH_GroupIndex_test_id_1.csv",
        "H_GroupIndex_test_id_1.csv", "bitstream_test_id_1.rctb"]
    for prefix, name in (("", "w"), ("H_", "h"), ("HH_", "hh")):
        np.testing.assert_array_equal(
            np.loadtxt(out / f"{prefix}GroupIndex_test_id_1.csv", delimiter=",", ndmin=2),
            res.indices[name])
    path = str(out / "bitstream_test_id_1.rctb")
    header, idx = jax_bitstream.read_bitstream(path)
    assert header["config"] == "tiny_patch" and idx["hh"].shape == (1, 10)
    jart = jck.load_prior_artifact(FIXTURE)
    X = np.asarray(jax_pipeline.points_from_data(_images(1, (32, 32), 0), jart.config)[0])
    want = np.asarray(jenc.decode(jenc.init_codec(jart, 4)[0], idx, jnp.asarray(X),
                                  jart.config))
    np.testing.assert_allclose(want, res.reconstruction, **DECODE_TOL)
    y = decompress_cli.main(["--bitstream", path, "--prior_path", FIXTURE, "--save_dir",
                             str(out), "--device", "cpu"])
    assert y.shape == (4, 256, 3)
    np.testing.assert_array_equal(y, res.reconstruction)


class Crash(RuntimeError):
    pass


def test_cli_resume_after_a_crash_at_level_h(png_dir, tmp_path, monkeypatch):
    """The CLI with --state_path (a snapshot every 2 groups), crashed after
    the first snapshot of level h, then run again: every level's indices
    and posteriors equal the uninterrupted run's bit for bit; with --remat
    the uninterrupted run gives the same numbers."""
    want = compress_cli.main(_argv(png_dir, tmp_path / "a"))
    remat = compress_cli.main(_argv(png_dir, tmp_path / "r", "--remat"))
    for name in LEVELS:
        np.testing.assert_array_equal(remat.indices[name], want.indices[name], name)
    extra = ["--state_path", str(tmp_path / "state.npz"), "--save_every", "2"]
    save = encode_state.save_encode_state

    def crash_at_h(path, state, **kw):
        save(path, state, **kw)
        if kw["extra"].get("level") == "h":
            raise Crash("h")

    monkeypatch.setattr(encode_state, "save_encode_state", crash_at_h)
    with pytest.raises(Crash):
        compress_cli.main(_argv(png_dir, tmp_path / "b", *extra))
    monkeypatch.setattr(encode_state, "save_encode_state", save)
    snap, header, _ = encode_state.load_encode_state_full(str(tmp_path / "state.npz"),
                                                          device="cpu")
    assert header["level"] == "h" and header["step"] == 1
    assert snap.hh.compressed.all() and int(snap.h.compressed.sum(1).max()) == 2
    assert not snap.w.compressed.any()
    got = compress_cli.main(_argv(png_dir, tmp_path / "b", *extra))
    for name in LEVELS:
        np.testing.assert_array_equal(got.indices[name], want.indices[name], name)
        for f in ("loc", "log_scale"):
            assert torch.equal(getattr(got.state.level(name).q, f),
                               getattr(want.state.level(name).q, f)), (name, f)
    np.testing.assert_array_equal(got.reconstruction, want.reconstruction)
