"""The port's audio, video and protein paths (1-D and 3-D conv stacks, the
1-D and 3-D patch hierarchies, protein's one level) against the JAX
package's, on the CPU.

The conv stacks, the LPE mapping, the committed audio_mini, video and
protein artifacts and decodes from them; the encodes, bitstreams and
snapshots are in ``test_torch_modalities_encode.py``, on priors drawn by
``_random_prior``. Tolerances (each test says which it uses):

- the conv stacks: ``TOL`` (atol 1e-5, rtol 1e-5, those of
  ``test_torch_upsample.py``); their gradients, which sum over the whole
  canvas, against an f64 evaluation at rtol 1e-5 and atol 1e-5 x the
  largest entry, or, where the JAX package's own f32 gradient misses that,
  no further from it than twice the JAX package's;
- the LPE mapping: rtol 1e-5, atol 1e-5 x the largest entry (``_close``);
- a decoded reconstruction: ``DECODE_TOL`` (atol 3e-5, rtol 1e-5), each
  package with its own codebooks (within 3 ulp of each other,
  ``tests/test_torch_codebook.py``);
- artifacts: equal.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.config import get_config as jax_get_config
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.models import mappings as jmap
from recombiner_tpu.models.upsample import apply_upsample as jax_apply_upsample
from recombiner_tpu.models.upsample import init_upsample_params
from recombiner_tpu.ops.phase_upsample import apply_upsample_phased as jax_apply_upsample_phased
from recombiner_tpu.ops.phase_upsample import phase_kernel_matrix as jax_phase_kernel_matrix
from recombiner_tpu.priors.grouping import compute_grouping as jax_compute_grouping
from recombiner_tpu_torch.coding import decoder
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.data import pipeline
from recombiner_tpu_torch.data.synthetic import protein_backbone
from recombiner_tpu_torch.io import checkpoint, convert
from recombiner_tpu_torch.models import mappings
from recombiner_tpu_torch.models.upsample import (
    apply_upsample,
    apply_upsample_phased,
    phase_kernel_matrix,
)
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encode import DECODE_TOL, _close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
PRIORS = {
    "audio_mini": os.path.join(DOCS, "schedule_priors", "PRIOR_rd_audio_mini_bitrate=2.npz"),
    "video": os.path.join(DOCS, "video_priors", "PRIOR_rd_video_bitrate=0.1.npz"),
    "protein": os.path.join(DOCS, "protein_state", "PRIOR_rd_protein_bitrate=8.npz"),
}
PROTEIN_STATE = os.path.join(DOCS, "protein_state", "encode_state_protein_8.npz")
LEVELS = ("w", "h", "hh")
TOL = dict(atol=1e-5, rtol=1e-5)
S = 2


def _random_prior(path: str, name: str, seed: int, kl_mean: float = 0.5, jcfg=None) -> str:
    """A prior of ``name``'s shapes (under the config ``jcfg`` if given) with
    random values from ``seed``, the magnitudes of
    ``chip_smoke.make_artifact`` and per-parameter KLs of ``kl_mean`` bits
    on average, written by the JAX package's artifact writer."""
    jcfg = jcfg or jax_get_config(name)
    rng = np.random.default_rng(seed)

    def level(D):
        return jck.LevelArtifact(
            p_loc=rng.normal(0.0, 0.01, D).astype(np.float32),
            p_scale=np.exp(rng.uniform(np.log(0.0025), np.log(0.05), D)).astype(np.float32),
            avg_log_scale=(-4.0 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            grouping=jax_compute_grouping(rng.exponential(kl_mean, D),
                                          max_bits=jcfg.bits_per_group))

    w = level(jcfg.n_coded_params)
    h, hh = (level(jcfg.n_inr_params), level(jcfg.n_inr_params)) if jcfg.patch else (None, None)
    A = [rng.uniform(-0.1, 0.1, (d, d)).astype(np.float32) for d in jcfg.layer_param_counts]
    up = jax.tree_util.tree_map(np.asarray, init_upsample_params(
        jax.random.key(seed), jcfg.data_dim, jcfg.latent_dim, jcfg.upsample_hidden,
        jcfg.upsample_out))
    jck.save_prior_artifact(path, jck.PriorArtifact(config=jcfg, kl_beta=1e-4, w=w, h=h, hh=hh,
                                                    A=A, up=up, codebook_seed=seed))
    return path


# ---------------------------------------------------------- conv stacks

# (layerwise scale factors, canvas (N, *spatial)): audio's stitched canvas
# of 60 patches of 50, video's anisotropic first factor on a 1 x 2 x 2
# canvas, TINY_VIDEO's
GEOMETRIES = {
    "audio": (1, (4, 2, 2), (2, 3000)),
    "video": (3, ((6, 4, 4), 2, 2), (1, 1, 2, 2)),
    "tiny_video": (3, ((1, 2, 2), 2, 2), (2, 1, 2, 2)),
}


def _stack_grads(stack, up, x, args, r, dtype):
    """The stack's output and the gradients of <out, r> with respect to the
    input and every conv weight and bias, in ``dtype``."""
    up = {k: {n: t.to(dtype).requires_grad_() for n, t in v.items()} for k, v in up.items()}
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    out = stack(up, xt, *args)
    leaves = [up[f"conv{i}"][n] for i in range(3) for n in ("w", "b")]
    grads = torch.autograd.grad((out * torch.from_numpy(r).to(dtype)).sum(), [xt, *leaves])
    return out.detach(), [g.double().numpy() for g in grads]


@pytest.mark.parametrize("stack", [apply_upsample, apply_upsample_phased])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_conv_stack_and_its_gradients_match_both_jax_stacks(geometry, stack):
    """The output against the JAX package's plain stack and its phase
    rewrite (``TOL``). The gradients of <out, r> with respect to the input
    and every weight and bias against an f64 evaluation of the same stack,
    at rtol 1e-5 and atol 1e-5 of the largest entry where the matching JAX
    stack's f32 gradient is that close, else no further from it than twice
    the JAX stack's. (At video's (6, 4, 4) factor the plain stack's input
    gradient is 2e-3 of its largest entry off in f32 in both packages; the
    phase stack's is within 1e-6.)"""
    d, factors, canvas = GEOMETRIES[geometry]
    jp = init_upsample_params(jax.random.key(1), d)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    _, up = convert.torch_params_from_artifact(types.SimpleNamespace(A=[], up=np_params), "cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((*canvas, 128)).astype(np.float32)
    args = (d, factors, (2, 1, 1))
    got = stack(up, torch.from_numpy(x), *args)
    r = rng.standard_normal(tuple(got.shape)).astype(np.float32)
    _, grads = _stack_grads(stack, up, x, args, r, torch.float32)
    _, grads64 = _stack_grads(stack, up, x, args, r, torch.float64)
    hi = jax.lax.Precision.HIGHEST
    matching = {apply_upsample: jax_apply_upsample, apply_upsample_phased: jax_apply_upsample_phased}
    for fn in (jax_apply_upsample, jax_apply_upsample_phased):
        want = np.asarray(fn(jp, jnp.asarray(x), *args, precision=hi))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    gp, gx = jax.grad(lambda p, xx: (matching[stack](p, xx, *args, precision=hi) * r).sum(),
                      argnums=(0, 1))(jp, jnp.asarray(x))
    jgrads = [np.asarray(gx)] + [np.asarray(gp[f"conv{i}"][n]) for i in range(3)
                                 for n in ("w", "b")]
    names = ["input"] + [f"conv{i}/{n}" for i in range(3) for n in ("w", "b")]
    for g, jg, g64, what in zip(grads, jgrads, grads64, names):
        jg = convert.conv_weight_to_torch(jg) if what.endswith("/w") else jg
        tol = 1e-5 * (np.abs(g64) + np.abs(g64).max())
        if (np.abs(jg - g64) <= tol).all():
            assert (np.abs(g - g64) <= tol).all(), (what, np.abs(g - g64).max())
        else:
            gap, jgap = np.abs(g - g64).max(), np.abs(jg - g64).max()
            assert gap <= 2 * jgap, (what, gap, jgap)
    assert got.shape[1:] == want.shape[1:]


@pytest.mark.parametrize("k,factors,p", [(5, (6, 4, 4), 2), (3, (1, 2, 2), 1), (5, (4,), 2),
                                         (3, (2, 1, 3), 1)])
def test_anisotropic_phase_kernel_matrix_is_the_jax_packages(k, factors, p):
    M, ext, pads = phase_kernel_matrix(k, factors, p)
    jM, jext, jpads = jax_phase_kernel_matrix(k, factors, p)
    np.testing.assert_array_equal(M, jM)
    assert (ext, pads) == (jext, jpads)


@pytest.mark.parametrize("name", ["tiny_audio", "tiny_video", "audio_mini", "protein"])
def test_lpe_to_pe_matches_jax(name):
    """Two datapoints' LPEs (the stitched canvases of a patch config)
    through the conv stack and split again (``_close``)."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    jp = init_upsample_params(jax.random.key(3), cfg.data_dim)
    _, up = convert.torch_params_from_artifact(
        types.SimpleNamespace(A=[], up=jax.tree_util.tree_map(np.asarray, jp)), "cpu")
    rows = 2 * cfg.patches_per_datapoint
    lpe = np.random.default_rng(4).standard_normal(
        (rows, S, *cfg.lpe_spatial, cfg.latent_dim)).astype(np.float32)
    want = jmap.lpe_to_pe(jp, jnp.asarray(lpe), jcfg)
    got = mappings.lpe_to_pe(up, torch.from_numpy(lpe), cfg)
    assert got.shape == (rows, S, cfg.n_pixels, cfg.upsample_out)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["tiny_audio", "tiny_video", "audio", "video"])
def test_expand_level_matches_jax(name):
    cfg = get_config(name)
    rng = np.random.default_rng(5)
    for lv in (cfg.level2_patch_nums, cfg.level3_patch_nums):
        n = 2 * cfg.patches_per_datapoint // int(np.prod(lv))
        x = rng.normal(0, 1, (n, 3, 4)).astype(np.float32)
        want = jmap.expand_level(jnp.asarray(x), cfg.patch_nums, lv)
        got = mappings.expand_level(torch.from_numpy(x), cfg.patch_nums, lv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ artifacts


@pytest.mark.parametrize("name", list(PRIORS))
def test_committed_artifacts_load_alike(name):
    """Config, kl_beta, codebook, every level's prior and grouping, A and
    the conv weights equal; the conv weights reach torch as (O, I, *k)."""
    jart, art = jck.load_prior_artifact(PRIORS[name]), checkpoint.load_prior_artifact(PRIORS[name])
    assert art.config.name == jart.config.name == name
    assert art.config.net_dims == jart.config.net_dims
    assert (art.kl_beta, art.codebook_seed, art.codebook_kind) == (
        jart.kl_beta, jart.codebook_seed, jart.codebook_kind)
    for lv in LEVELS:
        a, j = getattr(art, lv), getattr(jart, lv)
        assert (a is None) == (j is None) == (lv != "w" and not art.config.patch)
        if a is None:
            continue
        for f in ("p_loc", "p_scale", "avg_log_scale"):
            np.testing.assert_array_equal(getattr(a, f), getattr(j, f))
        for f in ("group_start", "group_end", "group_idx", "param2group", "group2param"):
            np.testing.assert_array_equal(getattr(a.grouping, f), getattr(j.grouping, f))
    A, up = convert.torch_params_from_artifact(art, "cpu")
    for a, j in zip(A, jart.A):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    d = art.config.data_dim
    for i in range(3):
        jw = np.asarray(jart.up[f"conv{i}"]["w"])
        w = up[f"conv{i}"]["w"]
        assert jw.ndim == d + 2 and tuple(w.shape) == (jw.shape[-1], jw.shape[-2], *jw.shape[:d])
        np.testing.assert_array_equal(w.permute(*range(2, 2 + d), 1, 0).numpy(), jw)
        np.testing.assert_array_equal(up[f"conv{i}"]["b"].numpy(), np.asarray(
            jart.up[f"conv{i}"]["b"]))


# --------------------------------------------------------------- decode


def _decode_both(path, rows, seed, data):
    """Random indices for every level, decoded by both packages, each with
    its own codebooks, from ``data``'s points."""
    jart, art = jck.load_prior_artifact(path), checkpoint.load_prior_artifact(path)
    cfg = art.config
    jcodec = jenc.init_codec(jart, rows)[0]
    codec = decoder.init_codec(art, rows, device="cpu")[0]
    rng = np.random.default_rng(seed)
    n_rows = {"w": rows}
    if cfg.patch:
        n_rows.update(h=cfg.rows_level2(rows), hh=cfg.rows_level3(rows))
    idx = {n: rng.integers(0, 2**cfg.bits_per_group, (r, codec.meta(n).n_groups)).astype(
        np.int32) for n, r in n_rows.items()}
    X = pipeline.points_from_data(data, cfg)[0]
    assert X.shape[0] == rows
    want = np.asarray(jenc.decode(jcodec, idx, jnp.asarray(X), jart.config))
    got = decoder.decode(codec, idx, X, cfg).numpy()
    assert got.shape == (rows, cfg.n_pixels, cfg.output_dim) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **DECODE_TOL)
    return codec, idx, X


def test_audio_mini_decode_matches_jax():
    """One audio_mini datapoint at full widths: 4 + 2 + 1 rows, the 1-D
    stitched canvas of 4 x 50 latents (``DECODE_TOL``)."""
    codec, _, _ = _decode_both(PRIORS["audio_mini"], 4, 6, [np.zeros((3200, 1), np.float32)])
    assert [codec.meta(n).n_groups for n in LEVELS] == [70, 36, 49]


def test_protein_decode_matches_jax():
    """Four chains of the protein prior, one level (``DECODE_TOL``)."""
    rng = np.random.default_rng(7)
    _decode_both(PRIORS["protein"], 4, 7, [protein_backbone(rng, 96) for _ in range(4)])


def test_video_decode_matches_jax():
    """One whole video clip at full geometry: 64 + 4 + 1 rows, the 3-D
    stitched canvas of 1 x 8 x 8 latents upsampled by (6, 4, 4), 2, 2 to
    24 x 128 x 128 (``DECODE_TOL``)."""
    codec, _, _ = _decode_both(PRIORS["video"], 64, 8, [np.zeros((24, 128, 128, 3), np.float32)])
    assert [codec.meta(n).n_groups for n in LEVELS] == [38, 57, 53]
