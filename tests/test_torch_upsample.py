"""The port's two conv stacks (cuDNN / CPU conv2d, NCHW inside, channel-last
at the boundary), the plain ``apply_upsample`` and the phase rewrite
``apply_upsample_phased``, each against both JAX versions:
``apply_upsample`` and the phase rewrite that the JAX package's decode runs.

Weights come from numpy through ``torch_params_from_artifact`` (HWIO ->
OIHW). Tolerance atol 1e-5, rtol 1e-5: each output sums up to 3,200 f32
products (128 channels x 5 x 5) in a different order.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.config import CIFAR, TINY
from recombiner_tpu.models.mappings import lpe_to_pe as jax_lpe_to_pe
from recombiner_tpu.models.upsample import apply_upsample as jax_apply_upsample
from recombiner_tpu.models.upsample import init_upsample_params
from recombiner_tpu.ops.phase_upsample import apply_upsample_phased as jax_apply_upsample_phased
from recombiner_tpu_torch.config import TINY_AUDIO, get_config
from recombiner_tpu_torch.io.convert import torch_params_from_artifact
from recombiner_tpu_torch.models.mappings import lpe_to_pe
from recombiner_tpu.ops.phase_upsample import phase_kernel_matrix as jax_phase_kernel_matrix
from recombiner_tpu_torch.models.upsample import (
    apply_upsample,
    apply_upsample_phased,
    phase_kernel_matrix,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _params(cfg, seed):
    p = init_upsample_params(jax.random.key(seed), cfg.data_dim, cfg.latent_dim,
                             cfg.upsample_hidden, cfg.upsample_out)
    np_params = jax.tree_util.tree_map(np.asarray, p)
    _, up = torch_params_from_artifact(types.SimpleNamespace(A=[], up=np_params), "cpu")
    return p, up


@pytest.mark.parametrize("stack", [apply_upsample, apply_upsample_phased])
@pytest.mark.parametrize("name", ["tiny", "cifar"])
def test_conv_stack_matches_both_jax_versions(name, stack):
    jcfg = {"tiny": TINY, "cifar": CIFAR}[name]
    cfg = get_config(name)
    jp, up = _params(jcfg, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, *cfg.lpe_spatial, cfg.latent_dim)).astype(np.float32)
    args = (cfg.data_dim, cfg.layerwise_scale_factors, cfg.paddings)
    got = stack(up, torch.from_numpy(x), *args).numpy()
    assert got.shape == (3, *cfg.pixel_sizes, cfg.upsample_out)
    hi = jax.lax.Precision.HIGHEST
    for fn in (jax_apply_upsample, jax_apply_upsample_phased):
        want = np.asarray(fn(jp, jnp.asarray(x), *args, precision=hi))
        np.testing.assert_allclose(got, want, **TOL)


def test_lpe_to_pe_matches_jax_cifar():
    jp, up = _params(CIFAR, seed=3)
    cfg = get_config("cifar")
    rng = np.random.default_rng(4)
    lpe = rng.standard_normal((2, 2, *cfg.lpe_spatial, cfg.latent_dim)).astype(np.float32)
    want = np.asarray(jax_lpe_to_pe(jp, jnp.asarray(lpe), CIFAR))
    got = lpe_to_pe(up, torch.from_numpy(lpe), cfg).numpy()
    assert got.shape == (2, 2, cfg.n_pixels, cfg.upsample_out)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,f,p", [(5, 4, 2), (3, 2, 1), (7, 2, 3), (1, 3, 0)])
def test_phase_kernel_matrix_is_the_jax_packages(k, f, p):
    M, ext, pads = phase_kernel_matrix(k, (f, f), p)
    jM, jext, jpads = jax_phase_kernel_matrix(k, (f, f), p)
    np.testing.assert_array_equal(M, jM)
    assert (ext, pads) == (jext, jpads)


def test_hwio_to_oihw():
    w = np.arange(5 * 5 * 4 * 6, dtype=np.float32).reshape(5, 5, 4, 6)
    ns = types.SimpleNamespace(A=[np.eye(3)], up={"conv0": {"w": w, "b": np.zeros(6)}})
    A, up = torch_params_from_artifact(ns, "cpu")
    assert up["conv0"]["w"].shape == (6, 4, 5, 5)
    assert up["conv0"]["w"][2, 1, 3, 4].item() == w[3, 4, 1, 2]
    assert A[0].dtype == torch.float32


def test_not_ported_geometries_raise():
    for stack in (apply_upsample, apply_upsample_phased):
        with pytest.raises(NotImplementedError):
            stack({}, torch.zeros(1, 4, 32), 1, (4, 2, 2), (2, 1, 1))
    # the 1-D patch path stitches its canvas, then meets the 2-D-only stack
    with pytest.raises(NotImplementedError):
        lpe_to_pe({}, torch.zeros(4, 1, 4, 128), TINY_AUDIO)
