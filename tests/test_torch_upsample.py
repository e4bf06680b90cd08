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
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.io.convert import torch_params_from_artifact
from recombiner_tpu_torch.models.mappings import lpe_to_pe
from recombiner_tpu.ops.phase_upsample import phase_kernel_matrix as jax_phase_kernel_matrix
from recombiner_tpu_torch.models.upsample import (
    _depth_to_space,
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
    """The phase stack takes size-preserving convs only (2p = k - 1), in 1-D,
    2-D and 3-D (the plain stack takes any padding); neither stack takes a
    4-D canvas. 1-D and 3-D are held to the JAX package in
    ``test_torch_modalities.py``."""
    for d in (1, 2, 3):
        _, up = _params(types.SimpleNamespace(data_dim=d, latent_dim=128, upsample_hidden=64,
                                              upsample_out=16), seed=5)
        x = torch.zeros(1, *(1,) * d, 128)
        with pytest.raises(NotImplementedError, match="size-preserving"):
            apply_upsample_phased(up, x, d, (4, 2, 2), (1, 1, 1))
        assert apply_upsample(up, x, d, (4, 2, 2), (1, 1, 1)).shape[1:] == (*(8,) * d, 16)
    for stack in (apply_upsample, apply_upsample_phased):
        with pytest.raises(ValueError, match="1-, 2- or 3-D"):
            stack({}, torch.zeros(1, 4, 4, 4, 4, 128), 4, (4, 2, 2), (2, 1, 1))


@pytest.mark.parametrize("f", [2, 4])
def test_depth_to_space_is_pixel_shuffle_in_2d(f):
    """At 2-D square factors (CIFAR's and Kodak's) the phase stack's
    depth-to-space gives ``F.pixel_shuffle``'s values bit for bit, forward
    and back. On the channels-last output of a conv, pixel_shuffle keeps
    channels-last strides and ``_depth_to_space`` does not: the next conv
    then rounds otherwise, so the 2-D stack keeps pixel_shuffle."""
    x = torch.from_numpy(np.random.default_rng(f).standard_normal((2, 5, 7, 3 * f * f),
                                                                   np.float32))
    x = x.permute(0, 3, 1, 2)  # channels-last strides, as the stack's convs give
    g = torch.from_numpy(np.random.default_rng(f + 1).standard_normal((2, 3, 5 * f, 7 * f),
                                                                       np.float32))
    outs = []
    for fn in (lambda y: _depth_to_space(y, (f, f)),
               lambda y: torch.nn.functional.pixel_shuffle(y, f)):
        xi = x.clone(memory_format=torch.preserve_format).requires_grad_(True)
        y = fn(xi)
        y.backward(g)
        outs.append((y.detach(), xi.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert outs[0][0].is_contiguous()
    assert outs[1][0].is_contiguous(memory_format=torch.channels_last)
