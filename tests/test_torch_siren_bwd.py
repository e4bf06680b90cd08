"""The port's SIREN backward against the JAX package's.

``siren_backward_reference`` (the plain version the CUDA kernel
``siren_bwd.cu`` is held to, and what ``siren_backward`` runs for CPU
tensors) is reached through autograd of the port's ``inr_forward_fused``
(``SirenMLP``), and held to ``jax.grad`` of the JAX package's Pallas pair
(``ops/fused_inr.py``, ``_bwd_kernel`` in interpret mode) and of its einsum
``inr_forward``: the gradients with respect to x, h_w and A.

Tolerance: atol 1e-5 x the largest gradient entry plus rtol 1e-5, that of
tests/test_fused_inr.py (rtol 1e-5) with an absolute floor for entries that
are sums of terms of both signs; the f32 sums run in a different order,
amplified by w0 = 30 through the sin layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.config import AUDIO, CIFAR, TINY, VIDEO
from recombiner_tpu.models.inr import inr_forward as jax_inr_forward
from recombiner_tpu.ops import fused_inr as jax_fused
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.ops import fused_inr

RTOL = 1e-5
ATOL_OF_MAX = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    atol = ATOL_OF_MAX * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _inputs(cfg, R, S, P, seed):
    rng = np.random.default_rng(seed)
    A = [rng.uniform(-1.0 / d, 1.0 / d, (d, d)).astype(np.float32)
         for d in cfg.layer_param_counts]
    x = rng.standard_normal((R, S, P, cfg.input_dim)).astype(np.float32)
    h_w = (0.05 * rng.standard_normal((R, S, cfg.n_inr_params))).astype(np.float32)
    Y = rng.uniform(0.0, 1.0, (R, P, cfg.output_dim)).astype(np.float32)
    return x, h_w, A, Y


CASES = {
    "tiny": (TINY, 2, 3, None),
    "cifar": (CIFAR, 2, 2, None),
    "odd_p": (TINY, 3, 1, (10, 25)),  # P = 250, a multiple of no tile
    # audio's and video's widths (their kernel instances), at a small P
    "audio": (AUDIO, 2, 2, (160,)),
    "video": (VIDEO, 2, 1, (2, 8, 12)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_fused_and_autodiff(case):
    jcfg, R, S, pixels = CASES[case]
    cfg = get_config(jcfg.name)
    if pixels is not None:
        jcfg = dataclasses.replace(jcfg, pixel_sizes=pixels)
        cfg = dataclasses.replace(cfg, pixel_sizes=pixels)
    P = int(np.prod(jcfg.pixel_sizes))
    x, h_w, A, Y = _inputs(jcfg, R, S, P, seed=len(case))

    def jax_loss(fwd):
        def f(h_w, A, x):
            return jnp.mean((fwd(x, h_w, A) - Y[:, None]) ** 2)
        return f

    args = (jnp.asarray(h_w), [jnp.asarray(a) for a in A], jnp.asarray(x))
    g_fused = jax.grad(jax_loss(lambda x, h, a: jax_fused.inr_forward_fused(
        x, h, a, jcfg, interpret=True)), argnums=(0, 1, 2))(*args)
    g_einsum = jax.grad(jax_loss(lambda x, h, a: jax_inr_forward(x, h, a, jcfg)),
                        argnums=(0, 1, 2))(*args)

    th = torch.from_numpy(h_w).requires_grad_()
    tA = [torch.from_numpy(a).requires_grad_() for a in A]
    tx = torch.from_numpy(x).requires_grad_()
    before = dict(fused_inr.launches)
    loss = torch.mean((fused_inr.inr_forward_fused(tx, th, tA, cfg) - torch.from_numpy(Y)[:, None])
                      ** 2)
    loss.backward()
    assert fused_inr.launches == before  # CPU tensors never reach a kernel

    for want in (g_fused, g_einsum):
        _close(th.grad, want[0], "h_w")
        for i, a in enumerate(tA):
            _close(a.grad, want[1][i], f"A[{i}]")
        _close(tx.grad, want[2], "x")


@pytest.mark.parametrize("dims,P", [([32, 32, 32, 32, 3], 100), ([64, 64, 40, 7], 30),
                                    ([3, 64, 64, 64, 64, 64, 64, 64, 1], 7), ([5, 7, 3], 1)])
def test_plain_backward_is_autograd_of_plain_forward(dims, P):
    """The written-out chain against autograd through the plain forward, at
    widths up to 64 and up to 8 layers (what the kernel takes)."""
    g = torch.Generator().manual_seed(P)
    B = 3
    x = torch.randn(B, P, dims[0], generator=g, dtype=torch.float64)
    theta = 0.01 * torch.randn(B, fused_inr.theta_size(dims), generator=g, dtype=torch.float64)
    dy = torch.randn(B, P, dims[-1], generator=g, dtype=torch.float64)
    dx, dtheta = fused_inr.siren_backward_reference(x, theta, dy, dims, 30.0)
    xr, tr = x.clone().requires_grad_(), theta.clone().requires_grad_()
    y = fused_inr.siren_forward_reference(xr, tr, dims, 30.0)
    want_dx, want_dtheta = torch.autograd.grad(y, (xr, tr), dy)
    torch.testing.assert_close(dx, want_dx, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dtheta, want_dtheta, rtol=1e-10, atol=1e-12)


def test_siren_mlp_on_cpu_runs_the_plain_versions():
    dims = [32, 8, 8, 3]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, dims[0], generator=g, requires_grad=True)
    theta = (0.1 * torch.randn(2, fused_inr.theta_size(dims), generator=g)).requires_grad_()
    dy = torch.randn(2, 40, dims[-1], generator=g)
    y = fused_inr.SirenMLP.apply(x, theta, dims, 30.0)
    torch.testing.assert_close(y, fused_inr.siren_forward_reference(x, theta, dims, 30.0),
                               rtol=0, atol=0)
    y.backward(dy)
    dx, dtheta = fused_inr.siren_backward_reference(x.detach(), theta.detach(), dy, dims, 30.0)
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(theta.grad, dtheta, rtol=0, atol=0)


def test_backward_wrapper_checks_its_inputs():
    dims = [32, 8, 3]
    x = torch.zeros(2, 16, 32)
    theta = torch.zeros(2, fused_inr.theta_size(dims))
    with pytest.raises(ValueError):
        fused_inr.siren_backward(x, theta, torch.zeros(2, 16, 4), dims, 30.0)
    with pytest.raises(ValueError):
        fused_inr.siren_backward(x, theta[:, :-1], torch.zeros(2, 16, 3), dims, 30.0)
    with pytest.raises(TypeError):
        fused_inr.siren_backward(x.double(), theta.double(), torch.zeros(2, 16, 3), dims, 30.0)
    with pytest.raises(ValueError):
        fused_inr.siren_backward(x.to("meta"), theta.to("meta"), torch.zeros(2, 16, 3,
                                 device="meta"), dims, 30.0)
