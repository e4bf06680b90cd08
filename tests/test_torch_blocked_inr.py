"""The port's ``ops/blocked_inr.py`` (four samples' layers in one
block-diagonal product) on the CPU: the four tests of
``tests/test_blocked_inr.py`` at their tolerances, and the port against the
JAX package's ``inr_forward_blocked`` on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from recombiner_tpu.config import CIFAR as JCIFAR
from recombiner_tpu.models.inr import init_linear_transform as jax_init_linear_transform
from recombiner_tpu.ops.blocked_inr import inr_forward_blocked as jax_inr_forward_blocked
from recombiner_tpu_torch.config import CIFAR, TINY
from recombiner_tpu_torch.models.inr import init_linear_transform, inr_forward
from recombiner_tpu_torch.ops.blocked_inr import _block_diag, inr_forward_blocked


def _inputs(cfg, R, S, P, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = init_linear_transform(cfg.net_dims, g)
    x = torch.randn(R, S, P, cfg.input_dim, generator=g)
    hw = 0.02 * torch.randn(R, S, cfg.n_inr_params, generator=g)
    return x, hw, A


def test_block_diag_layout():
    w = torch.arange(2 * 4 * 2 * 3, dtype=torch.float32).reshape(2, 4, 2, 3)
    bd = _block_diag(w)
    assert bd.shape == (2, 8, 12)
    for g in range(2):
        for s in range(4):
            torch.testing.assert_close(bd[g, s * 2:(s + 1) * 2, s * 3:(s + 1) * 3], w[g, s],
                                       rtol=0, atol=0)
    mask = torch.block_diag(*[torch.ones(2, 3)] * 4).bool()
    assert (bd[:, ~mask] == 0).all()  # off the diagonal blocks: zero


def test_blocked_matches_reference_forward():
    x, hw, A = _inputs(CIFAR, 4, 2, 64)  # R * S = 8, a multiple of 4
    np.testing.assert_allclose(inr_forward_blocked(x, hw, A, CIFAR).numpy(),
                               inr_forward(x, hw, A, CIFAR).numpy(), atol=2e-5, rtol=1e-5)


def test_blocked_fallback_non_multiple():
    x, hw, A = _inputs(TINY, 3, 1, 16)  # R * S = 3
    np.testing.assert_allclose(inr_forward_blocked(x, hw, A, TINY).numpy(),
                               inr_forward(x, hw, A, TINY).numpy(), atol=1e-6)


def test_blocked_gradients_match():
    x, hw, A = _inputs(TINY, 4, 1, 16)
    grads = []
    for fn in (inr_forward, inr_forward_blocked):
        h = hw.clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.mean(fn(x, h, A, TINY) ** 2), [h])
        grads.append(g.numpy())
    np.testing.assert_allclose(grads[1], grads[0], atol=1e-6, rtol=1e-4)


def test_blocked_matches_the_jax_package():
    """The same numpy inputs (A from the JAX package's initialiser) through
    both packages' ``inr_forward_blocked``, CIFAR at R = 4, S = 2, P = 64:
    atol 2e-5, rtol 1e-5, the blocked-vs-reference tolerance above."""
    A = [np.array(a) for a in jax_init_linear_transform(jax.random.key(0), JCIFAR.net_dims)]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 2, 64, JCIFAR.input_dim)).astype(np.float32)
    hw = (0.02 * rng.normal(size=(4, 2, JCIFAR.n_inr_params))).astype(np.float32)
    want = np.asarray(jax_inr_forward_blocked(jnp.asarray(x), jnp.asarray(hw),
                                              [jnp.asarray(a) for a in A], JCIFAR))
    got = inr_forward_blocked(torch.from_numpy(x), torch.from_numpy(hw),
                              [torch.from_numpy(a) for a in A], CIFAR).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
