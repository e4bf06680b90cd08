"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Needs a CUDA card and nvcc; skips here otherwise (decided inside the
fixture, so every worker collects the same tests). On the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(--noconftest because tests/conftest.py configures JAX, which that machine
does not have.) Tolerances: the forward at atol 1e-4, rtol 1e-4 (the
kernel's FMA order differs from cuBLAS's and w0 = 30 scales each layer's
rounding difference); the backward at 2e-4 of the largest gradient entry
(``BWD_OF_MAX``): at these inputs the f32 plain version itself differs from
an f64 evaluation by about 5e-5 of it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from recombiner_tpu_torch.coding.decoder import decode, init_codec
from recombiner_tpu_torch.coding.encoder import encode_step
from recombiner_tpu_torch.config import CIFAR, TINY
from recombiner_tpu_torch.device import exact_f32
from recombiner_tpu_torch.models.gaussian import Gaussian
from recombiner_tpu_torch.models.inr import inr_forward
from recombiner_tpu_torch.ops import fused_inr

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-4, rtol=1e-4)
BWD_OF_MAX = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with exact_f32():
        yield torch.device("cuda")


def _inputs(cfg, B, P, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dims = cfg.net_dims
    x = torch.randn(B, P, dims[0], generator=g, device=dev)
    A = [torch.empty(d, d, device=dev).uniform_(-0.1, 0.1, generator=g)
         for d in cfg.layer_param_counts]
    h_w = 0.01 * torch.randn(B, cfg.n_inr_params, generator=g, device=dev)
    return x, fused_inr.materialize_theta(h_w, A, cfg)


@pytest.mark.parametrize("name,B,P", [("cifar", 500, 1024), ("cifar", 3, 1000),
                                      ("tiny", 5, 256), ("tiny", 1, 1)])
@pytest.mark.parametrize("spb", [1, 8])
def test_kernel_matches_plain_version(cuda, name, B, P, spb):
    cfg = CIFAR if name == "cifar" else TINY
    x, theta = _inputs(cfg, B, P, cuda)
    before = fused_inr.launches["siren_fwd"]
    got = fused_inr.siren_forward(x, theta, cfg.net_dims, cfg.w0, samples_per_block=spb)
    torch.cuda.synchronize()
    assert fused_inr.launches["siren_fwd"] == before + 1
    want = fused_inr.siren_forward_reference(x, theta, cfg.net_dims, cfg.w0)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dims", [[64, 64, 40, 7], [34, 32, 32, 32, 3], [5, 7, 3]])
def test_kernel_takes_widths_up_to_64(cuda, dims):
    """Widths up to 64, and widths that are not multiples of 8 (video's
    34-wide input, [5, 7, 3]), which the kernel pads to tensor-core tiles."""
    B, P = 4, 300
    x = torch.randn(B, P, dims[0], device=cuda)
    theta = 0.05 * torch.randn(B, fused_inr.theta_size(dims), device=cuda)
    got = fused_inr.siren_forward(x, theta, dims, 30.0)
    torch.testing.assert_close(got, fused_inr.siren_forward_reference(x, theta, dims, 30.0),
                               **TOL)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    dims = [65, 8, 3]
    x = torch.zeros(2, 16, 65, device=cuda)
    with pytest.raises(ValueError):
        fused_inr.siren_forward(x, torch.zeros(2, fused_inr.theta_size(dims), device=cuda),
                                dims, 30.0)
    dims = list(TINY.net_dims)
    x = torch.zeros(2, dims[0], 16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        fused_inr.siren_forward(x, torch.zeros(2, fused_inr.theta_size(dims), device=cuda),
                                dims, 30.0)


def test_decode_on_card_matches_cpu(cuda):
    from chip_smoke import make_cifar_artifact
    from recombiner_tpu_torch.coords import grid_fourier_features

    art = make_cifar_artifact(1)
    cfg = art.config
    R = 4
    idx = {"w": np.random.default_rng(1).integers(0, 2**16, (R, art.w.grouping.n_groups))}
    feats = torch.from_numpy(grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim))
    X = feats.expand(R, *feats.shape)
    y_gpu = decode(init_codec(art, R)[0], idx, X, cfg)
    y_cpu = decode(init_codec(art, R, device="cpu")[0], idx, X, cfg)
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, **TOL)


def _assert_close_of_max(got, want, what):
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= BWD_OF_MAX * want.abs().max().item(), (
        f"{what}: max abs diff {err:.3e} against largest entry {want.abs().max().item():.3e}")


@pytest.mark.parametrize("name,B,P", [("cifar", 500, 1024), ("cifar", 3, 1000),
                                      ("tiny", 5, 256), ("tiny", 1, 1), ("cifar", 2, 129)])
def test_backward_kernel_matches_plain_version(cuda, name, B, P):
    cfg = CIFAR if name == "cifar" else TINY
    x, theta = _inputs(cfg, B, P, cuda)
    dy = torch.randn(B, P, cfg.output_dim, device=cuda)
    before = fused_inr.launches["siren_bwd"]
    dx, dtheta = fused_inr.siren_backward(x, theta, dy, cfg.net_dims, cfg.w0)
    torch.cuda.synchronize()
    assert fused_inr.launches["siren_bwd"] == before + 1
    want_dx, want_dtheta = fused_inr.siren_backward_reference(x, theta, dy, cfg.net_dims, cfg.w0)
    _assert_close_of_max(dx, want_dx, "dx")
    _assert_close_of_max(dtheta, want_dtheta, "dtheta")


@pytest.mark.parametrize("dims", [[64, 64, 40, 7], [3, 64, 64, 64, 64, 64, 64, 64, 1],
                                  [5, 7, 3]])
def test_backward_kernel_takes_widths_up_to_64_and_8_layers(cuda, dims):
    B, P = 3, 300
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(B, P, dims[0], generator=g, device=cuda)
    theta = 0.01 * torch.randn(B, fused_inr.theta_size(dims), generator=g, device=cuda)
    dy = torch.randn(B, P, dims[-1], generator=g, device=cuda)
    dx, dtheta = fused_inr.siren_backward(x, theta, dy, dims, 30.0)
    want_dx, want_dtheta = fused_inr.siren_backward_reference(x, theta, dy, dims, 30.0)
    _assert_close_of_max(dx, want_dx, "dx")
    _assert_close_of_max(dtheta, want_dtheta, "dtheta")


def test_backward_kernel_is_deterministic(cuda):
    cfg = CIFAR
    x, theta = _inputs(cfg, 64, 1024, cuda, seed=3)
    dy = torch.randn(64, 1024, cfg.output_dim, device=cuda)
    a = fused_inr.siren_backward(x, theta, dy, cfg.net_dims, cfg.w0)
    b = fused_inr.siren_backward(x, theta, dy, cfg.net_dims, cfg.w0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_backward_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    dims = [65, 8, 3]
    x = torch.zeros(2, 16, 65, device=cuda)
    theta = torch.zeros(2, fused_inr.theta_size(dims), device=cuda)
    with pytest.raises(ValueError):
        fused_inr.siren_backward(x, theta, torch.zeros(2, 16, 3, device=cuda), dims, 30.0)
    dims = list(TINY.net_dims)
    x = torch.zeros(2, 16, dims[0], device=cuda)
    theta = torch.zeros(2, fused_inr.theta_size(dims), device=cuda)
    dy = torch.zeros(2, dims[-1], 16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        fused_inr.siren_backward(x, theta, dy, dims, 30.0)
    with pytest.raises(ValueError):
        fused_inr.siren_backward(x, theta, torch.zeros(2, 16, dims[-1]), dims, 30.0)


def test_siren_mlp_gradient_matches_autograd_of_plain_version(cuda):
    cfg = CIFAR
    g = torch.Generator(device=cuda).manual_seed(4)
    R, S, P = 3, 2, 1024
    x = torch.randn(R, S, P, cfg.input_dim, generator=g, device=cuda)
    h_w = 0.01 * torch.randn(R, S, cfg.n_inr_params, generator=g, device=cuda)
    A = [torch.empty(d, d, device=cuda).uniform_(-0.1, 0.1, generator=g)
         for d in cfg.layer_param_counts]
    Y = torch.rand(R, P, cfg.output_dim, generator=g, device=cuda)
    grads = []
    for fwd in (fused_inr.inr_forward_fused, inr_forward):
        leaves = [t.clone().requires_grad_() for t in (x, h_w, *A)]
        y = fwd(leaves[0], leaves[1], leaves[2:], cfg)
        torch.mean((y - Y[:, None]) ** 2).backward()
        grads.append([t.grad for t in leaves])
    for got, want, what in zip(grads[0], grads[1], ["x", "h_w"] + [f"A{i}" for i in range(4)]):
        _assert_close_of_max(got, want, what)


def test_encode_step_on_card_matches_cpu(cuda):
    from chip_smoke import make_cifar_artifact

    art = make_cifar_artifact(2)
    R = 6
    states = []
    for dev in ("cuda", "cpu"):
        codec, state = init_codec(art, R, device=dev)
        g = torch.Generator().manual_seed(5)
        loc = state.w.q.loc + 0.01 * torch.randn(state.w.q.loc.shape, generator=g).to(dev)
        state = dataclasses.replace(state, w=dataclasses.replace(
            state.w, q=Gaussian(loc, state.w.q.log_scale)))
        for _ in range(2):
            state = encode_step(codec, state)
        states.append(state.w)
    card, cpu = states
    assert torch.equal(card.indices.cpu(), cpu.indices)
    assert torch.equal(card.compressed.cpu(), cpu.compressed)
    torch.testing.assert_close(card.frozen_val.cpu(), cpu.frozen_val, rtol=1e-6, atol=1e-7)
