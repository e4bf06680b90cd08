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
from recombiner_tpu_torch.config import CIFAR, KODAK, TINY
from recombiner_tpu_torch import device
from recombiner_tpu_torch.device import exact_f32
from recombiner_tpu_torch.models.gaussian import Gaussian
from recombiner_tpu_torch.models.inr import inr_forward
from recombiner_tpu_torch.ops import fused_inr
from recombiner_tpu_torch.utils import platform

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-4, rtol=1e-4)
BWD_OF_MAX = 2e-4


@pytest.fixture
def cuda():
    """The card, with the ambient precision exact (``--precision highest``)
    and TF32 off: every comparison here holds the card to exact f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with platform.ambient("highest"), exact_f32():
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


@pytest.mark.parametrize("dims", [[64, 64, 40, 7], [34, 32, 32, 32, 3], [5, 7, 3], [34, 8, 8, 3]])
def test_kernel_takes_widths_up_to_64(cuda, dims):
    """Widths up to 64, and widths that are not multiples of 8 (video's
    34-wide input on its fixed instance, TINY_VIDEO's on the run-time one,
    [5, 7, 3]), which the kernel pads to tensor-core tiles."""
    assert fused_inr.launch_plan("siren_fwd", dims)["instance"] == fused_inr.instance(dims)
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
                                  [5, 7, 3], [34, 8, 8, 3], [44, 20, 3]])
def test_backward_kernel_takes_widths_up_to_64_and_8_layers(cuda, dims):
    """The run-time instance, which every width set outside the fixed table
    takes: widths up to 64 in up to 8 layers, 34- and 44-wide inputs whose
    last 16-row block of dW_0 is half or wholly past the width."""
    assert fused_inr.launch_plan("siren_bwd", dims)["instance"] == fused_inr.RUNTIME_INSTANCE
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


@pytest.mark.parametrize("B", [96, 3])
def test_forward_kernel_at_kodak_pixel_count(cuda, B):
    """A Kodak patch row has P = 4,096 pixels: decode launches B = 96 rows
    (one image), each sample's pixels spread over four blocks."""
    x, theta = _inputs(KODAK, B, KODAK.n_pixels, cuda)
    got = fused_inr.siren_forward(x, theta, KODAK.net_dims, KODAK.w0, samples_per_block=1)
    want = fused_inr.siren_forward_reference(x, theta, KODAK.net_dims, KODAK.w0)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("B", [480, 2])
def test_backward_kernel_at_kodak_pixel_count(cuda, B):
    """An S = 5 Kodak epoch launches B = 480 samples of P = 4,096 pixels, one
    block each looping over sixteen pixel tiles: dW's fixed-order sums and
    the tile pipeline at that length; two launches bitwise equal."""
    x, theta = _inputs(KODAK, B, KODAK.n_pixels, cuda)
    dy = torch.randn(B, KODAK.n_pixels, KODAK.output_dim, device=cuda)
    dx, dtheta = fused_inr.siren_backward(x, theta, dy, KODAK.net_dims, KODAK.w0)
    again = fused_inr.siren_backward(x, theta, dy, KODAK.net_dims, KODAK.w0)
    assert torch.equal(dx, again[0]) and torch.equal(dtheta, again[1])
    want_dx, want_dtheta = fused_inr.siren_backward_reference(x, theta, dy, KODAK.net_dims,
                                                              KODAK.w0)
    _assert_close_of_max(dx, want_dx, "dx")
    _assert_close_of_max(dtheta, want_dtheta, "dtheta")


def test_patch_encode_steps_on_card_match_cpu(cuda):
    """Encode steps at levels hh, h and w of the TINY_PATCH fixture prior (8
    patch rows, rows mixed across patches per column) from one perturbed
    state: on the card the indices and coded masks equal the CPU's and the
    frozen values agree to f32 rounding."""
    import os

    from recombiner_tpu_torch.io.checkpoint import load_prior_artifact

    art = load_prior_artifact(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "fixtures", "tiny_patch_prior.npz"))
    levels = {}
    for dev in ("cuda", "cpu"):
        codec, state = init_codec(art, 8, device=dev)
        g = torch.Generator().manual_seed(5)
        for name in ("w", "h", "hh"):
            ls = state.level(name)
            loc = ls.q.loc + 0.01 * torch.randn(ls.q.loc.shape, generator=g).to(dev)
            state = state.replace_level(name, dataclasses.replace(
                ls, q=Gaussian(loc, ls.q.log_scale)))
        for name in ("hh", "h", "w"):
            for _ in range(2):
                state = encode_step(codec, state, name)
        levels[dev] = state
    for name in ("w", "h", "hh"):
        card, cpu = levels["cuda"].level(name), levels["cpu"].level(name)
        assert torch.equal(card.indices.cpu(), cpu.indices), name
        assert torch.equal(card.compressed.cpu(), cpu.compressed), name
        assert torch.equal(card.frozen_mask.cpu(), cpu.frozen_mask), name
        torch.testing.assert_close(card.frozen_val.cpu(), cpu.frozen_val, rtol=1e-6, atol=1e-7)


def _tiny_artifact(seed=3):
    """A TINY prior from ``seed`` with the port's own grouping (no JAX here)."""
    from recombiner_tpu_torch.io.checkpoint import LevelArtifact, PriorArtifact
    from recombiner_tpu_torch.priors.grouping import compute_grouping

    cfg = TINY
    rng = np.random.default_rng(seed)
    D = cfg.n_coded_params
    level = LevelArtifact(p_loc=rng.normal(0, 0.02, D).astype(np.float32),
                          p_scale=rng.uniform(0.005, 0.05, D).astype(np.float32),
                          avg_log_scale=rng.normal(-4, 0.1, D).astype(np.float32),
                          grouping=compute_grouping(rng.exponential(0.5, D), cfg.bits_per_group))
    A = [rng.uniform(-0.1, 0.1, (d, d)).astype(np.float32) for d in cfg.layer_param_counts]
    up = {}
    for i, (cin, cout, k) in enumerate([(128, 64, 5), (64, 64, 3), (64, 16, 3)]):
        b = 1 / np.sqrt(cin * k * k)
        up[f"conv{i}"] = {"w": rng.uniform(-b, b, (k, k, cin, cout)).astype(np.float32),
                          "b": rng.uniform(-b, b, cout).astype(np.float32)}
    return PriorArtifact(config=cfg, kl_beta=1e-3, w=level, h=None, hh=None, A=A, up=up)


def _tiny_data(R):
    from recombiner_tpu_torch.coords import grid_fourier_features

    cfg = TINY
    X = torch.from_numpy(grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim))
    rng = np.random.default_rng(4)
    Y = torch.from_numpy(rng.uniform(0.1, 0.9, (R, cfg.n_pixels, 3)).astype(np.float32))
    return X.expand(R, *X.shape), Y


def test_adaptive_encode_on_card_decodes_to_its_reconstruction(cuda):
    """A TINY encode on the adaptive preset's knobs (depth cut) through both
    kernels on the card: its indices decode on the card to exactly
    compress's reconstruction, and on the CPU within TOL."""
    from recombiner_tpu_torch.coding.progressive import compress

    art = _tiny_artifact()
    R = 4
    X, Y = _tiny_data(R)
    codec, state = init_codec(art, R)
    before = dict(fused_inr.launches)
    res = compress(codec, state, X, Y, TINY, torch.Generator(device=cuda).manual_seed(0),
                   n_optimize_epochs=40, sample_size=5, phase1_lr=(6e-4, 2e-5),
                   phase1_sample_size=3, phase1_stop=(5, 2e-3, 10), finetune_stop=(2, 1e-3, 2),
                   fused_steps=8, finetune_overrides={"w": 6})
    assert fused_inr.launches["siren_bwd"] - before["siren_bwd"] == (
        res.timings["phase1_epochs"] + res.timings["finetune_epochs"])
    assert res.state.w.compressed.all()
    y = decode(codec, res.indices, X, TINY)
    assert torch.equal(y.cpu(), torch.from_numpy(res.reconstruction))
    y_cpu = decode(init_codec(art, R, device="cpu")[0], res.indices, X, TINY)
    torch.testing.assert_close(y.cpu(), y_cpu, **TOL)


def test_snapshot_written_on_card_loads_on_cpu(cuda, tmp_path):
    """An encode snapshot of a card state loads on the CPU with equal arrays;
    its generator state is the card generator's, offered only to a card
    generator."""
    from recombiner_tpu_torch.coding.encoder import optimize
    from recombiner_tpu_torch.io import encode_state

    art = _tiny_artifact()
    X, Y = _tiny_data(2)
    codec, state = init_codec(art, 2)
    gen = torch.Generator(device=cuda).manual_seed(1)
    state, opt = optimize(codec, state, X.to(cuda), Y.to(cuda), TINY, gen, n_epochs=3,
                          sample_size=2, return_opt_state=True)
    state = encode_step(codec, state)
    path = str(tmp_path / "state.npz")
    encode_state.save_encode_state(
        path, state, extra={encode_state.GENERATOR_FIELD: encode_state.generator_record(gen)},
        opt_leaves=opt.leaves(scheduled=False))
    cpu, header, leaves = encode_state.load_encode_state_full(path, device="cpu")
    for f in ("frozen_mask", "frozen_val", "kl_beta", "compressed", "indices"):
        assert torch.equal(getattr(cpu.w, f), getattr(state.w, f).cpu()), f
    assert torch.equal(cpu.w.q.loc, state.w.q.loc.cpu())
    assert torch.equal(cpu.w.q.log_scale, state.w.q.log_scale.cpu())
    assert encode_state.generator_state(header, "cpu") is None
    assert torch.equal(encode_state.generator_state(header, "cuda"), gen.get_state())
    assert np.array_equal(leaves[1], opt.mu[0].cpu().numpy()) and int(leaves[0]) == 3


@pytest.mark.parametrize("name,B", [("video", 320), ("video", 64), ("video", 2), ("audio", 300),
                                    ("audio", 60), ("audio", 2)])
def test_backward_kernel_at_the_other_modalities_shapes(cuda, name, B):
    """An S = 5 epoch of one video clip launches B = 320 samples of widths
    34-32-32-32-3 at P = 6,144 (its decode B = 64); one audio clip B = 300
    of 32-32-32-32-1 at P = 800 (its decode B = 60): each on its own
    fixed-width instance of both kernels (video's 34-wide rows as 8-byte
    copies, audio's 1-wide output as scalars); siren_bwd over 24 and 4
    pixel tiles, two launches bitwise equal; siren_fwd at the same shapes."""
    from recombiner_tpu_torch.config import AUDIO, VIDEO

    cfg = {"video": VIDEO, "audio": AUDIO}[name]
    want_inst = fused_inr.FIXED_WIDTHS.index(tuple(cfg.net_dims)) + 1
    assert fused_inr.instance(cfg.net_dims) == want_inst
    for kernel in ("siren_fwd", "siren_bwd"):
        assert fused_inr.launch_plan(kernel, cfg.net_dims, B, cfg.n_pixels)["instance"] == want_inst
    x, theta = _inputs(cfg, B, cfg.n_pixels, cuda)
    y = fused_inr.siren_forward(x, theta, cfg.net_dims, cfg.w0)
    torch.testing.assert_close(y, fused_inr.siren_forward_reference(x, theta, cfg.net_dims,
                                                                    cfg.w0), **TOL)
    dy = torch.randn(B, cfg.n_pixels, cfg.output_dim, device=cuda)
    dx, dtheta = fused_inr.siren_backward(x, theta, dy, cfg.net_dims, cfg.w0)
    again = fused_inr.siren_backward(x, theta, dy, cfg.net_dims, cfg.w0)
    assert torch.equal(dx, again[0]) and torch.equal(dtheta, again[1])
    want_dx, want_dtheta = fused_inr.siren_backward_reference(x, theta, dy, cfg.net_dims, cfg.w0)
    _assert_close_of_max(dx, want_dx, "dx")
    _assert_close_of_max(dtheta, want_dtheta, "dtheta")


def test_forward_spreads_a_small_launch_over_the_card(cuda):
    """Audio's decode (B = 60 samples of P = 800) would be 60 blocks of 800
    pixels on the card's 132 SMs: siren_fwd cuts each sample into chunks of
    whole 64-pixel steps so that its blocks fill one wave of resident
    slots; CIFAR's B = 500 keeps one block a sample."""
    from recombiner_tpu_torch.config import AUDIO

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = fused_inr.launch_plan("siren_fwd", AUDIO.net_dims, 60, AUDIO.n_pixels)
    assert plan["pixels_per_block"] % 64 == 0 and plan["pixels_per_block"] < AUDIO.n_pixels
    assert 60 < plan["blocks"] <= sms * plan["blocks_per_sm"]
    cifar = fused_inr.launch_plan("siren_fwd", CIFAR.net_dims, 500, CIFAR.n_pixels)
    assert (cifar["pixels_per_block"], cifar["blocks"]) == (1024, 500)


@pytest.mark.parametrize("kernel", ["siren_fwd", "siren_bwd"])
def test_kernels_refuse_a_launch_that_names_another_instance(cuda, kernel):
    """The C entry points check the instance the wrapper names against their
    own table and launch nothing when they differ (cudaErrorInvalidValue)."""
    import ctypes

    dims = list(CIFAR.net_dims)
    x, theta = _inputs(CIFAR, 2, 64, cuda)
    dims_c = ctypes.cast((ctypes.c_int * 5)(*dims), ctypes.c_void_p)
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(fused_inr.kernel_lib(kernel), kernel)
    y = torch.full((2, 64, 3), 7.0, device=cuda)
    for inst in (0, 2, 3):
        if kernel == "siren_fwd":
            rc = fn(x.data_ptr(), theta.data_ptr(), y.data_ptr(), 2, 64, 4, dims_c,
                    theta.shape[1], 30.0, 1, inst, stream)
        else:
            dy, dx, dt = torch.zeros_like(y), torch.empty_like(x), torch.empty_like(theta)
            rc = fn(x.data_ptr(), theta.data_ptr(), dy.data_ptr(), dx.data_ptr(), dt.data_ptr(),
                    2, 64, 4, dims_c, theta.shape[1], 30.0, inst, stream)
        assert rc != 0, inst
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())


@pytest.mark.parametrize("factors,canvas", [(((6, 4, 4), 2, 2), (2, 1, 8, 8)),
                                            (((1, 2, 2), 2, 2), (3, 1, 2, 2))])
def test_3d_phase_stack_matches_plain_stack_on_card(cuda, factors, canvas):
    """The 3-D phase-decomposed conv stack (cuDNN 3-D convs and a
    depth-to-space by view and permute) against the plain stack on the card,
    video's whole stitched canvas included, at atol 1e-5 and rtol 1e-5;
    and against the plain stack on the CPU."""
    from recombiner_tpu_torch.models.upsample import apply_upsample, apply_upsample_phased

    g = torch.Generator().manual_seed(6)
    up = {}
    for i, (cin, cout, k) in enumerate([(128, 64, 5), (64, 64, 3), (64, 16, 3)]):
        b = 1 / np.sqrt(cin * k**3)
        up[f"conv{i}"] = {"w": (2 * torch.rand(cout, cin, k, k, k, generator=g) - 1) * b,
                          "b": (2 * torch.rand(cout, generator=g) - 1) * b}
    x = torch.randn(*canvas, 128, generator=g)
    args = (3, factors, (2, 1, 1))
    on_card = {k: {n: t.to(cuda) for n, t in v.items()} for k, v in up.items()}
    phase = apply_upsample_phased(on_card, x.to(cuda), *args)
    plain = apply_upsample(on_card, x.to(cuda), *args)
    torch.testing.assert_close(phase, plain, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(phase.cpu(), apply_upsample(up, x, *args), atol=1e-5, rtol=1e-5)


def _train_setup(name, R, dev):
    """A prior state of ``name`` with R rows on ``dev`` and on the CPU, its
    M-step priors, synthetic data and one epoch's noise, all from seeds."""
    from recombiner_tpu_torch.config import get_config
    from recombiner_tpu_torch.data.synthetic import synthetic_dataset
    from recombiner_tpu_torch.priors import trainer

    cfg = get_config(name)
    X, Y = (torch.from_numpy(a) for a in synthetic_dataset(cfg, R, seed=0))
    st = trainer.init_prior_state(cfg, X.shape[0], torch.Generator().manual_seed(0), "cpu")
    pr = trainer.m_step(st)
    noise = trainer.draw_noise(st, cfg, 1, torch.Generator().manual_seed(1))
    return cfg, trainer, (st, pr, X, Y, noise), (st.to(dev), pr.to(dev), X.to(dev), Y.to(dev),
                                                 [n.to(dev) for n in noise])


@pytest.mark.parametrize("name,R", [("tiny", 2), ("cifar", 8)])
def test_training_epoch_on_card_matches_cpu(cuda, name, R):
    """One sgd_epochs epoch from one state and one noise draw, on the card
    (through both kernels) and on the CPU (their plain versions): the mse
    and KL at rtol 1e-4, every leaf within the CPU tests' trained-state
    bound (1e-6 of its norm plus 1e-2 of the norm of the change, every
    element within 2 lr: tests/test_torch_trainer.py::_state_close)."""
    cfg, trainer, cpu, card = _train_setup(name, R, cuda)
    lr = 2e-4
    outs = []
    for st, pr, X, Y, noise in (cpu, card):
        before = dict(fused_inr.launches)
        outs.append(trainer.sgd_epochs(st, X, Y, pr, 1e-3, lambda: noise, cfg=cfg, n_epochs=1,
                                       lr=lr))
    assert fused_inr.launches["siren_bwd"] == before["siren_bwd"] + 1
    (s_cpu, m_cpu), (s_card, m_card) = outs
    assert m_card.mse.item() == pytest.approx(m_cpu.mse.item(), rel=1e-4)
    assert m_card.kl.item() == pytest.approx(m_cpu.kl.item(), rel=1e-4)
    for g, w, w0 in zip(s_card.leaves(), s_cpu.leaves(), cpu[0].leaves(), strict=True):
        g, w, w0 = g.cpu().double(), w.double(), w0.double()
        assert (g - w).norm() <= 1e-6 * w.norm() + 1e-2 * (w - w0).norm()
        assert (g - w).abs().max() <= 1e-6 * w.abs().max() + 2 * lr


def test_training_gradients_of_a_and_the_conv_stack_match_the_plain_chain(cuda, monkeypatch):
    """The training loss's gradients with respect to every A matrix and every
    conv weight and bias at CIFAR, R = 8: the SIREN chain through SirenMLP
    (siren_fwd, siren_bwd) against autograd of the plain chain
    (``models.inr.inr_forward``) on the card, at BWD_OF_MAX of the largest
    entry."""
    cfg, trainer, _, (st, pr, X, Y, noise) = _train_setup("cifar", 8, cuda)
    grads = []
    for fwd in (fused_inr.inr_forward_fused, inr_forward):
        monkeypatch.setattr(trainer, "inr_forward_fused", fwd)
        leaves = [t.clone().requires_grad_() for t in st.leaves()]
        s = st.with_leaves(leaves)
        y = trainer.forward(s, X, cfg, noise=noise)[:, 0]
        loss = torch.mean((y - Y) ** 2) * 8 + 1e-3 * trainer.total_kl(s, pr)
        grads.append(torch.autograd.grad(loss, leaves)[2 * len(st.posteriors()):])
    for k, (got, want) in enumerate(zip(*grads, strict=True)):
        _assert_close_of_max(got, want, f"mapping leaf {k}")


def _f64_gap(got, a, b, fn):
    want = fn(a.double(), b.double())
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def test_precision_scopes_set_tf32_on_the_card(cuda):
    """``device.precision``'s two levels on the card: under 'high' (and under
    None with the ambient TF32) cuBLAS and cuDNN run f32 products as TF32,
    more than 10 times further from an f64 evaluation than under 'highest',
    which is exact f32; the flags are restored after each scope."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(512, 512, generator=g, device=cuda)
    b = torch.randn(512, 512, generator=g, device=cuda)
    x = torch.randn(8, 64, 32, 32, generator=g, device=cuda)
    w = torch.randn(64, 64, 3, 3, generator=g, device=cuda)

    def gaps(scope):
        with scope:
            return (_f64_gap(a @ b, a, b, torch.matmul),
                    _f64_gap(torch.nn.functional.conv2d(x, w, padding=1), x, w,
                             lambda u, v: torch.nn.functional.conv2d(u, v, padding=1)))

    exact = gaps(device.precision("highest"))
    tf32 = gaps(device.precision("high"))
    with platform.ambient("high"):
        ambient = gaps(device.precision())
    assert exact[0] < 1e-5 and exact[1] < 1e-5, exact
    for got in (tf32, ambient):
        assert got[0] > 10 * exact[0] and got[1] > 10 * exact[1], (got, exact)
    assert not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)


def test_decode_runs_on_deterministic_algorithms_on_the_card(cuda, monkeypatch):
    """``decode`` runs its render with cuDNN restricted to deterministic
    algorithms and TF32 off, whatever the ambient and the caller's flags,
    restores them after, and two decodes are bitwise equal."""
    from chip_smoke import make_cifar_artifact
    from recombiner_tpu_torch.coding import decoder
    from recombiner_tpu_torch.coords import grid_fourier_features

    seen = []
    predict = decoder.predict

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return predict(*a, **kw)

    monkeypatch.setattr(decoder, "predict", spy)
    art = make_cifar_artifact(1)
    cfg = art.config
    R = 16
    idx = {"w": np.random.default_rng(2).integers(0, 2**16, (R, art.w.grouping.n_groups))}
    feats = torch.from_numpy(grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim))
    X = feats.expand(R, *feats.shape).to(cuda)
    codec = init_codec(art, R)[0]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    with platform.ambient("high"), device.precision("high"):
        ys = [decode(codec, idx, X, cfg) for _ in range(2)]
        after = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    assert seen == [(True, False, False)] * 2
    assert after == (False, True)
    assert torch.equal(ys[0], ys[1])
