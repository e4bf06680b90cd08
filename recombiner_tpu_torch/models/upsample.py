"""Latent positional-encoding upsampler on cuDNN, in two exact forms: the
plain stack of ``recombiner_tpu/models/upsample.py:68-108``
(``apply_upsample``) and its phase-decomposed rewrite of
``recombiner_tpu/ops/phase_upsample.py`` (``apply_upsample_phased``).

Topology per layer i: nearest-upsample(scale_i) -> conv(k_i, pad_i) ->
leaky_relu(0.01), no activation after the last conv; kernels (5, 3, 3),
latent_dim -> 64 -> 64 -> 16. 1-D (audio, protein), 2-D (images) and 3-D
(video, with an anisotropic first factor such as (6, 4, 4)). The public
layout is the JAX package's channel-last (N, *spatial, C); inside, the
stack runs channel-first with (O, I, *k) weights
(``recombiner_tpu_torch/io/convert.py`` turns the artifact's (*k, I, O)
weights round). The tests hold both forms to both JAX versions;
``mappings`` calls one of them. Both are differentiable in the input and
in every weight and bias, as prior training needs
(``init_upsample_params`` draws the initial ones).
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

ScaleFactor = Union[int, Tuple[int, ...]]
_KERNELS = (5, 3, 3)
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def init_upsample_params(data_dim: int, latent_dim: int = 128, hidden: int = 64,
                         out: int = 16, generator: Optional[torch.Generator] = None,
                         device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The stack's initial parameters, {conv{i}: {w (O, I, *k), b}}: weights
    and biases U(-sqrt(k), sqrt(k)) with k = 1 / (fan_in * prod(kernel)), the
    distribution of ``recombiner_tpu/models/upsample.py:38-61`` (torch's
    conv default)."""
    chans = [(latent_dim, hidden), (hidden, hidden), (hidden, out)]
    params = {}
    for i, ((cin, cout), k) in enumerate(zip(chans, _KERNELS)):
        bound = 1.0 / np.sqrt(cin * k**data_dim)
        w = torch.empty(cout, cin, *(k,) * data_dim, device=device)
        params[f"conv{i}"] = {
            "w": w.uniform_(-bound, bound, generator=generator),
            "b": torch.empty(cout, device=device).uniform_(-bound, bound, generator=generator),
        }
    return params


def _factors(f: ScaleFactor, d: int) -> Tuple[int, ...]:
    return (f,) * d if isinstance(f, int) else tuple(f)


def _conv(d: int):
    if d not in _CONV:
        raise ValueError(f"data_dim {d}: the upsampler is 1-, 2- or 3-D")
    return _CONV[d]


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, *range(2, x.dim()), 1)


def apply_upsample(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    data_dim: int,
    layerwise_scale_factors: Sequence[ScaleFactor],
    paddings: Sequence[int],
) -> torch.Tensor:
    """Map latent PEs (N, *lpe_spatial, latent_dim) -> (N, *pixel_sizes, out).

    ``params[f"conv{i}"]`` holds ``w`` as (O, I, *k) and ``b``."""
    conv = _conv(data_dim)
    x = _channels_first(x)
    for i in range(3):
        for axis, f in enumerate(_factors(layerwise_scale_factors[i], data_dim)):
            if f != 1:
                x = x.repeat_interleave(f, dim=2 + axis)
        x = conv(x, params[f"conv{i}"]["w"], params[f"conv{i}"]["b"], padding=int(paddings[i]))
        if i != 2:
            x = F.leaky_relu(x, negative_slope=0.01)
    return _channels_last(x)


@functools.lru_cache(maxsize=None)
def phase_kernel_matrix(
    k: int, factors: Tuple[int, ...], p: int
) -> Tuple[np.ndarray, Tuple[int, ...], Tuple[Tuple[int, int], ...]]:
    """The static 0/1 matrix M and geometry that turn one nearest-upsample(f)
    + conv(k, pad p) into a conv on the source grid
    (``recombiner_tpu/ops/phase_upsample.py:45-80``): output f*s + phi reads
    source s + tau through K'_phi[tau] = sum of the taps t with
    floor((phi - p + t) / f) = tau.

    Returns M (ext_prod * f_prod, k^d), rows (tau_flat * f_prod + phi_flat),
    columns the taps row-major; ext, the source kernel's extent per dim;
    pads, the source padding (lo, hi) per dim."""
    d = len(factors)
    taus_per_dim = [((0 - p) // f, (f - 1 - p + k - 1) // f) for f in factors]
    ext = tuple(hi - lo + 1 for lo, hi in taus_per_dim)
    f_prod = int(np.prod(factors))
    M = np.zeros((int(np.prod(ext)) * f_prod, k**d), np.float32)
    phis = list(itertools.product(*[range(f) for f in factors]))
    taps = list(itertools.product(*[range(k)] * d))
    for pi, phi in enumerate(phis):
        for ti, t in enumerate(taps):
            tau = tuple((phi[i] - p + t[i]) // factors[i] for i in range(d))
            tau_off = tuple(tau[i] - taus_per_dim[i][0] for i in range(d))
            M[int(np.ravel_multi_index(tau_off, ext)) * f_prod + pi, ti] = 1.0
    pads = tuple((-lo, hi) for lo, hi in taus_per_dim)
    return M, ext, pads


@functools.lru_cache(maxsize=None)
def _phase_matrix_on(k: int, factors: Tuple[int, ...], p: int,
                     device: torch.device) -> torch.Tensor:
    """``phase_kernel_matrix``'s M on ``device``, copied there once: a copy
    from host memory per call would stall the host until the device has
    caught up, three times per forward."""
    return torch.as_tensor(phase_kernel_matrix(k, factors, p)[0], device=device)


def _depth_to_space(y: torch.Tensor, factors: Tuple[int, ...]) -> torch.Tensor:
    """(N, cout * prod(f), *S) with channels cout-major, phase-minor (the
    phase row-major over the axes) -> (N, cout, *(S * f)): output position
    s * f + phi of each axis takes phase phi's channel at s. The result is
    contiguous channels-first whatever the layout of y."""
    d = len(factors)
    N, S = y.shape[0], y.shape[2:]
    cout = y.shape[1] // int(np.prod(factors))
    y = y.reshape(N, cout, *factors, *S)
    perm = [0, 1]
    for i in range(d):
        perm += [2 + d + i, 2 + i]
    return y.permute(*perm).reshape(N, cout, *(S[i] * factors[i] for i in range(d)))


def _phased_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int,
                  factors: Tuple[int, ...], p: int) -> torch.Tensor:
    """x (N, cin, *S) -> nearest-upsample(factors) + conv(k, pad p) + bias,
    as one conv on the source grid with prod(f) * cout output channels and
    a depth-to-space step. The phase kernel is M times the learned kernel
    (an f32 product, at the caller's precision on the card: exact under
    ``exact_f32``, TF32 at the ambient). Output channels are cout-major,
    phase-minor (the JAX rewrite orders them phase-major and transposes,
    ``phase_upsample.py:86-118``: the same interleave). The bias is
    broadcast over the phases with
    ``expand``, whose gradient is an ordered sum (``repeat_interleave``'s
    would be an ``index_add``, atomic on CUDA), so a training epoch
    repeats bit for bit."""
    d = len(factors)
    # a size-preserving conv (2p = k - 1) pads its source grid alike on both sides
    if 2 * p != k - 1:
        raise NotImplementedError(f"the phase stack takes size-preserving convs only "
                                  f"(k={k}, p={p})")
    _, ext, pads = phase_kernel_matrix(k, factors, p)
    f_prod = int(np.prod(factors))
    cout, cin = w.shape[:2]
    taps = w.permute(*range(2, 2 + d), 1, 0).reshape(k**d, cin * cout)  # taps row-major
    kp = _phase_matrix_on(k, factors, p, w.device).to(taps.dtype) @ taps  # (ext f, cin*cout)
    kp = kp.reshape(*ext, f_prod, cin, cout).permute(d + 2, d, d + 1, *range(d))
    kp = kp.reshape(cout * f_prod, cin, *ext)
    bias = b[:, None].expand(cout, f_prod).reshape(cout * f_prod)
    y = _conv(d)(x, kp, bias, padding=tuple(lo for lo, _ in pads))
    if d == 2 and factors[0] == factors[1]:
        # the same values as _depth_to_space, but in the conv's channels-last
        # strides, which the next conv's algorithm and rounding depend on
        return F.pixel_shuffle(y, factors[0])
    return _depth_to_space(y, factors)


def apply_upsample_phased(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    data_dim: int,
    layerwise_scale_factors: Sequence[ScaleFactor],
    paddings: Sequence[int],
) -> torch.Tensor:
    """``apply_upsample`` computed as phase convs on each layer's source
    grid: the nearest-upsampled grids are never built, and conv0 does
    (k / ext)^d fewer multiply-adds."""
    _conv(data_dim)
    x = _channels_first(x)
    for i in range(3):
        x = _phased_layer(x, params[f"conv{i}"]["w"], params[f"conv{i}"]["b"], _KERNELS[i],
                          _factors(layerwise_scale_factors[i], data_dim), int(paddings[i]))
        if i != 2:
            x = F.leaky_relu(x, negative_slope=0.01)
    return _channels_last(x)
