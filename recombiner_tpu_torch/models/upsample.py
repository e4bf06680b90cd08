"""Latent positional-encoding upsampler on cuDNN, in two exact forms: the
plain stack of ``recombiner_tpu/models/upsample.py:68-108``
(``apply_upsample``) and its phase-decomposed rewrite of
``recombiner_tpu/ops/phase_upsample.py`` (``apply_upsample_phased``).

Topology per layer i: nearest-upsample(scale_i) -> conv(k_i, pad_i) ->
leaky_relu(0.01), no activation after the last conv; kernels (5, 3, 3),
latent_dim -> 64 -> 64 -> 16. The public layout is the JAX package's
channel-last (N, H, W, C); inside, the stack runs NCHW with OIHW weights
(``recombiner_tpu_torch/io/convert.py`` turns the artifact's HWIO weights
round). The tests hold both forms to both JAX versions; ``mappings``
calls one of them. 2-D only for now.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Sequence, Union, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ScaleFactor = Union[int, Tuple[int, ...]]
_KERNELS = (5, 3, 3)


def apply_upsample(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    data_dim: int,
    layerwise_scale_factors: Sequence[ScaleFactor],
    paddings: Sequence[int],
) -> torch.Tensor:
    """Map latent PEs (N, H, W, latent_dim) -> (N, H', W', out).

    ``params[f"conv{i}"]`` holds ``w`` in OIHW and ``b``."""
    if data_dim != 2:
        raise NotImplementedError(
            "the port's upsampler is 2-D only; 1-D and 3-D come with the audio, "
            "protein and video configs (ROADMAP.md, port queue)"
        )
    x = x.permute(0, 3, 1, 2)
    for i in range(3):
        f = layerwise_scale_factors[i]
        fh, fw = (f, f) if isinstance(f, int) else tuple(f)
        x = x.repeat_interleave(fh, dim=2).repeat_interleave(fw, dim=3)
        p = int(paddings[i])
        x = F.conv2d(x, params[f"conv{i}"]["w"], params[f"conv{i}"]["b"], padding=p)
        if i != 2:
            x = F.leaky_relu(x, negative_slope=0.01)
    return x.permute(0, 2, 3, 1)


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


def _phased_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int,
                  factors: Tuple[int, int], p: int) -> torch.Tensor:
    """x (N, cin, H, W) -> nearest-upsample(factors) + conv(k, pad p) + bias,
    as one conv on the source grid with f^2 * cout output channels and a
    depth-to-space step. The phase kernel is M times the learned kernel
    (an f32 product, which the caller's exact_f32 keeps exact on the
    card). Output channels are cout-major, phase-minor, which is
    ``F.pixel_shuffle``'s order (the JAX rewrite orders them phase-major
    and transposes, ``phase_upsample.py:86-118``: the same interleave)."""
    fh, fw = factors
    if fh != fw:
        raise NotImplementedError("the phase stack takes square upsampling factors only")
    # a size-preserving conv (2p = k - 1) pads its source grid alike on both sides
    if 2 * p != k - 1:
        raise NotImplementedError(f"the phase stack takes size-preserving convs only "
                                  f"(k={k}, p={p})")
    _, ext, pads = phase_kernel_matrix(k, (fh, fw), p)
    cout, cin = w.shape[:2]
    taps = w.permute(2, 3, 1, 0).reshape(k * k, cin * cout)  # (kh, kw) row-major
    kp = _phase_matrix_on(k, (fh, fw), p, w.device).to(taps.dtype) @ taps  # (ext^2 f^2, cin*cout)
    kp = kp.reshape(*ext, fh * fw, cin, cout).permute(4, 2, 3, 0, 1)
    kp = kp.reshape(cout * fh * fw, cin, *ext)
    y = F.conv2d(x, kp, b.repeat_interleave(fh * fw), padding=(pads[0][0], pads[1][0]))
    return F.pixel_shuffle(y, fh)


def apply_upsample_phased(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    data_dim: int,
    layerwise_scale_factors: Sequence[ScaleFactor],
    paddings: Sequence[int],
) -> torch.Tensor:
    """``apply_upsample`` computed as phase convs on each layer's source
    grid: the nearest-upsampled grids are never built, and conv0 does
    (k / ext)^2 fewer multiply-adds."""
    if data_dim != 2:
        raise NotImplementedError(
            "the port's upsampler is 2-D only; 1-D and 3-D come with the audio, "
            "protein and video configs (ROADMAP.md, port queue)"
        )
    x = x.permute(0, 3, 1, 2)
    for i in range(3):
        f = layerwise_scale_factors[i]
        factors = (f, f) if isinstance(f, int) else tuple(f)
        x = _phased_layer(x, params[f"conv{i}"]["w"], params[f"conv{i}"]["b"], _KERNELS[i],
                          factors, int(paddings[i]))
        if i != 2:
            x = F.leaky_relu(x, negative_slope=0.01)
    return x.permute(0, 2, 3, 1)
