"""Posterior scale transform (``recombiner_tpu/models/gaussian.py:20-31``)
and its inverse, the diagonal Gaussian posterior it parameterises, the
naturally parameterised Gaussian of a prior, and the Gaussian KL."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

# sigma = softplus(raw) / 6. torch's softplus switches to the identity above
# its threshold of 20, where softplus(x) and x agree in f32.
SCALE_DIV = 6.0


def scale_transform(log_scale: torch.Tensor) -> torch.Tensor:
    return F.softplus(log_scale) / SCALE_DIV


def inverse_scale_transform(scale: torch.Tensor) -> torch.Tensor:
    """raw = log(exp(6 sigma) - 1), the inverse of ``scale_transform``, in the
    stable form 6 sigma + log1p(-exp(-6 sigma))."""
    s6 = SCALE_DIV * scale
    return s6 + torch.log1p(-torch.exp(-s6))


@dataclasses.dataclass
class Gaussian:
    """Diagonal Gaussian with raw (pre-softplus) scale parameterisation."""

    loc: torch.Tensor
    log_scale: torch.Tensor

    @property
    def scale(self) -> torch.Tensor:
        return scale_transform(self.log_scale)


@dataclasses.dataclass
class NaturalGaussian:
    """Diagonal Gaussian with direct (loc, scale) parameterisation: the
    priors, whose scale the M-step produces in closed form."""

    loc: torch.Tensor
    scale: torch.Tensor


def kl_gaussian(q_loc: torch.Tensor, q_scale: torch.Tensor, p_loc: torch.Tensor,
                p_scale: torch.Tensor) -> torch.Tensor:
    """Elementwise KL( N(q_loc, q_scale) || N(p_loc, p_scale) ) in nats
    (``recombiner_tpu/models/gaussian.py:60``)."""
    var_ratio = (q_scale / p_scale) ** 2
    t = ((q_loc - p_loc) / p_scale) ** 2
    return 0.5 * (var_ratio + t - 1.0 - torch.log(var_ratio))
