"""Latent-PE -> INR-input mapping and latent sampling, non-patch path of
``recombiner_tpu/models/mappings.py:23-66,130-146``."""

from __future__ import annotations

import torch

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.models.upsample import apply_upsample_phased


def _no_patch(cfg: ModalityConfig) -> None:
    if cfg.patch:
        raise NotImplementedError(
            f"config {cfg.name!r} is a patch config; the port covers the non-patch "
            "path only (ROADMAP.md, port queue: patch / kodak_mini)"
        )


# The conv stack lpe_to_pe runs: the phase-decomposed one, as in the JAX
# package. On the card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, phase
# "conv stacks", PERF.md section 5) an S = 5 CIFAR epoch at R = 500 takes
# 18.2-18.4 ms with it and 23.2-23.4 ms with the plain stack, a decode
# 2.2-2.8 against 2.9-4.2 ms. The plain stack stays beside it, held to it by
# the tests and the smoke.
STACK = apply_upsample_phased


def lpe_to_pe(upsample_params, lpe: torch.Tensor, cfg: ModalityConfig) -> torch.Tensor:
    """(R, S, *lpe_spatial, latent_dim) -> (R, S, n_pixels, upsample_out)."""
    _no_patch(cfg)
    R, S = lpe.shape[0], lpe.shape[1]
    x = lpe.reshape(R * S, *cfg.lpe_spatial, cfg.latent_dim)
    pe = STACK(upsample_params, x, cfg.data_dim, cfg.layerwise_scale_factors, cfg.paddings)
    return pe.reshape(R, S, cfg.n_pixels, cfg.upsample_out)


def sample_hierarchical_latents(
    loc: torch.Tensor, scale: torch.Tensor, eps: torch.Tensor, cfg: ModalityConfig
) -> torch.Tensor:
    """Reparameterised sample of the INR weight latents, one level.

    loc/scale: (R, D); eps: (R, S, D) standard-normal noise, passed in so the
    caller owns the generator. Returns (R, S, D)."""
    _no_patch(cfg)
    return loc[:, None, :] + scale[:, None, :] * eps
