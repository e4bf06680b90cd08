"""SIREN coordinate-INR forward with the learned linear reparameterisation:
the plain PyTorch version of ``recombiner_tpu/models/inr.py``.

Per layer: slice the weight latents, multiply by the learned square matrix
A_l, split into (W, b), apply x @ W + b, then sin(w0 x) on every layer but
the last. This is the reference that the CUDA kernel
(``recombiner_tpu_torch/ops/fused_inr.py``) is held to.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from recombiner_tpu_torch.config import ModalityConfig


def init_linear_transform(net_dims: Sequence[int], generator: Optional[torch.Generator] = None,
                          device=None) -> List[torch.Tensor]:
    """One learned square matrix per layer, (out * (in + 1),) squared, drawn
    U(-1/d, 1/d) as ``recombiner_tpu/models/inr.py:42-50`` draws them (other
    numbers from the same seed: the generators differ)."""
    mats = []
    for i in range(1, len(net_dims)):
        d = net_dims[i] * (net_dims[i - 1] + 1)
        mats.append(torch.empty(d, d, device=device).uniform_(-1.0 / d, 1.0 / d,
                                                              generator=generator))
    return mats


def slice_layer(latents: torch.Tensor, layer_idx: int, cum_sizes: Sequence[int]) -> torch.Tensor:
    """One layer's flattened params out of the full latent vector."""
    start = 0 if layer_idx == 0 else cum_sizes[layer_idx - 1]
    return latents[..., start : cum_sizes[layer_idx]]


def latent_to_weights(layer_param: torch.Tensor, in_dim: int, out_dim: int):
    """Split (..., out*(in+1)) into weights (..., in, out) and bias (..., out):
    the bias comes first in the packed vector."""
    bias = layer_param[..., :out_dim]
    weights = layer_param[..., out_dim:].reshape(*layer_param.shape[:-1], in_dim, out_dim)
    return weights, bias


def inr_forward(
    x: torch.Tensor, h_w: torch.Tensor, A: Sequence[torch.Tensor], cfg: ModalityConfig
) -> torch.Tensor:
    """x (R, S, P, input_dim), h_w (R, S, n_inr_params) -> (R, S, P, output_dim)."""
    dims = cfg.net_dims
    cum = cfg.cum_param_sizes
    for idx in range(cfg.n_layers):
        lat = slice_layer(h_w, idx, cum) @ A[idx]
        w, b = latent_to_weights(lat, dims[idx], dims[idx + 1])
        x = torch.einsum("rspi,rsio->rspo", x, w) + b[:, :, None, :]
        if idx != cfg.n_layers - 1:
            x = torch.sin(cfg.w0 * x)
    return x
