"""Block-diagonal sample packing for the INR forward: the port's copy of
``recombiner_tpu/ops/blocked_inr.py``, in plain torch.

Four samples' layer matrices go into one block-diagonal matrix, so that one
product computes four samples' layer at once:

    [x1 x2 x3 x4] @ blockdiag(W1, W2, W3, W4) = [x1W1 x2W2 x3W3 x4W4]

The concatenated layout is closed under the layer loop (sine is
elementwise), so the whole network runs packed and is unpacked at the end.
The JAX module is XLA, not Pallas (it fills a TPU's 128-wide MXU tile), so
here the products are ``torch.bmm``: a library product, autograd through
it. Numbers equal ``models.inr.inr_forward``'s up to f32 summation order.
Opt-in and on no path, as in the JAX package: nothing imports it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.models.inr import inr_forward, latent_to_weights, slice_layer

BLOCK = 4  # 4 x 32 = 128, the TPU's MXU tile


def _block_diag(w: torch.Tensor) -> torch.Tensor:
    """(G, BLOCK, i, o) -> (G, BLOCK*i, BLOCK*o) block-diagonal."""
    G, B, i, o = w.shape
    out = w.new_zeros(G, B, i, B, o)
    idx = torch.arange(B, device=w.device)
    out[:, idx, :, idx, :] = w.transpose(0, 1)
    return out.reshape(G, B * i, B * o)


def inr_forward_blocked(x: torch.Tensor, h_w: torch.Tensor, A: Sequence[torch.Tensor],
                        cfg: ModalityConfig) -> torch.Tensor:
    """Drop-in replacement for ``models.inr.inr_forward`` (same signature and
    layout): x (R, S, P, in), h_w (R, S, D) -> (R, S, P, out). Runs
    ``inr_forward`` when R * S is not a multiple of BLOCK."""
    R, S, P, Fin = x.shape
    Bn = R * S
    if Bn % BLOCK != 0:
        return inr_forward(x, h_w, A, cfg)
    G = Bn // BLOCK
    dims = cfg.net_dims
    cum = cfg.cum_param_sizes

    lat_flat = h_w.reshape(Bn, -1)
    # pack activations: (Bn, P, in) -> (G, P, BLOCK * in)
    xb = x.reshape(G, BLOCK, P, Fin).transpose(1, 2).reshape(G, P, BLOCK * Fin)
    for idx in range(cfg.n_layers):
        i_dim, o_dim = dims[idx], dims[idx + 1]
        lat = slice_layer(lat_flat, idx, cum) @ A[idx]
        w, b = latent_to_weights(lat, i_dim, o_dim)  # (Bn, i, o), (Bn, o)
        wb = _block_diag(w.reshape(G, BLOCK, i_dim, o_dim))  # (G, B*i, B*o)
        xb = torch.bmm(xb, wb) + b.reshape(G, 1, BLOCK * o_dim)
        if idx != cfg.n_layers - 1:
            xb = torch.sin(cfg.w0 * xb)
    out_dim = dims[-1]
    return xb.reshape(G, P, BLOCK, out_dim).transpose(1, 2).reshape(R, S, P, out_dim)
