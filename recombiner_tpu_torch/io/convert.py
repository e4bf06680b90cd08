"""Carry artifacts, codec states and codebooks between the JAX package and
the port. Into the port, everything arrives as numpy (``np.asarray`` of a
JAX array, or an array read from disk); out of it, a codec state leaves as
numpy arrays in the JAX package's dtypes (``level_arrays``), which the JAX
package's ``LevelState`` takes and its snapshots store. Nothing here
imports JAX."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from recombiner_tpu_torch.device import DeviceLike, resolve_device


def conv_weight_to_torch(w: np.ndarray) -> np.ndarray:
    """A conv weight of the JAX package's layout, (*k, I, O) for a 1-, 2- or
    3-D kernel (WIO, HWIO, DHWIO), -> torch's (O, I, *k)."""
    d = w.ndim - 2
    return np.transpose(w, (d + 1, d, *range(d)))


def torch_params_from_artifact(art, device: DeviceLike = None) -> Tuple[List[torch.Tensor], Dict]:
    """(A, up) of a prior artifact -> tensors on ``device``.

    ``art`` is anything with ``A`` (a list of (d, d) arrays) and ``up``
    ({conv{i}: {w: (*k, I, O), b}}, k one to three axes) as numpy: a loaded
    artifact of either package, or parameters a JAX test built and passed
    through ``np.asarray``. Conv weights go to torch's (O, I, *k)
    (``conv_weight_to_torch``)."""
    dev = resolve_device(device)
    A = [torch.tensor(np.asarray(a, np.float32), device=dev) for a in art.A]
    up = {}
    for name, conv in art.up.items():
        w = np.asarray(conv["w"], np.float32)
        up[name] = {
            "w": torch.tensor(conv_weight_to_torch(w), device=dev).contiguous(),
            "b": torch.tensor(np.asarray(conv["b"], np.float32), device=dev),
        }
    return A, up


def level_state_from(ls, device: DeviceLike = None):
    """A level state of either package (``q.loc``, ``q.log_scale``,
    ``frozen_mask``, ``frozen_val``, ``kl_beta``, ``compressed``,
    ``indices``) -> the port's ``LevelState`` on ``device``."""
    from recombiner_tpu_torch.coding.decoder import LevelState
    from recombiner_tpu_torch.models.gaussian import Gaussian

    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return LevelState(
        q=Gaussian(loc=f32(ls.q.loc), log_scale=f32(ls.q.log_scale)),
        frozen_mask=f32(ls.frozen_mask),
        frozen_val=f32(ls.frozen_val),
        kl_beta=f32(ls.kl_beta),
        compressed=torch.tensor(np.asarray(ls.compressed, bool), device=dev),
        indices=torch.tensor(np.asarray(ls.indices, np.int64), device=dev),
    )


def codec_state_from(state, device: DeviceLike = None):
    """A codec state of either package (levels w, and h and hh for a patch
    config) -> the port's ``CodecState``."""
    from recombiner_tpu_torch.coding.decoder import LEVELS, CodecState

    return CodecState(**{name: level_state_from(getattr(state, name), device)
                         for name in LEVELS if getattr(state, name) is not None})


# the dtypes the JAX package holds (and its snapshots store) a level in
LEVEL_DTYPES = {"loc": np.float32, "log_scale": np.float32, "frozen_mask": np.float32,
                "frozen_val": np.float32, "kl_beta": np.float32, "compressed": np.bool_,
                "indices": np.int32}


def level_arrays(ls) -> Dict[str, np.ndarray]:
    """The port's ``LevelState`` -> numpy arrays named and typed as the JAX
    package's (``LEVEL_DTYPES``)."""
    fields = {"loc": ls.q.loc, "log_scale": ls.q.log_scale,
              **{f: getattr(ls, f) for f in list(LEVEL_DTYPES)[2:]}}
    return {f: t.detach().cpu().numpy().astype(LEVEL_DTYPES[f]) for f, t in fields.items()}


def with_codebook(codec, meta, level: str = "w"):
    """``codec`` with ``level``'s codebook (``eps``) and Gumbel chain taken
    from ``meta`` (a level meta of either package), so both packages code
    against identical samples."""
    own = getattr(codec, level)
    dev = own.eps.device
    eps = torch.tensor(np.asarray(meta.eps, np.float32), device=dev)
    gumbel = torch.tensor(np.asarray(meta.gumbel, np.float32), device=dev)
    if eps.shape != own.eps.shape or gumbel.shape != own.gumbel.shape:
        raise ValueError(f"codebook {tuple(eps.shape)} / {tuple(gumbel.shape)} does not "
                         f"match {tuple(own.eps.shape)} / {tuple(own.gumbel.shape)}")
    return dataclasses.replace(codec, **{level: dataclasses.replace(own, eps=eps,
                                                                    gumbel=gumbel)})
