"""Carry artifacts, codec states, prior-training states and codebooks
between the JAX package and the port. Into the port, everything arrives as
numpy (``np.asarray`` of a JAX array, or an array read from disk); out of
it, a codec state leaves as numpy arrays in the JAX package's dtypes
(``level_arrays``), which the JAX package's ``LevelState`` takes and its
snapshots store, and a prior-training state as numpy leaves in
``jax.tree_util`` order (``prior_state_leaves``), which
``jax.tree_util.tree_unflatten`` and the train-state files take. Nothing
here imports JAX."""

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


def conv_weight_from_torch(w: np.ndarray) -> np.ndarray:
    """Inverse of ``conv_weight_to_torch``: (O, I, *k) -> (*k, I, O)."""
    d = w.ndim - 2
    return np.ascontiguousarray(np.transpose(w, (*range(2, 2 + d), 1, 0)))


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


def _state_layout(cfg, train_size: int):
    """(name, shape) of each leaf of a JAX ``PriorState`` of ``cfg`` with
    ``train_size`` rows, in ``jax.tree_util`` order (None dropped, dict keys
    sorted), conv weights in the JAX layout (*k, I, O); and of its
    ``Priors``."""
    D = cfg.n_inr_params
    lpe = (*cfg.lpe_spatial, cfg.latent_dim)
    levels = [("w", (train_size, D)), ("lpe", (train_size, *lpe))]
    if cfg.patch:
        levels += [("h", (cfg.rows_level2(train_size), D)), ("hh", (cfg.rows_level3(train_size), D))]
    state = [(f"{n}.{f}", shape) for n, shape in levels for f in ("loc", "log_scale")]
    state += [(f"A.{i}", (d, d)) for i, d in enumerate(cfg.layer_param_counts)]
    chans = [(cfg.latent_dim, cfg.upsample_hidden), (cfg.upsample_hidden, cfg.upsample_hidden),
             (cfg.upsample_hidden, cfg.upsample_out)]
    for i, ((cin, cout), k) in enumerate(zip(chans, (5, 3, 3))):
        state += [(f"up.conv{i}.b", (cout,)), (f"up.conv{i}.w", (k,) * cfg.data_dim + (cin, cout))]
    priors = [(f"{n}.{f}", shape[1:]) for n, shape in levels for f in ("loc", "scale")]
    return state, priors


def prior_state_from(state_leaves, priors_leaves, cfg, device: DeviceLike = None):
    """A JAX ``PriorState`` and ``Priors`` as their leaves
    (``jax.tree_util.tree_leaves``, or a train-state file's ``state/i`` and
    ``priors/i``), each a numpy array -> the port's (``PriorState``,
    ``Priors``) on ``device``. Every shape is checked against ``cfg``."""
    from recombiner_tpu_torch.models.gaussian import Gaussian, NaturalGaussian
    from recombiner_tpu_torch.priors.trainer import Priors, PriorState

    dev = resolve_device(device)
    layout = _state_layout(cfg, int(np.asarray(state_leaves[0]).shape[0]))
    st, pr = {}, {}
    for part, leaves, out in zip(layout, (state_leaves, priors_leaves), (st, pr)):
        if len(leaves) != len(part):
            raise ValueError(f"{len(leaves)} leaves; a {cfg.name} state has {len(part)}")
        for (name, shape), leaf in zip(part, leaves):
            a = np.asarray(leaf, np.float32)
            if a.shape != tuple(shape):
                raise ValueError(f"{name}: shape {a.shape}, {cfg.name} wants {tuple(shape)}")
            if name.startswith("up.") and name.endswith(".w"):
                a = conv_weight_to_torch(a)
            out[name] = torch.tensor(np.ascontiguousarray(a), device=dev)
    levels = ("w", "lpe", "h", "hh")
    state = PriorState(
        A=tuple(st[f"A.{i}"] for i in range(cfg.n_layers)),
        up={f"conv{i}": {"w": st[f"up.conv{i}.w"], "b": st[f"up.conv{i}.b"]} for i in range(3)},
        **{n: Gaussian(st[f"{n}.loc"], st[f"{n}.log_scale"]) if f"{n}.loc" in st else None
           for n in levels})
    priors = Priors(**{n: NaturalGaussian(pr[f"{n}.loc"], pr[f"{n}.scale"])
                       if f"{n}.loc" in pr else None for n in levels})
    return state, priors


def prior_state_leaves(state, priors=None) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Inverse of ``prior_state_from``: the port's state and priors -> numpy
    leaves in ``jax.tree_util`` order, conv weights in the JAX layout (no
    priors' leaves without ``priors``)."""
    def np_(t):
        return t.detach().cpu().numpy()

    st = [np_(t) for g in state.posteriors() for t in (g.loc, g.log_scale)]
    st += [np_(a) for a in state.A]
    for c in sorted(state.up):
        st += [np_(state.up[c]["b"]), conv_weight_from_torch(np_(state.up[c]["w"]))]
    return st, [] if priors is None else [np_(t) for t in priors.leaves()]
