"""Coordinate grids, Fourier features and patch splitting, a copy of the
part of ``recombiner_tpu/coords.py`` that the port needs. Numpy,
channel-last."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def make_coord_grid(shape: Sequence[int], lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Centred coordinate grid in [lo, hi]: per-axis (0.5 + arange(s)) / s
    mapped to the range, meshed 'ij', stacked channel-last; (*shape, d) f32."""
    axes = []
    for s in shape:
        l = (0.5 + np.arange(s, dtype=np.float64)) / s
        axes.append(lo + (hi - lo) * l)
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack(mesh, axis=-1).astype(np.float32)


def fourier_features(coords: np.ndarray, fourier_dim: int) -> np.ndarray:
    """[cos(pi x w), sin(pi x w)] with w = exp(linspace(0, log 1024, F)),
    F = fourier_dim // (2 * data_dim); (..., fourier_dim) f32."""
    data_dim = coords.shape[-1]
    n_freq = fourier_dim // (2 * data_dim)
    w = np.exp(np.linspace(0.0, np.log(1024.0), n_freq)).astype(np.float64)
    xw = coords[..., None].astype(np.float64) * w
    xw = xw.reshape(*coords.shape[:-1], data_dim * n_freq)
    feats = np.concatenate([np.cos(np.pi * xw), np.sin(np.pi * xw)], axis=-1)
    return feats.astype(np.float32)


def grid_fourier_features(shape: Sequence[int], fourier_dim: int) -> np.ndarray:
    """Fourier features for a full flattened grid: (prod(shape), fourier_dim)."""
    coords = make_coord_grid(shape).reshape(-1, len(shape))
    return fourier_features(coords, fourier_dim)


def patchify(datum: np.ndarray, patch_sizes: Sequence[int]) -> np.ndarray:
    """Split a channel-last datum (*spatial, C) into non-overlapping patches,
    row-major over the patch grid: (prod(patch_nums), *patch_sizes, C)."""
    spatial = datum.shape[:-1]
    d = len(spatial)
    c = datum.shape[-1]
    patch_nums = [spatial[i] // patch_sizes[i] for i in range(d)]
    interleaved = []
    for i in range(d):
        interleaved += [patch_nums[i], patch_sizes[i]]
    x = datum[tuple(slice(0, patch_nums[i] * patch_sizes[i]) for i in range(d))]
    x = x.reshape(*interleaved, c)
    perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)] + [2 * d]
    return np.transpose(x, perm).reshape(int(np.prod(patch_nums)), *patch_sizes, c)


def unpatchify(patches: np.ndarray, patch_nums: Sequence[int]) -> np.ndarray:
    """Inverse of ``patchify``: (prod(patch_nums), *patch_sizes, C) -> (*spatial, C)."""
    d = len(patch_nums)
    c = patches.shape[-1]
    patch_sizes = patches.shape[1 : 1 + d]
    x = patches.reshape(*patch_nums, *patch_sizes, c)
    perm = []
    for i in range(d):
        perm += [i, d + i]
    x = np.transpose(x, perm + [2 * d])
    return x.reshape(*[patch_nums[i] * patch_sizes[i] for i in range(d)], c)
