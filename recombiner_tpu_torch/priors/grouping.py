"""KL-based parameter grouping, a copy of ``recombiner_tpu/priors/grouping.py``.

Parameters are shuffled with a fixed seed, then greedily bin-packed so each
group's summed KL stays <= bits_per_group bits. The algorithm is
order-dependent; its output is part of the prior artifact.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grouping:
    """Static grouping metadata for one latent level.

    The "coded order" is the concatenation of the groups. param2group maps
    coded position -> original parameter index; group2param is its inverse.
    """

    n_groups: int
    group_start: np.ndarray  # (G,) int32, coded-order start offset per group
    group_end: np.ndarray  # (G,) int32
    group_idx: np.ndarray  # (D,) int32, group id of each coded position
    param2group: np.ndarray  # (D,) int32, coded position -> param index
    group2param: np.ndarray  # (D,) int32, param index -> coded position
    group_kls: np.ndarray  # (G,) float64, summed KL bits per group
    weights: np.ndarray  # (D,) float64 per-param KL bits (param order)

    @property
    def n_params(self) -> int:
        return int(self.param2group.shape[0])

    @property
    def group_sizes(self) -> np.ndarray:
        return self.group_end - self.group_start

    @property
    def max_group_size(self) -> int:
        return int(self.group_sizes.max())


def greedy_pack(weights: np.ndarray, max_weight: float) -> List[List[int]]:
    """Walk items in order; open a new group when the next item would push
    the current one over max_weight."""
    groups: List[List[int]] = [[0]]
    current = float(weights[0])
    for i in range(1, len(weights)):
        w = float(weights[i])
        if current + w > max_weight:
            groups.append([i])
            current = w
        else:
            groups[-1].append(i)
            current += w
    return groups


def compute_grouping(
    kl_bits: np.ndarray, max_bits: float = 16.0, shuffle_seed: int = 0
) -> Grouping:
    """Build a Grouping from the mean per-parameter KL in bits, (D,)."""
    kl_bits = np.asarray(kl_bits, dtype=np.float64)
    d = kl_bits.shape[0]
    rng = np.random.RandomState(shuffle_seed)
    index = rng.choice(d, d, replace=False)

    packed = greedy_pack(kl_bits[index], max_bits)
    param2group = np.concatenate([index[g] for g in packed]).astype(np.int32)
    group2param = np.argsort(param2group).astype(np.int32)
    group_idx = np.concatenate(
        [np.full(len(g), gi, dtype=np.int32) for gi, g in enumerate(packed)]
    )
    sizes = np.array([len(g) for g in packed], dtype=np.int32)
    group_end = np.cumsum(sizes).astype(np.int32)
    group_start = (group_end - sizes).astype(np.int32)
    group_kls = np.array([kl_bits[index[g]].sum() for g in packed])

    return Grouping(
        n_groups=len(packed),
        group_start=group_start,
        group_end=group_end,
        group_idx=group_idx,
        param2group=param2group,
        group2param=group2param,
        group_kls=group_kls,
        weights=kl_bits,
    )


def grouping_from_posteriors(q_loc: np.ndarray, q_scale: np.ndarray, p_loc: np.ndarray,
                             p_scale: np.ndarray, max_bits: float = 16.0) -> Grouping:
    """Grouping from training-set posteriors against the prior: the mean KL
    per parameter in bits over the training rows, in numpy on the inputs'
    own dtype (f32 from a prior state), as
    ``recombiner_tpu/priors/grouping.py:102-115`` computes it."""
    var_ratio = (q_scale / p_scale) ** 2
    t = ((q_loc - p_loc) / p_scale) ** 2
    kl = 0.5 * (var_ratio + t - 1.0 - np.log(var_ratio))
    kl_bits = kl.mean(axis=0) / np.log(2.0)
    return compute_grouping(kl_bits, max_bits=max_bits)
