"""Deterministic truncated-Gumbel chain for A* coding, a copy of
``recombiner_tpu/coding/gumbel.py``.

The chain is bitstream format: the encoder scores every codebook sample
with it, so both packages must draw the same ``RandomState`` stream.
b_0 = -log(E_0), b_i = -log(cumsum(E)_i) with E_i = -log(U_i): the Gumbel
values of a Poisson arrival process, strictly decreasing.
"""

from __future__ import annotations

import numpy as np


def gumbel_chain(n: int, seed: int) -> np.ndarray:
    """Strictly decreasing top-n Gumbel perturbation sequence (float64)."""
    rng = np.random.RandomState(seed)
    e = -np.log(rng.rand(n))
    return -np.log(np.cumsum(e))
