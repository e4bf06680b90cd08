"""Timing helpers that wait for the device: the port's copy of
``recombiner_tpu/utils/timing.py``. CUDA work is asynchronous, so a host
clock read before ``torch.cuda.synchronize`` measures the enqueue."""

from __future__ import annotations

import time
from typing import Callable

import torch


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))


def sync(tree) -> None:
    """Wait for the device of the first CUDA tensor in ``tree`` (a tensor,
    or dicts, lists, tuples and dataclasses of them) to finish its work; a
    no-op when no leaf is on a CUDA device."""
    dev = next((t.device for t in _leaves(tree) if t.device.type == "cuda"), None)
    if dev is not None:
        torch.cuda.synchronize(dev)


def time_fn(f: Callable, *args, iters: int = 10, warmup: int = 2, **kw) -> float:
    """Steady-state seconds per call: ``warmup`` calls, a sync, ``iters``
    calls chained, one sync on the last result, the host time divided by
    ``iters``. Nothing is subtracted: use enough calls to amortise the
    sync."""
    out = None
    for _ in range(warmup):
        out = f(*args, **kw)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args, **kw)
    sync(out)
    return (time.perf_counter() - t0) / iters
