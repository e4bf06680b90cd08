"""Tracing, profiling and step timing: the port's copy of
``recombiner_tpu/utils/tracing.py``.

- ``StepTimer``: wall-clock time per named phase, waiting for the device.
- ``trace``: ``torch.profiler`` around a block, written as a Chrome trace
  (Perfetto, ``chrome://tracing``).
- ``log_jsonl``: one JSON object per line.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

from recombiner_tpu_torch.utils.timing import sync

TRACE_FILE = "trace.json"


class StepTimer:
    """Accumulates wall-clock per named phase; ``summary()`` gives totals,
    counts and means."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        """Times the block; with ``sync_on`` (tensors) the time includes the
        device work that feeds them."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                sync(sync_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_s": round(self.totals[k] / max(self.counts[k], 1), 5),
            }
            for k in self.totals
        }


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` around the block, its Chrome trace written to
    ``logdir/trace.json`` (the directory is made); a no-op for None. CUDA
    activity is recorded when a card is present. Unlike the JAX package's
    ``trace``, a profiler that fails to start or stop raises: no fallback
    hides the device."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def log_jsonl(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
