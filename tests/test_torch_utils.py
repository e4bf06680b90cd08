"""The port's timing and tracing utilities (``utils/timing.py``,
``utils/tracing.py``) on the CPU, as the JAX package's tests hold its own
(``tests/test_resume_and_utils.py::test_step_timer``,
``::test_trace_noop_and_log_jsonl``)."""

import dataclasses
import json

import torch

from recombiner_tpu_torch.utils import timing
from recombiner_tpu_torch.utils.tracing import TRACE_FILE, StepTimer, log_jsonl, trace


def test_step_timer():
    t = StepTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b", sync_on=torch.zeros(3)):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0
    assert set(s["a"]) == {"total_s", "count", "mean_s"}


def test_trace_noop_and_log_jsonl(tmp_path):
    with trace(None):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    p = str(tmp_path / "log.jsonl")
    log_jsonl(p, {"step": 1, "psnr": 30.5})
    log_jsonl(p, {"step": 2, "psnr": 31.0})
    recs = [json.loads(line) for line in open(p)]
    assert recs[1]["psnr"] == 31.0


def test_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the profiler records the CPU's operators; the trace is
    written under the (new) directory and names them."""
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        torch.randn(16, 16) @ torch.randn(16, 16)
    path = logdir / TRACE_FILE
    assert path.exists()
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_time_fn_and_sync():
    """time_fn returns positive seconds per call and calls ``f`` warmup +
    iters times; sync finds no CUDA leaf in CPU trees, of any nesting, and
    returns."""
    calls = []

    def f(n):
        calls.append(n)
        return torch.randn(n) @ torch.randn(n)

    assert timing.time_fn(f, 64, iters=3, warmup=2) > 0
    assert calls == [64] * 5

    @dataclasses.dataclass
    class Holder:
        a: torch.Tensor
        b: list

    timing.sync(Holder(torch.zeros(2), [{"x": torch.ones(1)}, (torch.ones(1),)]))
    timing.sync(None)
    assert list(timing._leaves({"k": [torch.zeros(1), (torch.ones(2),)]}))[1].shape == (2,)
