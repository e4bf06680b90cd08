"""The progressive encode loop on the reference schedule, the fixed-budget,
unfused path of ``recombiner_tpu/coding/progressive.py``: optimise the
posteriors (phase 1, one ``optimize`` call), then code
every row's highest-KL group one step at a time, each step followed by a
fixed-budget finetune with a fresh Adam, and decode the indices.

Everything runs in exact f32 (TF32 off in cuBLAS and cuDNN; ``optimize``,
the A* scoring and ``decode`` each set it), which is what the JAX package
computes on the CPU that the tests compare against. The
noise comes from one ``torch.Generator`` threaded through every epoch;
its numbers differ from ``jax.random``'s, so two packages' encodes of the
same data differ sample by sample but write the same bitstream format.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from recombiner_tpu_torch.coding.decoder import Codec, CodecState, decode, predict
from recombiner_tpu_torch.coding.encoder import encode_step, group_kl, optimize
from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.device import exact_f32
from recombiner_tpu_torch.metrics import metric

_LATER = "ROADMAP.md, port queue 1: the rest of encode"


@dataclasses.dataclass
class EncodeResult:
    state: CodecState
    indices: Dict[str, np.ndarray]
    distortion: np.ndarray
    bitrate: float
    reconstruction: np.ndarray
    timings: Dict[str, float]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def distortion_of(codec: Codec, state: CodecState, X: torch.Tensor, Y: torch.Tensor,
                  cfg: ModalityConfig):
    """The metric of one posterior sample (noise from a generator seeded 0),
    as the JAX package's ``distortion_of`` draws with ``key(0)``."""
    gen = torch.Generator(device=codec.device).manual_seed(0)
    with torch.no_grad(), exact_f32():
        y = predict(codec, state, X, cfg, 1, generator=gen)[:, 0]
    return metric(Y.cpu().numpy(), y.cpu().numpy(), cfg.name)


def kl_bits_summary(codec: Codec, state: CodecState) -> Dict[str, float]:
    bits = (group_kl(state.w, codec.w) / np.log(2.0)).cpu().numpy()
    mask = ~state.w.compressed.cpu().numpy()
    if not mask.any():
        return {}
    return {"w_max_bits": float(bits[mask].max()), "w_ave_bits": float(bits[mask].mean())}


def finetune_epochs(cfg: ModalityConfig, n_groups: int, level: str) -> int:
    """Reference finetune budgets (main_compression.py:156-158)."""
    if level == "w":
        return max(30000 // n_groups, 50)
    return max(15000 // n_groups, 20)


def compress(codec: Codec, state: CodecState, X, Y, cfg: ModalityConfig,
             generator: torch.Generator, *, n_optimize_epochs: int = 30000, lr: float = 2e-4,
             sample_size: int = 5, finetune_overrides: Optional[Dict[str, int]] = None,
             verbose: bool = False, phase1_stop: Optional[tuple] = None,
             finetune_stop: Optional[tuple] = None, fused_steps: Optional[int] = None,
             state_path: Optional[str] = None, remat: bool = False) -> EncodeResult:
    """Full encode on the reference schedule: ``n_optimize_epochs`` of phase
    1, then each of level w's groups coded by an ``encode_step`` and refined
    by a finetune of the reference's budget (or ``finetune_overrides['w']``)
    with a fresh Adam. X (R, P, fourier_dim) and Y (R, P, out) move to the
    codec's device."""
    for name, value in (("phase1_stop", phase1_stop), ("finetune_stop", finetune_stop),
                        ("fused_steps", fused_steps), ("state_path", state_path)):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet ({_LATER})")
    if remat:
        raise NotImplementedError(f"remat is not ported yet ({_LATER})")
    if cfg.patch:
        raise NotImplementedError("patch configs are not ported yet (ROADMAP.md, port "
                                  "queue: patch / kodak_mini)")
    dev = codec.device
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    Y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    timings: Dict[str, float] = {}

    def run(state: CodecState, n_epochs: int) -> CodecState:
        return optimize(codec, state, X, Y, cfg, generator, n_epochs=n_epochs, lr=lr,
                        sample_size=sample_size)

    t0 = time.perf_counter()
    if verbose:
        d0 = distortion_of(codec, state, X, Y, cfg)
        print(f"Initialization: average distortion {np.mean(d0):.4f}", flush=True)
    state = run(state, n_optimize_epochs)
    timings["phase1_epochs"] = n_optimize_epochs
    _sync(dev)
    timings["optimize_s"] = time.perf_counter() - t0
    if verbose:
        d1 = distortion_of(codec, state, X, Y, cfg)
        print(f"Optimization finished ({timings['optimize_s']:.0f}s): average distortion "
              f"{np.mean(d1):.4f} {kl_bits_summary(codec, state)}", flush=True)

    t1 = time.perf_counter()
    meta = codec.w
    n_ft = (finetune_overrides or {}).get("w", finetune_epochs(cfg, meta.n_groups, "w"))
    report_at = set(np.linspace(0, meta.n_groups - 1, 10).astype(int).tolist())
    for step_i in range(meta.n_groups):
        state = encode_step(codec, state, "w")
        # beta annealing continues inside each finetune; coded groups keep
        # beta = 0 because update_betas skips them
        state = run(state, n_ft)
        if verbose:
            if step_i in report_at:
                d = distortion_of(codec, state, X, Y, cfg)
                print(f"[w] {step_i + 1}/{meta.n_groups} groups coded; distortion "
                      f"{np.mean(d):.4f}", flush=True)
            else:
                print(f"[w] {step_i + 1}/{meta.n_groups}", flush=True)
    timings["finetune_epochs"] = n_ft * meta.n_groups
    _sync(dev)
    timings["code_s"] = time.perf_counter() - t1
    indices = {"w": state.w.indices.cpu().numpy().astype(np.int32)}
    # the final reconstruction through the decoder, from the indices alone:
    # exactly what a receiver renders
    y_pred = decode(codec, indices, X, cfg).cpu().numpy()
    dist = metric(Y.cpu().numpy(), y_pred, cfg.name)
    bitrate = cfg.bitrate_of_groups(meta.n_groups)
    if verbose:
        print(f"Encode finished: distortion {np.mean(dist):.4f} @ {bitrate:.4f}", flush=True)
    return EncodeResult(state=state, indices=indices, distortion=np.asarray(dist),
                        bitrate=bitrate, reconstruction=y_pred, timings=timings)
