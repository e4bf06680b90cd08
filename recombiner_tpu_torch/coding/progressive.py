"""The progressive encode loop of ``recombiner_tpu/coding/progressive.py``:
optimise the posteriors (phase 1, a fixed number of epochs or up to a
plateau), then, level by level (hh, h,
w for a patch config; w alone otherwise), code every row's highest-KL
group one step at a time, each step followed by a finetune of every level
with a fresh Adam (a fixed budget or up to a plateau), snapshot along the
way, and decode the indices.

Precision (``utils/platform.py``): phase 1 runs at ``phase1_precision``
and the coding finetunes at ``coding_precision`` (None: the process's
ambient, TF32 on the card unless ``--precision highest``; the
unrounded-PSNR configs' finetunes exact unless 'default' is asked for,
``resolve_coding_precision``). The A* scoring and ``decode`` are exact f32
in every mode, as the JAX package's are. On the CPU every mode computes
the same numbers, which is what the tests compare against the JAX package.

The noise comes from one ``torch.Generator`` threaded through every epoch
(or, for CRN finetunes, a stream derived from its seed); its numbers
differ from ``jax.random``'s, so two packages' encodes of the same data
differ sample by sample but write the same bitstream and snapshot formats.

Data-parallel (the state's rows sharded by ``state.part``, X and Y this
rank's rows, as ``cli/compress`` lays them out: whole datapoints, or one
datapoint's patch rows with the conv canvas's halo exchanged): every host
decision reads a global value on every rank (the plateau stops, the groups
already coded, whether any is), the snapshots gather the rows and rank 0
writes them (a snapshot resumes at any world size), and
every rank gathers the indices and decodes the same unsharded arrays
(``progressive.py:533-548``), so every rank returns the same
``EncodeResult``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from recombiner_tpu_torch.coding.decoder import Codec, CodecState, decode, predict
from recombiner_tpu_torch.coding.encoder import (
    AdamState,
    coded_view,
    cosine_lr,
    encode_chunk,
    finetune_noise,
    group_kl,
    optimize,
    optimize_adaptive,
    trainable_levels,
)
from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.device import precision
from recombiner_tpu_torch.io import encode_state
from recombiner_tpu_torch.metrics import UNROUNDED_PSNR, metric
from recombiner_tpu_torch.parallel.launch import is_primary
from recombiner_tpu_torch.parallel.mesh import gather_rows, global_any, global_max
from recombiner_tpu_torch.utils.timing import sync


@dataclasses.dataclass
class EncodeResult:
    state: CodecState
    indices: Dict[str, np.ndarray]
    distortion: np.ndarray
    bitrate: float
    reconstruction: np.ndarray
    timings: Dict[str, float]


def distortion_of(codec: Codec, state: CodecState, X: torch.Tensor, Y: torch.Tensor,
                  cfg: ModalityConfig):
    """The metric of one posterior sample (noise from a generator seeded 0),
    as the JAX package's ``distortion_of`` draws with ``key(0)``, at the
    ambient precision as its ``predict`` runs; of every rank's rows."""
    gen = torch.Generator(device=codec.device).manual_seed(0)
    with torch.no_grad(), precision():
        y = predict(codec, state, X, cfg, 1, generator=gen)[:, 0]
    part = state.part
    return metric(gather_rows(Y, part).cpu().numpy(), gather_rows(y, part).cpu().numpy(),
                  cfg.name)


def resolve_coding_precision(coding_precision: Optional[str],
                             cfg: ModalityConfig) -> Optional[str]:
    """The per-modality auto of the coding finetunes' precision
    (``progressive.py:56-78``): ``decode`` renders in exact f32, so the
    finetunes of the unrounded-PSNR (audio-family) configs run exact too,
    or the posteriors co-adapt to the TF32 forward and the exact decode
    renders another function (measured by the JAX package at -1.2/-1.8 dB
    on audio_mini at 66-71 dB). The sentinel 'default' forces the ambient;
    any other value is kept."""
    if coding_precision == "default":
        return None
    if coding_precision is None and cfg.name in UNROUNDED_PSNR:
        return "highest"
    return coding_precision


def kl_bits_summary(codec: Codec, state: CodecState) -> Dict[str, float]:
    out = {}
    part = state.part
    for name in codec.level_names:
        ls = coded_view(state.level(name), name, part)
        coded = None if part is None else part.coded(name)
        bits = gather_rows(group_kl(ls, codec.meta(name)) / np.log(2.0), coded)
        bits = bits.cpu().numpy()
        mask = ~gather_rows(ls.compressed, coded).cpu().numpy()
        if mask.any():
            out[f"{name}_max_bits"] = float(bits[mask].max())
            out[f"{name}_ave_bits"] = float(bits[mask].mean())
    return out


def finetune_epochs(cfg: ModalityConfig, n_groups: int, level: str) -> int:
    """Reference finetune budgets (main_compression.py:156-158)."""
    if level == "w":
        return max(30000 // n_groups, 50)
    return max(15000 // n_groups, 20)


def compress(codec: Codec, state: CodecState, X, Y, cfg: ModalityConfig,
             generator: torch.Generator, *, n_optimize_epochs: int = 30000, lr: float = 2e-4,
             sample_size: int = 5, finetune_overrides: Optional[Dict[str, int]] = None,
             verbose: bool = False, state_path: Optional[str] = None, save_every: int = 10,
             remat: bool = False, state_extra: Optional[Dict] = None,
             phase1_epochs_done: int = 0, phase1_opt_leaves=None,
             phase1_es: Optional[Sequence[float]] = None,
             resume_generator_state: Optional[torch.Tensor] = None, chunk_epochs: int = 1000,
             finetune_crn: Optional[bool] = None, phase1_stop: Optional[tuple] = None,
             finetune_stop: Optional[tuple] = None, phase1_monitor: str = "mse",
             phase1_lr: Optional[tuple] = None, phase1_sample_size: Optional[int] = None,
             fused_steps: Optional[int] = None, finetune_lr: Optional[float] = None,
             finetune_lr_schedule: Optional[str] = None,
             coding_precision: Optional[str] = None,
             phase1_precision: Optional[str] = None) -> EncodeResult:
    """Full encode; X (R, P, fourier_dim) and Y (R, P, out) move to the
    codec's device. The knobs are the JAX package's (``progressive.py:
    100-228``):

    - phase 1: ``n_optimize_epochs`` epochs at ``lr``, or with
      ``phase1_lr=(peak, floor)`` a cosine decay over them; S =
      ``phase1_sample_size`` (default ``sample_size``); with
      ``phase1_stop=(window, rel_tol, min_epochs)`` a ceiling, stopped on a
      plateau of ``phase1_monitor`` ('mse' or 'loss'). It runs in chunks of
      ``chunk_epochs`` (a multiple of 10, so chunking changes no number),
      each followed by a snapshot when ``state_path`` is given;
    - the coding loop: levels hh, h, w for a patch config (w alone
      otherwise); each level's finetunes take the reference budget or
      ``finetune_overrides[level]``, a ceiling under ``finetune_stop``;
      ``finetune_crn`` (None: on for patch configs only) gives every
      finetune one noise stream;
      ``finetune_lr`` and ``finetune_lr_schedule`` ('cosine') need
      ``fused_steps`` with a budget of at most ``chunk_epochs``, as in the
      JAX package. ``fused_steps=K`` groups K steps per snapshot and
      report; it changes no number. Unfused, a snapshot follows every
      ``save_every`` groups of a level;
    - ``remat``: every epoch recomputes its forward in its backward
      (``encoder.elbo_loss``); it changes no number;
    - ``phase1_precision`` and ``coding_precision``: the precision of
      phase 1 and of every coding finetune (``device.precision``; None the
      ambient), the latter through ``resolve_coding_precision`` first.
      The A* scoring and the final ``decode`` are exact in every mode, and
      the bitstream's format does not depend on either.

    Resume: ``phase1_epochs_done``, ``phase1_opt_leaves`` (optax's leaf
    order, every rank's rows), ``phase1_es`` and ``resume_generator_state``
    continue phase 1 where a snapshot left it; a state whose groups are
    partly coded skips phase 1 and, level by level, the coded groups.
    ``state_extra`` is merged into every snapshot's header. Snapshots go
    through ``encode_state.save_encode_state``, looked up at each call."""
    dev = codec.device
    part = state.part
    coding_precision = resolve_coding_precision(coding_precision, cfg)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    Y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    order = ("hh", "h", "w") if cfg.patch else ("w",)
    n_ft = {level: (finetune_overrides or {}).get(
        level, finetune_epochs(cfg, codec.meta(level).n_groups, level)) for level in order}
    fused = {level: bool(fused_steps) and 0 < n <= chunk_epochs for level, n in n_ft.items()}
    if (finetune_lr or finetune_lr_schedule) and any(n_ft[lv] > 0 and not fused[lv]
                                                     for lv in order):
        raise ValueError("finetune_lr/finetune_lr_schedule require the fused coding path "
                         "(fused_steps with n_ft <= chunk_epochs)")
    if resume_generator_state is not None:
        generator.set_state(resume_generator_state)
    scheduled = phase1_lr is not None
    levels = trainable_levels(codec)
    timings: Dict[str, float] = {}

    def log(*a, **k) -> None:
        # every rank computes what ``verbose`` reports (its distortions are
        # collectives); rank 0 prints
        if is_primary():
            print(*a, **k)

    def snapshot(state: CodecState, extra: Dict, opt_state=None) -> None:
        # on every rank: the rows are gathered, rank 0 writes
        if state_path is None:
            return
        encode_state.save_encode_state(
            state_path, state,
            extra={**extra, encode_state.GENERATOR_FIELD: encode_state.generator_record(generator),
                   **(state_extra or {})},
            opt_leaves=None if opt_state is None else opt_state.leaves(scheduled, part, levels))

    def any_coded(state: CodecState) -> bool:
        return global_any(any(bool(state.level(lv).compressed.any())
                              for lv in codec.level_names), part)

    t0 = time.perf_counter()
    if verbose:
        d0 = distortion_of(codec, state, X, Y, cfg)
        log(f"Initialization: average distortion {np.mean(d0):.4f}", flush=True)
    resuming = any_coded(state)
    if resuming and verbose:
        log("Resuming encode from restored state; skipping phase-1 optimization", flush=True)

    timings["phase1_epochs"] = 0
    if n_optimize_epochs > phase1_epochs_done and not resuming:
        opt_state = (None if phase1_opt_leaves is None
                     else AdamState.from_leaves(phase1_opt_leaves, scheduled, dev,
                                                len(levels)).shard_rows(part, levels))
        if opt_state is not None and verbose:
            log(f"Resuming phase-1 optimization at {phase1_epochs_done}/{n_optimize_epochs} "
                  "epochs", flush=True)
        rate = cosine_lr(*phase1_lr, n_optimize_epochs) if scheduled else lr
        s1 = phase1_sample_size or sample_size
        done, stopped = phase1_epochs_done, False
        es = (math.inf, 0.0) if phase1_es is None else tuple(phase1_es)
        while done < n_optimize_epochs and not stopped:
            n = min(chunk_epochs, n_optimize_epochs - done)
            extra = {}
            if phase1_stop is not None:
                window, rel_tol, min_epochs = phase1_stop
                state, opt_state, es, done, stopped = optimize_adaptive(
                    codec, state, X, Y, cfg, generator, done, done + n, min_epochs, rel_tol, es,
                    lr=rate, sample_size=s1, window=window, opt_state=opt_state,
                    monitor=phase1_monitor, remat=remat, precision=phase1_precision)
                extra["phase1_es"] = list(es)
            else:
                state, opt_state = optimize(codec, state, X, Y, cfg, generator, n_epochs=n,
                                            lr=rate, sample_size=s1, opt_state=opt_state,
                                            return_opt_state=True, remat=remat,
                                            precision=phase1_precision)
                done += n
            # after a plateau stop the snapshot says phase 1 is over, as the
            # coding loop's snapshots do, so that a resume does not run on
            snapshot(state, {"phase1_epochs_done": n_optimize_epochs if stopped else done,
                             **extra}, opt_state)
            if verbose:
                log(f"  optimize {done}/{n_optimize_epochs} epochs"
                      f"{' (plateau stop)' if stopped else ''} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
        timings["phase1_epochs"] = done
    sync(state.w.q.loc)
    timings["optimize_s"] = time.perf_counter() - t0
    if verbose:
        d1 = distortion_of(codec, state, X, Y, cfg)
        log(f"Optimization finished ({timings['optimize_s']:.0f}s): average distortion "
              f"{np.mean(d1):.4f} {kl_bits_summary(codec, state)}", flush=True)

    t1 = time.perf_counter()
    if finetune_crn is None:
        finetune_crn = bool(cfg.patch)
    noise = finetune_noise(generator, finetune_crn)
    ft_w, ft_tol, ft_min = finetune_stop if finetune_stop is not None else (0, 0.0, 0)
    timings["finetune_epochs"] = timings["finetune_budget"] = 0
    # The JAX package caps its un-synced dispatch window at 8 group steps on
    # several devices (progressive.py:356-372), for an XLA rendezvous fault;
    # the port dispatches each step's collectives synchronously and needs none.
    for level in order:
        n_groups = codec.meta(level).n_groups
        per_call = int(fused_steps) if fused[level] else 1
        report_at = set(np.linspace(0, n_groups - 1, 10).astype(int).tolist())
        # groups already coded (a resumed state) are skipped
        step_i = global_max(int(state.level(level).compressed.sum(1).max()), part)
        while step_i < n_groups:
            k = min(per_call, n_groups - step_i)
            state, ran = encode_chunk(
                codec, state, X, Y, cfg, noise, ft_min, ft_tol, n_steps=k, n_ft=n_ft[level],
                lr=(finetune_lr or lr) if fused[level] else lr, sample_size=sample_size,
                window=int(ft_w), lr_schedule=finetune_lr_schedule if fused[level] else None,
                level=level, remat=remat, precision=coding_precision)
            step_i += k
            timings["finetune_budget"] += n_ft[level] * k
            timings["finetune_epochs"] += int(ran.sum())
            if verbose:
                if report_at & set(range(step_i - k, step_i)):
                    d = distortion_of(codec, state, X, Y, cfg)
                    log(f"[{level}] {step_i}/{n_groups} groups coded; distortion "
                          f"{np.mean(d):.4f}", flush=True)
                else:
                    log(f"[{level}] {step_i}/{n_groups}", flush=True)
            if fused[level] or step_i % save_every == 0:
                snapshot(state, {"level": level, "step": step_i - 1,
                                 "phase1_epochs_done": n_optimize_epochs})
    sync(state.w.indices)
    timings["code_s"] = time.perf_counter() - t1
    indices = {name: gather_rows(state.level(name).indices, part and part.coded(name))
               .cpu().numpy().astype(np.int32) for name in codec.level_names}
    # the final reconstruction through the decoder, from the indices alone:
    # exactly what a receiver renders; every rank decodes every row
    y_pred = decode(codec, indices, gather_rows(X, part), cfg).cpu().numpy()
    dist = metric(gather_rows(Y, part).cpu().numpy(), y_pred, cfg.name)
    state = state.gathered()
    bitrate = cfg.bitrate_of_groups(*(codec.meta(n).n_groups for n in codec.level_names))
    if verbose:
        log(f"Encode finished: distortion {np.mean(dist):.4f} @ {bitrate:.4f}", flush=True)
    return EncodeResult(state=state, indices=indices, distortion=np.asarray(dist),
                        bitrate=bitrate, reconstruction=y_pred, timings=timings)
