#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: CIFAR decode, and encode
on the reference, adaptive and quality schedules with a crash and a
resume, at R = 500; then Kodak (the patch path: levels w, h, hh, the
cross-patch permutations and the stitched conv canvas) at its full
geometry: decode, encode, remat, and a crash and a resume; then audio,
video and protein at theirs (the 1-D and 3-D conv stacks): decode,
encode and the media export, and for video remat and a resume; then prior
training: cli.train and cli.rd_sweep on CIFAR at R = 2,000, and Kodak's
three levels; then scale-out: the CLIs at world size 1 on NCCL, two ranks
on the one card over gloo, and one Kodak image's patch rows split over two
ranks with the conv canvas's halo exchanged.

    python3 chip_smoke.py [--seed 0]

Phases (each prints its seconds; any failure exits non-zero, nothing is
caught and passed over but the crashes phase 12 simulates):

1. the card: name and power limit from nvidia-smi;
2. build both CUDA kernels (ops/csrc/siren_fwd.cu, ops/csrc/siren_bwd.cu,
   both including ops/csrc/siren_mma.cuh) with nvcc, one process each,
   started together; print ptxas' register / shared-memory / spill lines,
   registers and spill bytes by instance (the fixed-width ones for CIFAR's,
   audio's and video's widths, and the run-time one), and each launcher's
   plan at CIFAR's, audio's, video's and TINY's widths (instance, warps and
   shared memory per block, resident blocks per SM);
3. hold siren_fwd against its plain PyTorch version on the card: CIFAR
   B = 500, P = 1024 in both launch shapes (one sample per block, the main
   path's, and groups of 8), and B = 3 with P = 1000 (not a multiple of the
   256-pixel tile); at B = 500 the kernel's and the plain version's gaps to
   an f64 evaluation are printed;
4. hold siren_bwd against its plain version: CIFAR encode's B = 2,500
   (R = 500 x S = 5), P = 1024, and B = 3, P = 1000; two launches must be
   bitwise equal; at B = 2,500 the kernel's and the plain version's gaps to
   an f64 evaluation are printed; and siren_fwd at the encode's B = 2,500 in the launch the
   encode makes (one sample per block); then the run-time-width instance,
   which no full-size path runs: both kernels at TINY's widths 32-8-8-3
   (B = 500 / 2,500, P = 256, timed) and at 64-64-40-7, each held against
   its plain version, its and the plain version's gaps to an f64 evaluation
   printed;
5. the decode slice: a CIFAR prior artifact made from --seed by the port's
   own code (nothing is read from docs/), init_codec at R = 500, random
   16-bit indices, decode on the card with the launch counts read around
   it, rows 0-7 compared with the port's decode on the CPU;
6. the encode slice: progressive.compress at R = 500, S = 5 on images drawn
   from --seed, cut to ENCODE_PHASE1_EPOCHS phase-1 epochs and
   ENCODE_FINETUNE_EPOCHS per group so that all 125 groups are coded; the
   launch counts read around it (siren_bwd once per epoch); the bitstream
   written, read back and decoded on the card; one encode step on the card
   compared with the CPU's;
7. timings: both kernels and their plain versions by CUDA events (device
   time of back-to-back calls, see ``cuda_ms``), decode
   datapoints/s, the encode epoch (epoch_s), one encode step (code_step_s)
   and peak device memory; each kernel's bound at f32 accuracy (bytes, or
   operations on the faster of FP32 FMA and 3xTF32 on the tensor cores)
   and, beside it, the FP32-FMA bound of earlier runs;
8. ten decodes and ten encode epochs under torch.profiler: device busy
   time, the idle share against the wall time of the same profiled calls,
   and the kernels that take the time;
9. the conv stacks: the phase-decomposed stack held against the plain one
   on the card, then epoch_s (S = 5) and decode wall time under each, in
   turns, the stack that ``mappings.lpe_to_pe`` uses, and ten epochs of the
   other stack under the profiler;
10. determinism: two 20-epoch ``optimize`` runs from one state and one
   generator state must agree bit for bit (``coding/encoder.py``'s claim);
   beside it, the same runs with cuDNN's own choice of algorithms in place
   of ``deterministic_convs``, and epoch_s under each;
11. the adaptive encode: ``compress`` on ``ADAPTIVE_PRESET``'s knobs at
   R = 500 with the ceilings and windows cut (ADAPTIVE below); both stop
   tests must fire; the launch counts read around it; the bitstream read
   back and decoded on the card equal to compress's reconstruction; and
   epoch_s at S = 3;
12. the quality preset with a crash and a resume (QUALITY below): once
   without interruption, then with ``state_path`` and a snapshot writer
   that raises after the first phase-1 snapshot, resumed through the CLI's
   ``resume_from``, crashed again after the first coding-loop snapshot,
   and resumed again; the final indices and posteriors must equal the
   uninterrupted run's bit for bit;
13. Kodak kernels: a KODAK prior of the artifact's shapes from --seed (no
   trained one is in the repo), siren_fwd at B = 96, P = 4,096 (one
   image's patch rows) and siren_bwd at B = 480 (S = 5), each held against
   its plain version and an f64 evaluation, timed, with its bound;
14. Kodak decode: random indices for all three levels (96 / 6 / 1 rows),
   decoded on the card and on the CPU (all 96 rows, so the stitch is
   compared whole), both held to an f64 decode; decode wall, device time
   and peak memory;
15. Kodak encode: ``compress`` on the reference schedule on one smooth
   512 x 768 image, cut in depth (CUT_* below), every group of hh, h and
   w coded, the launch counts read around it, the bitstream decoded back
   equal; epoch_s at S = 5, code_step_s per level, peak memory, an epoch
   under the profiler, and epoch_s under each conv stack;
16. Kodak remat: REMAT_EPOCHS epochs from one state and generator
   state with remat off, on, on, off: off twice and on against off must be
   bitwise equal; epoch_s and peak memory of each;
17. Kodak resume: the encode crashed after its first snapshot at level h,
   resumed through ``resume_from``; indices and posteriors must equal the
   uninterrupted encode's bit for bit;
18. the same phases (kernels, decode, encode) for AUDIO (one 3 s
   speech-like clip: 60 / 15 / 1 rows, P = 800, widths 32-32-32-32-1, the
   1-D stack on a 3,000-long canvas), VIDEO (one smooth 24 x 128 x 128 clip:
   64 / 4 / 1 rows, P = 6,144, widths 34-32-32-32-3, the 3-D stack with its
   (6, 4, 4) first factor) and PROTEIN (1,000 backbones, one level, P =
   96), each on a random prior of its shapes from --seed and each followed
   by its export: ``cli.decompress --export_media`` on the card on the
   decode's indices, equal to the decode, and every WAV, NPZ and PDB file
   read back; each kernel check prints the instance it ran on (a
   fixed-width one must not spill) and its gap to an f64 evaluation over
   the plain version's; audio's and video's also siren_fwd at the encode's
   B = 300 / 320; video also with its phase stack held against the plain one
   on the card, remat off/on/on/off (the epochs repeat bit for bit) and a
   crash at level h resumed;
19. CIFAR train: 2,000 smooth 32 x 32 PNGs from --seed written with the
   port's PNG writer, ``cli.train.main`` on them (R = 2,000, 2.0 bpp, EM
   cut to TRAIN_EM) with the launch counts read around it (siren_bwd once
   per epoch, siren_fwd once per epoch and once per log forward); the
   artifact loaded back (groups, Gmax), ``init_codec`` on it and 8 rows
   decoded on the card against the CPU within DECODE_TOL;
20. train timing: train_epoch_s (one S = 1 epoch at R = 2,000, mean of 10
   warm epochs on the host clock), an epoch's peak device memory, 10
   epochs under torch.profiler split by kernel name into siren_bwd,
   siren_fwd, the conv stack, cuBLAS's GEMMs and the rest; by CUDA events
   the conv stack's forward, data and weight gradients, the A-transforms
   and their gradients and Adam's step on their own (``epoch_pieces``);
   and both kernels at B = 2,000 against their plain versions with their
   bounds;
21. train determinism: two 2-iteration em_iters runs from one state and
   generator state, and the loss's gradients twice (every A and conv
   weight and bias included), bitwise equal; a train state saved, loaded
   and continued equal to continuing in memory; one epoch at R = 64 from one
   state and one noise draw on the card against the CPU, within the tests'
   trained-state bound (``states_close``);
22. rd_sweep: ``cli.rd_sweep.main`` on 2,000 synthetic CIFAR images and 500
   test images (EM as in 19, the encode cut to 10 phase-1 epochs and
   1-epoch finetunes, ``--train_state_dir`` and ``--state_dir``): every
   group coded, the bitstream decoded back equal to compress's result;
   then crashed after its first train-state snapshot and relaunched twice
   from it: the controller restored, the two relaunches bitwise equal;
23. Kodak train: em_train on 4 smooth 512 x 768 images (384 / 24 / 4 rows of
   levels w / h / hh), 2 EM iterations of 3 epochs, the three-level M-step
   and artifact, ``init_codec`` and a decode on it, and both kernels at
   B = 384, P = 4,096;
24. precision modes: epoch_s of CIFAR (S = 5 and S = 3), Kodak and video
   and train_epoch_s, each under the ambient (TF32) and under
   ``--precision highest`` (exact f32) in turns, with a CIFAR and a
   training epoch's device time and conv share under each; the CIFAR
   encode of phase 6 repeated at the ambient (bitwise equal) and run under
   highest from the same generator state, both bitstreams decoded back,
   their PSNR gap; audio's encode's TF32 flags at every product by part
   (finetunes exact: the unrounded-PSNR auto); one epoch under
   ``utils.tracing.trace`` (the trace names siren_bwd); ``blocked_inr``
   against ``inr_forward_fused`` at R = 500, S = 5; the CIFAR decode check
   repeated DECODE_REPEATS times on deterministic cuDNN algorithms and on
   cuDNN's own choice, with the decode wall under each;
25. scale-out, world size 1 on NCCL: cli.train with phase 19's argv and
   cli.compress at CIFAR R = 500, S = 5 (the encode slice's cut depth, on
   500 PNGs from --seed) each run in a subprocess under torchrun's
   environment with ``--n_devices 1`` (the group's start-up and its first
   collective timed; the subprocess zeroes its launch counts just before
   the CLI's main and prints them just after, held to the epochs), each
   bitwise equal to the same CLI run with no process group: the
   artifact, the CSVs and bitstream, the reconstruction, the launches;
26. scale-out, world size 2 on the one card: two ranks spawned over gloo
   (NCCL refuses two ranks on one device; CUDA tensors staged through host
   memory) run ``scaleout_rank``: em_train at CIFAR R = 2,000 (SCALE_EM)
   and progressive.compress at R = 500, each twice, under --precision
   highest and at the ambient (TF32): launches equal to the epochs on both
   ranks, the A and conv weights bitwise equal on both, the two runs
   bitwise equal, rank 0's bitstreams decoded in one process within
   DECODE_TOL; exact, training within the trained-state bound of world
   size 1 and the encode's indices at least 98% equal to world size 1's
   (the JAX package's bar); at the ambient, the encode's indices at least
   1 - 2 (1 - a) equal to world size 1's, where a is the agreement of world
   size 1's own ambient encode with its initial posteriors nudged by 1e-7;
   the PSNR within 0.3 dB in both modes; each rank's train_epoch_s,
   epoch_s, time in collectives and peak memory (one shared card: not a
   scale-out speed). ``scripts/torch_scaleout.py`` runs the same rank
   function over NCCL, one card a rank;
27. Kodak over 2 ranks on one card: two ranks spawned over gloo run
   ``patch_rank``: one Kodak image (96 / 6 / 1 rows, P = 4,096, S = 5)
   split 48 patch rows a rank (h split with them, hh whole on both), the
   conv canvas's halo of one latent row exchanged; the halo-split
   ``lpe_to_pe`` and its LPE gradient (exact) within HALO_OF_MAX of the
   largest entry of the whole canvas's; then the Kodak encode (CUT_*)
   under --precision highest and at the ambient: both ranks return the
   same encode, its indices at least 1 - 2 (1 - a) equal to world size 1's
   in this process (a: world size 1 against its own encode with its
   initial w means nudged by 1e-7) and the PSNR within 0.3 dB, rank 0's
   bitstream decoded in one process within DECODE_TOL, launches held to
   the epochs on both ranks; each rank's epoch_s, time in the halo, the
   sums and the gathers an epoch, peak memory and launches (one shared
   card: not a scale-out speed). ``scripts/torch_scaleout.py --parts
   kodak`` runs the same rank function over NCCL, one card a rank.

Precision: everything a user runs (encodes, epochs, training) runs at the
ambient TF32, as the CLIs' default does; A* scoring and decode are exact in
every mode. Each check that holds the card against the CPU or an f64
evaluation runs exact: the kernels and the conv stacks under ``exact_f32``,
the training epoch at R = 64 under ``--precision highest``.

Cuts (depth only; every CIFAR phase runs CIFAR's full widths, R = 500
rows, all 125 groups coded): ENCODE_* for the reference schedule; ADAPTIVE
and QUALITY for the presets (``recombiner_tpu_torch/cli/compress.py``);
CUT_* for Kodak, audio, video and protein (full widths and geometry,
every group of every level coded); TRAIN_* for prior training (the
reference's 550 EM iterations of 200 / 100 epochs cut to 4 of 20 / 10 at
CIFAR's full widths and R = 2,000); SCALE_EM for the world-2 training (2
EM iterations of 3 epochs); the Kodak world-2 phase at the Kodak cut.

The last two lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.cli import decompress as decompress_cli
from recombiner_tpu_torch.cli import rd_sweep
from recombiner_tpu_torch.cli import train as train_cli
from recombiner_tpu_torch.cli.compress import resume_from
from recombiner_tpu_torch.coding import encoder, progressive
from recombiner_tpu_torch.coding import decoder
from recombiner_tpu_torch.coding.decoder import decode, init_codec
from recombiner_tpu_torch.config import AUDIO, CIFAR, KODAK, PROTEIN, TINY, VIDEO
from recombiner_tpu_torch.coords import grid_fourier_features
from recombiner_tpu_torch.data import export, protein, synthetic
from recombiner_tpu_torch.data.pipeline import points_from_data
from recombiner_tpu_torch.data.load_data import load_training_set
from recombiner_tpu_torch.device import deterministic_convs, exact_f32, precision
from recombiner_tpu_torch.io import encode_state, train_state
from recombiner_tpu_torch.io.bitstream import read_bitstream, write_bitstream
from recombiner_tpu_torch.io.checkpoint import (
    LevelArtifact,
    PriorArtifact,
    load_prior_artifact,
    prior_fingerprint,
    save_prior_artifact,
)
from recombiner_tpu_torch.metrics import metric
from recombiner_tpu_torch.models import mappings
from recombiner_tpu_torch.models.gaussian import Gaussian
from recombiner_tpu_torch.models.inr import inr_forward
from recombiner_tpu_torch.models.upsample import apply_upsample, apply_upsample_phased
from recombiner_tpu_torch.ops import _build
from recombiner_tpu_torch.ops import fused_inr
from recombiner_tpu_torch.ops.blocked_inr import inr_forward_blocked
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.priors import trainer
from recombiner_tpu_torch.priors.artifact import build_prior_artifact
from recombiner_tpu_torch.priors.grouping import compute_grouping
from recombiner_tpu_torch.utils import platform, tracing

N_ROWS = 500  # bench.py's CIFAR geometry (N_IMAGES), the reference's cifar test batch
SAMPLE_SIZE = 5  # cli/compress.py --sample_size default
# The encode is cut in depth, not in width: the reference schedule's 30,000
# phase-1 epochs to 40 and its 240-epoch finetunes to 1, so that all 125
# groups are coded inside the time limit.
ENCODE_PHASE1_EPOCHS = 40
ENCODE_FINETUNE_EPOCHS = 1
# ADAPTIVE_PRESET's knobs (S = 3 cosine-lr phase 1 from 6e-4 to 2e-5,
# plateau stops at its rel_tols, 8 steps per chunk) with its ceilings and
# windows cut: phase 1 15,000 -> 400 epochs, window 2,000 -> 50, min 8,000
# -> 100; finetunes 240 -> 16 epochs, window 40 -> 4, min 80 -> 8.
ADAPTIVE = dict(n_optimize_epochs=400, phase1_lr=(6e-4, 2e-5), phase1_sample_size=3,
                phase1_stop=(50, 2e-3, 100), finetune_stop=(4, 1e-3, 8), fused_steps=8,
                finetune_overrides={"w": 16})
# QUALITY_PRESET's knobs (S = 5, cosine finetune lr 4e-4) cut further:
# phase 1 -> 200 epochs in snapshot chunks of 50, window 50, min 100;
# finetunes -> 4 epochs, window 2, min 2.
QUALITY = dict(n_optimize_epochs=200, phase1_lr=(6e-4, 2e-5), phase1_stop=(50, 2e-3, 100),
               finetune_stop=(2, 1e-3, 2), fused_steps=8, finetune_lr=4e-4,
               finetune_lr_schedule="cosine", finetune_overrides={"w": 4}, chunk_epochs=50)
# Kodak decode on the card against an f64 evaluation: at most this many
# times the CPU's f32 decode's gap to it. At Kodak's geometry with the
# smoke's random prior the f32 decode itself is about 1.3e-4 from the f64
# one (three levels' latents summed make the SIREN at w0 = 30 amplify f32
# rounding more than CIFAR's one), so a fixed atol of CIFAR's 1e-4 between
# card and CPU measures f32, not the card (PERF.md, PR 8).
DECODE_F64_RATIO = 2.0
# the phase-decomposed conv stack against the plain one on the card: the
# same exact-f32 function with each output summed in another order
STACK_TOL = dict(atol=1e-5, rtol=1e-5)
# siren_fwd vs plain version on the card: f32 FMA order differs from
# cuBLAS's, and w0 = 30 scales each layer's rounding difference by ~30
# through three sin layers.
ATOL = RTOL = 1e-4
# siren_bwd vs plain version: max abs diff at most this share of the largest
# gradient entry. At these inputs the f32 plain version itself differs from
# an f64 evaluation by about 5e-5 of it.
BWD_OF_MAX = 2e-4
# ptxas' lines for each kernel instance (``ptxas_by_instance``)
PTXAS_ENTRY = re.compile(
    r"(?:siren_fwd|siren_bwd)_kernelI8InstanceILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS = re.compile(r"Used (\d+) registers")
# H100 SXM data-sheet peaks (dense): FP32 outside the tensor cores, TF32 on
# them, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12
DESIGN = {
    "siren_fwd": "3xTF32 mma.sync tiles, one sample's weights staged once per block",
    "siren_bwd": "3xTF32 mma.sync tiles, one sincos per unit, fixed-order dW in shared memory",
}


def bounds(flops: float, nbytes: float):
    """The least time the card could take at f32 accuracy: the larger of the
    bytes over the memory rate and the operations over the faster f32-exact
    route (FP32 FMA, or 3xTF32: three TF32 tensor-core products per
    product). Returns (bound_ms, "bytes" or "operations", the route of the
    operations term, and the FP32-FMA bound that earlier runs reported, in
    ms). The kernels' transcendentals are not counted."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_fp32, t_3xtf32 = flops / PEAK_FP32_FLOPS, 3 * flops / PEAK_TF32_FLOPS
    t_ops = min(t_fp32, t_3xtf32)
    return (1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes",
            "3xTF32" if t_3xtf32 <= t_fp32 else "FP32 FMA", 1e3 * max(t_fp32, t_bytes))


def fwd_work(x: torch.Tensor, theta: torch.Tensor, dims):
    """(operations, bytes) that siren_fwd needs: two per multiply-add of
    each layer at every pixel; x and theta read once, y written once."""
    B, P = x.shape[:2]
    flops = 2 * B * P * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return flops, 4 * (x.numel() + theta.numel() + B * P * dims[-1])


def bwd_work(x: torch.Tensor, theta: torch.Tensor, dy: torch.Tensor, dims):
    """(operations, bytes) that siren_bwd needs: the forward recompute (it
    stops before the last layer, whose dz is dy), then dW and da for every
    layer, at every pixel; x, theta and dy read once, dx and dtheta written
    once."""
    B, P = x.shape[:2]
    macs = [dims[i] * dims[i + 1] for i in range(len(dims) - 1)]
    flops = 2 * B * P * (sum(macs[:-1]) + 2 * sum(macs))
    return flops, 4 * (2 * x.numel() + 2 * theta.numel() + dy.numel())


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def random_level(rng: np.random.Generator, D: int, bits_per_group: int) -> LevelArtifact:
    """A level of D coded parameters with the trained CIFAR artifact's
    magnitudes and random values: per-parameter KLs of 0.5 bits on average,
    grouped into groups of at most ``bits_per_group`` bits."""
    kl_bits = rng.exponential(0.5, D)
    return LevelArtifact(
        p_loc=rng.normal(0.0, 0.01, D).astype(np.float32),
        p_scale=np.exp(rng.uniform(np.log(0.0025), np.log(0.05), D)).astype(np.float32),
        avg_log_scale=(-4.0 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        grouping=compute_grouping(kl_bits, max_bits=bits_per_group),
    )


def make_cifar_artifact(seed: int) -> PriorArtifact:
    """A CIFAR prior of the trained artifact's shapes and magnitudes, with
    random values from ``seed``."""
    return make_artifact(CIFAR, seed)


def make_artifact(cfg, seed: int) -> PriorArtifact:
    """A prior of ``cfg``'s shapes (levels w, and h and hh for a patch
    config; (*k, cin, cout) conv kernels of its data_dim) with random values
    from ``seed``, as ``make_cifar_artifact`` draws them: no trained Kodak,
    audio or video prior of the full geometry is read."""
    rng = np.random.default_rng(seed)
    level = random_level(rng, cfg.n_coded_params, cfg.bits_per_group)
    upper = {}
    if cfg.patch:
        upper = {name: random_level(rng, cfg.n_inr_params, cfg.bits_per_group)
                 for name in ("h", "hh")}
    A = [rng.uniform(-0.1, 0.1, (d, d)).astype(np.float32) for d in cfg.layer_param_counts]
    chans = [(cfg.latent_dim, cfg.upsample_hidden), (cfg.upsample_hidden, cfg.upsample_hidden),
             (cfg.upsample_hidden, cfg.upsample_out)]
    up = {}
    for i, ((cin, cout), k) in enumerate(zip(chans, (5, 3, 3))):
        bound = 1.0 / np.sqrt(cin * k**cfg.data_dim)
        up[f"conv{i}"] = {
            "w": rng.uniform(-bound, bound,
                             (k,) * cfg.data_dim + (cin, cout)).astype(np.float32),
            "b": rng.uniform(-bound, bound, cout).astype(np.float32),
        }
    return PriorArtifact(config=cfg, kl_beta=1e-4, w=level, h=upper.get("h"),
                         hh=upper.get("hh"), A=A, up=up, codebook_seed=seed,
                         codebook_kind="threefry")


def kernel_inputs(art: PriorArtifact, B: int, P: int, gen: torch.Generator):
    """x (B, P, 32) and packed theta (B, 3267) on the card: Fourier+PE-like
    features and weights drawn from the artifact's prior through its A."""
    cfg = art.config
    dev = torch.device("cuda")
    n = cfg.n_inr_params
    x = torch.randn(B, P, cfg.input_dim, generator=gen, device=dev)
    loc = torch.as_tensor(art.w.p_loc[:n], device=dev)
    scale = torch.as_tensor(art.w.p_scale[:n], device=dev)
    h_w = loc + scale * torch.randn(B, n, generator=gen, device=dev)
    A = [torch.as_tensor(a, device=dev) for a in art.A]
    return x, fused_inr.materialize_theta(h_w, A, cfg)


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad kernel output: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    err = (got - ref).abs()
    bad = err > ATOL + RTOL * ref.abs()
    if bad.any():
        raise AssertionError(f"kernel disagrees with its plain version: max abs diff "
                             f"{err.max().item():.3e}, {int(bad.sum())} entries over "
                             f"atol {ATOL} + rtol {RTOL}")
    return err.max().item()


def max_err_of_max(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Max abs diff over the largest entry of ``ref``; raises above BWD_OF_MAX."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad {what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    err = (got - ref).abs().max().item()
    top = ref.abs().max().item()
    if err > BWD_OF_MAX * top:
        raise AssertionError(f"siren_bwd disagrees with its plain version in {what}: max abs "
                             f"diff {err:.3e} against largest entry {top:.3e}")
    return err


def f64_gaps(kernel: torch.Tensor, plain: torch.Tensor, ref64: torch.Tensor):
    """(kernel, plain version) max abs diff to an f64 evaluation, each over
    the f64 evaluation's largest entry."""
    top = ref64.abs().max()
    return tuple(((t.double() - ref64).abs().max() / top).item() for t in (kernel, plain))


def smooth_images(n: int, seed: int, hw=(32, 32)) -> np.ndarray:
    """n images (hw, 3) with values in [0.1, 0.9] from ``seed``: a few random
    plane waves per channel. CIFAR-sized by default."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]), indexing="ij")
    f = rng.uniform(0.5, 3.0, (n, 3, 2, 2))
    ph = rng.uniform(0, 2 * np.pi, (n, 3, 2))
    waves = sum(np.sin(2 * np.pi * (f[..., k, 0, None, None] * xx + f[..., k, 1, None, None] * yy)
                       + ph[..., k, None, None]) for k in range(2))
    return (0.5 + 0.2 * waves).transpose(0, 2, 3, 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_s() -> float:
    """The rate at which ``torch.cuda._sleep`` spins, timed once by events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    torch.cuda.synchronize()
    return 1e7 / (start.elapsed_time(end) / 1e3)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn`` by CUDA events. The calls are
    queued behind a spinning kernel that outlasts the host's queueing of
    them (twice one call's host time per call, plus 1 ms), so the events time
    the card's work back to back, not the host's launch rate, which varies
    with the load on the machine's CPU."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * iters * host_s + 1e-3) * sleep_cycles_per_s()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_by_kernel(fn, n: int):
    """(device microseconds, wall microseconds, {kernel name: device
    microseconds}) of ``n`` calls of ``fn`` under torch.profiler: device
    time from its CUDA kernel events, wall time of the same calls between
    ``torch.cuda.synchronize()`` calls, so both come from one window. A
    first profiled window, not read, takes the profiler's start-up cost."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_kernel.values())
    if total <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total, wall_us, by_kernel


@contextlib.contextmanager
def stack(fn):
    """``mappings.lpe_to_pe`` on the conv stack ``fn`` for the duration."""
    saved = mappings.STACK
    mappings.STACK = fn
    try:
        yield
    finally:
        mappings.STACK = saved


# The precision modes the smoke compares: the ambient (TF32 in cuBLAS and
# cuDNN, what a user's run gets) and --precision highest (exact f32).
MODES = ("ambient", "highest")


def by_mode(fn) -> dict:
    """``fn()`` under the ambient and under ``--precision highest``, in turns
    ambient, highest, highest, ambient: {mode: [first, second]}."""
    out = {m: [] for m in MODES}
    for m in ("ambient", "highest", "highest", "ambient"):
        with platform.ambient(None if m == "ambient" else m):
            out[m].append(fn())
    return out


def mode_line(what: str, t: dict) -> str:
    """One line of ``by_mode`` times in seconds, printed in ms: each mode's
    two, and the ratio of the means (highest over ambient)."""
    ratio = sum(t["highest"]) / sum(t["ambient"])
    return (f"{what}: ambient (TF32) {1e3 * t['ambient'][0]:.4f} / "
            f"{1e3 * t['ambient'][1]:.4f}, highest (exact) {1e3 * t['highest'][0]:.4f} / "
            f"{1e3 * t['highest'][1]:.4f} ms; highest / ambient {ratio:.3f}")


# the products whose precision the TF32 flags decide
PRODUCTS = {"matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "baddbmm", "addmm", "einsum",
            "linear", "conv1d", "conv2d", "conv3d"}


class FlagRecorder(TorchFunctionMode):
    """Records (cuBLAS TF32, cuDNN TF32) at every product, under the label of
    the innermost ``labelled`` function running."""

    def __init__(self):
        super().__init__()
        self.label = [None]
        self.seen: dict = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in PRODUCTS:
            self.seen.setdefault(self.label[-1], set()).add(
                (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))

    def labelled(self, label: str, fn):
        def wrapped(*a, **kw):
            self.label.append(label)
            try:
                return fn(*a, **kw)
            finally:
                self.label.pop()
        return wrapped


@contextlib.contextmanager
def recording_flags(rec: FlagRecorder):
    """``rec`` on, and the encode's parts labelled: phase 1
    (``progressive.optimize``), the finetunes (``encoder.optimize``), the A*
    scoring (``encoder.encode_step_level``) and the final decode."""
    parts = [(progressive, "optimize", "phase 1"), (encoder, "optimize", "finetunes"),
             (encoder, "encode_step_level", "A* scoring"), (progressive, "decode", "decode")]
    saved = [getattr(m, n) for m, n, _ in parts]
    for (m, n, label), f in zip(parts, saved):
        setattr(m, n, rec.labelled(label, f))
    try:
        with rec:
            yield
    finally:
        for (m, n, _), f in zip(parts, saved):
            setattr(m, n, f)


def as_f64(obj):
    """``obj`` (a codec, or anything of tensors in dataclasses, dicts and
    tuples) with every floating tensor in float64."""
    if torch.is_tensor(obj):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: as_f64(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: as_f64(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(as_f64(v) for v in obj)
    return obj


def decode_f64(art, idx, X, cfg) -> torch.Tensor:
    """An f64 evaluation of ``decode`` on the CPU (the plain SIREN chain, the
    plain conv stack) from the same f32 inputs: the exact answer that the
    f32 decodes are held to."""
    codec = as_f64(init_codec(art, next(iter(idx.values())).shape[0], device="cpu")[0])
    saved = decoder.inr_forward_fused
    decoder.inr_forward_fused = inr_forward
    try:
        with stack(apply_upsample):
            return decode(codec, idx, X, cfg)
    finally:
        decoder.inr_forward_fused = saved


def zero_launches() -> None:
    torch.cuda.synchronize()
    for k in fused_inr.launches:
        fused_inr.launches[k] = 0


def read_launches(epochs: int, what: str) -> dict:
    """The launch counts since ``zero_launches``: siren_bwd once per epoch,
    siren_fwd once per epoch plus the final decode at least."""
    torch.cuda.synchronize()
    launched = dict(fused_inr.launches)
    print(f"kernel launches in {what}: {launched}; epochs run {epochs}")
    if launched["siren_bwd"] != epochs or launched["siren_fwd"] < epochs + 1:
        raise AssertionError(f"{what} did not launch siren_bwd once per epoch and siren_fwd "
                             "once per epoch plus the decode")
    return launched


def wall_s(fn, reps: int) -> float:
    """Host seconds per call of ``fn`` after one warm call, synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def check_bitstream(codec, res, X, cfg, art, what: str) -> int:
    """Write ``res``'s bitstream, read it back, decode it on the card: the
    reconstruction must equal compress's exactly. Returns the byte count."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bitstream_test_id_0.rctb")
        nbytes = write_bitstream(path, res.indices, config_name=cfg.name,
                                 codebook_seed=art.codebook_seed,
                                 codebook_kind=art.codebook_kind,
                                 bits_per_group=cfg.bits_per_group)
        _, idx_back = read_bitstream(path)
    y_back = decode(codec, idx_back, X, cfg).cpu().numpy()
    if not np.isfinite(y_back).all() or not np.array_equal(y_back, res.reconstruction):
        raise AssertionError(f"{what}: the decoded bitstream is not compress's reconstruction")
    print(f"{what}: bitstream {nbytes} bytes, read back and decoded on the card: equal to "
          "compress's reconstruction (exactly)")
    return nbytes


class Crash(RuntimeError):
    """Raised by the replaced snapshot writer to simulate a crash."""


@contextlib.contextmanager
def crash_after_first_snapshot(of: str, level=None):
    """``encode_state.save_encode_state`` writes its snapshot, then raises
    Crash at the first snapshot of ``of`` ('phase1' or 'coding'; with
    ``level``, the coding loop's first at that level)."""
    save = encode_state.save_encode_state

    def crashing(path, state, **kw):
        save(path, state, **kw)
        extra = kw["extra"]
        if ("level" in extra) == (of == "coding") and level in (None, extra.get("level")):
            raise Crash(of)

    encode_state.save_encode_state = crashing
    try:
        yield
    finally:
        encode_state.save_encode_state = save


def same_posteriors(a, b) -> bool:
    """Every level's posteriors bitwise equal."""
    return all(torch.equal(getattr(a.level(n).q, f), getattr(b.level(n).q, f))
               for n in ("w", "h", "hh") if a.level(n) is not None
               for f in ("loc", "log_scale"))


# The patch encodes (Kodak, audio, video) and protein's are cut in depth
# only: phase 1 30,000 -> 30 epochs, and every finetune (w: max(30000 //
# n_groups, 50) epochs, h and hh: max(15000 // n_groups, 20)) -> 1, so that
# every group of every level is coded inside the time limit.
CUT_PHASE1_EPOCHS = 30
# exported media read back against the decode, (atol, rtol): 16-bit PCM;
# coordinates printed to 1e-3 A (half of it, with rtol 1e-7 for their f32
# rounding); NPZ exact
READ_BACK_TOL = {"wav": (1 / 32767, 0.0), "pdb": (5e-4, 1e-7), "npz": (0.0, 0.0)}
# words in the names of the conv stack's cuDNN kernels (convolutions, their
# data gradients, cuDNN's layout transforms), not in cuBLAS's GEMMs
CONV_KERNEL_WORDS = ("conv", "dgrad", "fprop", "wgrad", "implicit", "fft", "cudnn")
CUT_FINETUNE_EPOCHS = 1
REMAT_EPOCHS = 5
SAVE_EVERY = 10


def kodak_data(seed: int):
    """One smooth 512 x 768 image, as cli/compress encodes it: 96 patch rows."""
    hw = tuple(n * p for n, p in zip(KODAK.patch_nums, KODAK.pixel_sizes))
    return [smooth_images(1, seed, hw)[0]]


def audio_data(seed: int):
    """One 3 s speech-like clip at 16 kHz (48,000 samples): 60 patch rows."""
    return [synthetic.speech_like_clip(np.random.default_rng(seed), 48000)]


def video_data(seed: int):
    """One smooth 24 x 128 x 128 x 3 clip: 64 patch rows."""
    return [synthetic.smooth_signal(np.random.default_rng(seed), (24, 128, 128), 3)]


def protein_data(seed: int):
    """A test batch of 1,000 C-alpha backbones of 96 residues."""
    rng = np.random.default_rng(seed)
    return [synthetic.protein_backbone(rng, 96) for _ in range(1000)]


def ptxas_by_instance(log: str) -> dict:
    """{instance name: {"registers", "spill_stores", "spill_loads"}} of one
    kernel library, from nvcc's ``-Xptxas -v`` lines."""
    out, inst = {}, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            L, in0, hid, outw = map(int, m.groups())
            inst = fused_inr.instance_name(
                fused_inr.instance((in0,) + (hid,) * (L - 1) + (outw,)) if in0 else 0)
            out[inst] = {}
            continue
        m = PTXAS_SPILL.search(line)
        if inst and m:
            out[inst]["spill_stores"], out[inst]["spill_loads"] = int(m[1]), int(m[2])
        m = PTXAS_REGS.search(line)
        if inst and m:
            out[inst]["registers"] = int(m[1])
    return out


def instance_report(name: str, dims, B: int, P: int) -> dict:
    """The instance of kernel ``name`` that these widths take, its launch
    plan at B samples of P pixels and ptxas' registers and spills for it
    (from its build's log); raises if a fixed-width instance spills."""
    plan = fused_inr.launch_plan(name, list(dims), B, P)
    inst = fused_inr.instance_name(plan["instance"])
    rep = {"instance": inst, "plan": plan,
           "ptxas": ptxas_by_instance(_build.build(name).log).get(inst)}
    if plan["instance"] != fused_inr.instance(dims):
        raise AssertionError(f"{name}_plan names instance {inst} for widths {list(dims)}, the "
                             f"wrapper {fused_inr.instance_name(fused_inr.instance(dims))}")
    if plan["instance"] != fused_inr.RUNTIME_INSTANCE and (
            rep["ptxas"] is None or rep["ptxas"]["spill_stores"] or rep["ptxas"]["spill_loads"]):
        raise AssertionError(f"{name}'s fixed-width instance {inst} spills or was not reported "
                             f"by ptxas: {rep['ptxas']}")
    return rep


def fwd_entry(x, theta, dims, w0: float, errs: list, card: str, label: str) -> dict:
    """siren_fwd (one sample per block, the main path's launch) held against
    its plain version, its and the plain version's gaps to an f64 evaluation
    and their ratio reported, timed, with its bound and its instance;
    appends its disagreement to ``errs``."""
    B, P = x.shape[:2]
    ref = fused_inr.siren_forward_reference(x, theta, dims, w0)
    got = fused_inr.siren_forward(x, theta, dims, w0, samples_per_block=1)
    torch.cuda.synchronize()
    errs.append(max_err(got, ref))
    gap = f64_gaps(got, ref, fused_inr.siren_forward_reference(x.double(), theta.double(),
                                                               dims, w0))
    rep = instance_report("siren_fwd", dims, B, P)
    fwd = {"shape": [B, P], "widths": list(dims), "max_abs_err": errs[-1], "f64_gaps": gap,
           "f64_ratio": gap[0] / gap[1],
           "ms": cuda_ms(lambda: fused_inr.siren_forward(x, theta, dims, w0, 1), 50),
           "plain_ms": cuda_ms(lambda: fused_inr.siren_forward_reference(x, theta, dims, w0), 20),
           **rep}
    flops, nbytes = fwd_work(x, theta, dims)
    fwd["bound_ms"], fwd["bound_by"], route, _ = bounds(flops, nbytes)
    plan = rep["plan"]
    print(f"{label} siren_fwd B={B} P={P} widths {list(dims)}: instance {rep['instance']} "
          f"({plan['pixels_per_block']} pixels a block, {plan['blocks']} blocks, "
          f"{plan['blocks_per_sm']} per SM; ptxas {rep['ptxas']}); max abs diff {errs[-1]:.3e} "
          f"(atol {ATOL}, rtol {RTOL}); vs an f64 evaluation {gap[0]:.3e} kernel, {gap[1]:.3e} "
          f"plain version (ratio {fwd['f64_ratio']:.3f}); {fwd['ms']:.4f} ms, plain version "
          f"{fwd['plain_ms']:.4f} ms, bound "
          f"{fwd['bound_ms']:.4f} ms by {fwd['bound_by']} ({flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB; operations term {route}) [{card}]")
    return fwd


def bwd_entry(x, theta, dy, dims, w0: float, bwd_errs: list, card: str, label: str) -> dict:
    """siren_bwd held against its plain version (two launches bitwise
    equal), its and the plain version's gaps to an f64 evaluation and their
    ratios reported, timed, with its bound and its instance; appends its
    disagreements to ``bwd_errs``."""
    B, P = x.shape[:2]
    got = fused_inr.siren_backward(x, theta, dy, dims, w0)
    again = fused_inr.siren_backward(x, theta, dy, dims, w0)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"two {label} siren_bwd launches at P={P} differ")
    refs = fused_inr.siren_backward_reference(x, theta, dy, dims, w0)
    e = (max_err_of_max(got[0], refs[0], "dx"), max_err_of_max(got[1], refs[1], "dtheta"))
    bwd_errs += e
    ref64 = fused_inr.siren_backward_reference(x.double(), theta.double(), dy.double(), dims, w0)
    gaps = [f64_gaps(k, r, r64) for k, r, r64 in zip(got, refs, ref64)]
    del ref64, refs, again
    rep = instance_report("siren_bwd", dims, B, P)
    bwd = {"shape": [B, P], "widths": list(dims), "max_abs_err": max(e), "f64_gaps": gaps,
           "f64_ratio": max(k / p for k, p in gaps),
           "ms": cuda_ms(lambda: fused_inr.siren_backward(x, theta, dy, dims, w0), 10),
           "plain_ms": cuda_ms(lambda: fused_inr.siren_backward_reference(
               x, theta, dy, dims, w0), 3, 1), **rep}
    flops, nbytes = bwd_work(x, theta, dy, dims)
    bwd["bound_ms"], bwd["bound_by"], route, _ = bounds(flops, nbytes)
    plan = rep["plan"]
    print(f"{label} siren_bwd B={B} P={P} widths {list(dims)}: instance {rep['instance']} "
          f"({plan['warps_per_block']} warps, {plan['smem_bytes_per_block']} bytes a block, "
          f"{plan['blocks_per_sm']} per SM; ptxas {rep['ptxas']}); max abs diff dx {e[0]:.3e}, "
          f"dtheta {e[1]:.3e} (tolerance {BWD_OF_MAX} of the largest entry); two launches "
          f"bitwise equal; vs an f64 evaluation dx {gaps[0][0]:.3e} kernel, {gaps[0][1]:.3e} "
          f"plain, dtheta {gaps[1][0]:.3e} kernel, {gaps[1][1]:.3e} plain (larger ratio "
          f"{bwd['f64_ratio']:.3f}); {bwd['ms']:.4f} ms, "
          f"plain version {bwd['plain_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} ms by "
          f"{bwd['bound_by']} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; operations term "
          f"{route}) [{card}]")
    return bwd


def kernel_checks(art, B: int, S: int, gen, card: str, errs: list, bwd_errs: list,
                  label: str, encode_fwd: bool = False):
    """siren_fwd at decode's B and siren_bwd at the encode's B * S, at the
    config's P and widths, each held against its plain version (two
    siren_bwd launches bitwise equal), its gap to an f64 evaluation beside
    the plain version's, timed, with its bound and the instance it runs on;
    with ``encode_fwd`` siren_fwd at B * S too (its entry's "encode").
    Appends the disagreements to ``errs`` and ``bwd_errs``; returns the two
    kernels' entries."""
    cfg = art.config
    dims, P = cfg.net_dims, cfg.n_pixels
    x, theta = kernel_inputs(art, B, P, gen)
    fwd = fwd_entry(x, theta, dims, cfg.w0, errs, card, label)
    del x, theta
    xb, thetab = kernel_inputs(art, B * S, P, gen)
    dyb = torch.randn(B * S, P, cfg.output_dim, generator=gen, device="cuda")
    bwd = bwd_entry(xb, thetab, dyb, dims, cfg.w0, bwd_errs, card, label)
    if encode_fwd:
        fwd["encode"] = fwd_entry(xb, thetab, dims, cfg.w0, errs, card, f"{label} encode's")
    return fwd, bwd


def instance_rows(name: str, cifar: dict, paths: dict, train_shapes: dict,
                  runtime: dict) -> list:
    """Every instance of kernel ``name`` that the run timed, one row per
    shape: where, instance, widths, shape, times, bound, ptxas."""
    entries = [("cifar", cifar)]
    for where, c in {**paths, **train_shapes}.items():
        e = c[name]
        entries.append((where, e))
        if "encode" in e:
            entries.append((f"{where} encode", e["encode"]))
    entries += [("run-time tiny", runtime[name]), ("run-time 64-64-40-7", runtime[name]["wide"])]
    keys = ("instance", "widths", "shape", "ms", "plain_ms", "bound_ms", "bound_by", "f64_ratio",
            "ptxas")
    return [{"where": where, **{k: e[k] for k in keys}} for where, e in entries]


def runtime_instance_checks(seed: int, card: str, errs: list, bwd_errs: list) -> dict:
    """The run-time-width instance (no full-size path runs it): TINY's
    widths 32-8-8-3 at B = 500 (siren_fwd) and 2,500 (siren_bwd), P = 256,
    on a TINY prior from ``seed``, timed, and 64-64-40-7 at B = 64, P = 1,000;
    each held against its plain version at the smoke's tolerances, with its
    and the plain version's gaps to an f64 evaluation printed. Returns the
    two kernels' TINY entries."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    fwd, bwd = kernel_checks(make_artifact(TINY, seed), 500, SAMPLE_SIZE, gen, card, errs,
                             bwd_errs, "TINY (run-time instance)")
    dims = [64, 64, 40, 7]
    x = torch.randn(64, 1000, dims[0], generator=gen, device="cuda")
    theta = 0.05 * torch.randn(64, fused_inr.theta_size(dims), generator=gen, device="cuda")
    dy = torch.randn(64, 1000, dims[-1], generator=gen, device="cuda")
    fwd["wide"] = fwd_entry(x, theta, dims, 30.0, errs, card, "64-64-40-7")
    bwd["wide"] = bwd_entry(x, theta, dy, dims, 30.0, bwd_errs, card, "64-64-40-7")
    return {"siren_fwd": fwd, "siren_bwd": bwd}


def export_checks(art, idx, y: torch.Tensor, label: str) -> dict:
    """``cli.decompress --export_media`` on the card on a bitstream of
    ``idx``: its decode must equal ``y`` (the card's decode of the same
    indices) exactly, and each file must read back within ``READ_BACK_TOL``
    of it: a WAV (the decode clipped to [0, 1]), a PDB's coordinates, an
    NPZ."""
    cfg = art.config
    with tempfile.TemporaryDirectory() as tmp:
        prior = os.path.join(tmp, "prior.npz")
        save_prior_artifact(prior, art)
        path = os.path.join(tmp, "bitstream_test_id_0.rctb")
        write_bitstream(path, idx, config_name=cfg.name, codebook_seed=art.codebook_seed,
                        codebook_kind=art.codebook_kind, bits_per_group=cfg.bits_per_group)
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        y_cli = decompress_cli.main(["--bitstream", path, "--prior_path", prior, "--save_dir",
                                     out, "--export_media"])
        cli_s = time.perf_counter() - t0
        if not np.array_equal(y_cli, y.cpu().numpy()):
            raise AssertionError(f"{label}: cli.decompress on the card differs from decode")
        data = export.reassemble(y_cli, cfg)
        files = sorted((f for f in os.listdir(out) if not f.endswith(".npy")),
                       key=lambda f: int(f.rsplit("_", 1)[1].split(".")[0]))
        kind = files[0].rsplit(".", 1)[1]
        if len(files) != len(data) or kind not in READ_BACK_TOL:
            raise AssertionError(f"{label}: {len(files)} media files ({kind}) for {len(data)} "
                                 "datapoints")
        atol, rtol = READ_BACK_TOL[kind]
        worst = 0.0
        for f, datum in zip(files, data):
            p = os.path.join(out, f)
            if kind == "wav":
                got, want = export.read_wav(p), np.clip(datum[:, 0], 0, 1)
            elif kind == "pdb":
                got, want = protein.parse_pdb_ca(p), datum * protein.SCALE
            else:
                with np.load(p) as z:
                    got, want = z["data"], datum
            if got.shape != want.shape or (np.abs(got - want) > atol + rtol * np.abs(want)).any():
                raise AssertionError(f"{label}: {f} reads back {np.abs(got - want).max():.3e} "
                                     f"from the decode (atol {atol:.3e}, rtol {rtol})")
            worst = max(worst, float(np.abs(got - want).max()))
    print(f"{label} export: cli.decompress --export_media on the card ({cli_s:.2f} s with "
          f"init_codec): decode equal to the card's; {len(files)} {kind} files read back within "
          f"{worst:.3e} of it (atol {atol:.3e}, rtol {rtol})")
    return {"files": len(files), "kind": kind, "max_read_back_err": worst, "cli_s": cli_s}


def config_phases(cfg, data, seed: int, card: str, errs: list, bwd_errs: list, label: str,
                  small_bwd: bool = False, remat: bool = False, resume: bool = False,
                  stack_check: bool = False, media: bool = False, modes: bool = False,
                  flags: bool = False, instances: bool = False) -> dict:
    """The phases of one configuration at its full geometry (S = 5) on a
    random prior of its shapes from ``seed`` (``make_artifact``: no trained
    prior is read) and the datapoints ``data``: both kernels at its shapes,
    decode, an encode coding every group of every level, epoch_s under each
    conv stack; with ``small_bwd`` siren_bwd at B = 20; with ``stack_check``
    the phase stack held against the plain one on the card; with ``remat``
    epochs with remat off, on, on, off (off twice: the epochs repeat bit for
    bit); with ``resume`` a crash at the first level-h snapshot resumed;
    with ``media`` the export; with ``modes`` epoch_s under each precision
    mode (``by_mode``); with ``flags`` the TF32 flags at every product of
    the encode, by part (``FlagRecorder``); with ``instances`` siren_fwd at
    the encode's B * S too. The encode and the epochs run
    at the ambient precision, as a user's; decode is exact in every mode.
    Appends the kernels' disagreements to ``errs`` and ``bwd_errs``;
    returns the numbers the kernels line and the summary print."""
    S = SAMPLE_SIZE
    X_np, Y_np = points_from_data(data, cfg)
    R = X_np.shape[0]
    out = {"rows": R}
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    t0 = time.perf_counter()
    art = make_artifact(cfg, seed)
    print(f"{label} prior from seed {seed}: "
          + ", ".join(f"{n} D={getattr(art, n).grouping.n_params} "
                      f"{getattr(art, n).grouping.n_groups} groups" for n in ("w", "h", "hh")
                      if getattr(art, n) is not None)
          + f" ({time.perf_counter() - t0:.2f} s)")

    with phase(f"{label} kernels"), exact_f32():
        out["siren_fwd"], out["siren_bwd"] = kernel_checks(
            art, R, S, gen, card, errs, bwd_errs, label, encode_fwd=instances)
        if small_bwd:
            # kodak_mini's one image at S = 5 is 20 one-sample blocks on 132 SMs
            bwd = out["siren_bwd"]
            xs, ts = kernel_inputs(art, 20, 1024, gen)
            dys = torch.randn(20, 1024, cfg.output_dim, generator=gen, device="cuda")
            small_ms = cuda_ms(lambda: fused_inr.siren_backward(xs, ts, dys, cfg.net_dims,
                                                                cfg.w0), 20)
            print(f"siren_bwd at B=20 P=1024 (kodak_mini's one image at S=5): {small_ms:.4f} ms, "
                  f"{1e6 * small_ms / (20 * 1024):.3f} ns per sample-pixel against "
                  f"{1e6 * bwd['ms'] / (R * S * cfg.n_pixels):.3f} at B={R * S} "
                  f"P={cfg.n_pixels} [{card}]")
            bwd["small_ms"] = small_ms

    with phase(f"{label} decode"):
        perm_s = 0.0
        if cfg.patch:
            t0 = time.perf_counter()
            decoder.patch_permutations(R, cfg.n_coded_params)
            perm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        codec, state0 = init_codec(art, R)
        print(f"init_codec R={R}: {time.perf_counter() - t0:.2f} s on the host (level w's "
              f"cross-patch permutations {R} x {cfg.n_coded_params}: {perm_s:.3f} s; "
              f"{len(codec.level_names)} 2^16-sample codebooks)")
        rows = {n: state0.level(n).q.loc.shape[0] for n in codec.level_names}
        rng = np.random.default_rng(seed)
        idx = {n: rng.integers(0, 2**cfg.bits_per_group, (rows[n], codec.meta(n).n_groups))
               for n in codec.level_names}
        X, Y = torch.from_numpy(X_np).cuda(), torch.from_numpy(Y_np).cuda()
        zero_launches()
        y = decode(codec, idx, X, cfg)
        torch.cuda.synchronize()
        launched_dec = dict(fused_inr.launches)
        print(f"kernel launches in {label} decode: {launched_dec}; rows per level {rows}")
        if launched_dec["siren_fwd"] < 1:
            raise AssertionError(f"{label} decode did not go through the siren_fwd kernel")
        if y.shape != (R, cfg.n_pixels, cfg.output_dim) or not torch.isfinite(y).all():
            raise AssertionError(f"{label} decode output: shape {tuple(y.shape)}")
        y_cpu = decode(init_codec(art, R, device="cpu")[0], idx, X_np, cfg)
        y64 = decode_f64(art, idx, X_np, cfg)
        card_gap = (y.cpu().double() - y64).abs().max().item()
        cpu_gap = (y_cpu.double() - y64).abs().max().item()
        print(f"{label} decode, all {R} rows{' (the whole stitched datapoint)' if cfg.patch else ''}"
              f": card vs CPU max abs diff {(y.cpu() - y_cpu).abs().max().item():.3e}; vs an f64 "
              f"evaluation {card_gap:.3e} card, {cpu_gap:.3e} CPU (tolerance: the card at most "
              f"{DECODE_F64_RATIO} times the CPU's gap); output range [{y64.min().item():.4f}, "
              f"{y64.max().item():.4f}]")
        if card_gap > DECODE_F64_RATIO * cpu_gap:
            raise AssertionError(f"{label} decode on the card is further from the f64 "
                                 "evaluation than the CPU's f32 decode allows")
        del y_cpu, y64
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dec_s = wall_s(lambda: decode(codec, idx, X, cfg), 5)
        dec_peak = torch.cuda.max_memory_allocated()
        busy_us, wall_us, by_kernel = device_time_by_kernel(lambda: decode(codec, idx, X, cfg), 5)
        out["decode"] = {"wall_ms": 1e3 * dec_s, "device_ms": busy_us / 5e3,
                         "idle": 1 - busy_us / wall_us, "peak_mib": dec_peak / 2**20}
        print(f"{label} decode R={R}: wall {1e3 * dec_s:.3f} ms (mean of 5 after a warm call), "
              f"device time {busy_us / 5e3:.3f} ms per decode under the profiler in "
              f"{wall_us / 5e3:.3f} ms of its wall, idle share {1 - busy_us / wall_us:.4f}; "
              f"peak device memory {dec_peak / 2**20:.1f} MiB [{card}]")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {us / 5e3:8.4f} ms/decode {100 * us / busy_us:5.1f}%  {name[:100]}")

    if media:
        with phase(f"{label} export"):
            out["export"] = export_checks(art, idx, y, label)

    finetunes = {n: CUT_FINETUNE_EPOCHS for n in codec.level_names}

    def compress(state, generator_seed=seed, **kw):
        return progressive.compress(codec, state, X, Y, cfg,
                                    torch.Generator(device="cuda").manual_seed(generator_seed),
                                    n_optimize_epochs=CUT_PHASE1_EPOCHS, sample_size=S,
                                    finetune_overrides=finetunes, **kw)

    def epochs(n, remat=False):
        return encoder.optimize(codec, state0, X, Y, cfg, gen, n_epochs=n, sample_size=S,
                                remat=remat)

    if stack_check:
        with phase(f"{label} conv stacks"), exact_f32():
            lpe = torch.randn(R, S, *cfg.lpe_spatial, cfg.latent_dim, generator=gen,
                              device="cuda")
            with stack(apply_upsample_phased):
                phase_pe = mappings.lpe_to_pe(codec.up, lpe, cfg)
            with stack(apply_upsample):
                plain_pe = mappings.lpe_to_pe(codec.up, lpe, cfg)
            torch.cuda.synchronize()
            stack_err = (phase_pe - plain_pe).abs().max().item()
            print(f"{label} phase stack vs plain stack on the card through lpe_to_pe, "
                  f"{tuple(lpe.shape)} -> {tuple(plain_pe.shape)}: max abs diff {stack_err:.3e} "
                  f"(atol {STACK_TOL['atol']}, rtol {STACK_TOL['rtol']})")
            torch.testing.assert_close(phase_pe, plain_pe, **STACK_TOL)
            out["stack_err"] = stack_err
            del lpe, plain_pe, phase_pe

    with phase(f"{label} encode"):
        rec = FlagRecorder()
        zero_launches()
        t0 = time.perf_counter()
        with recording_flags(rec) if flags else contextlib.nullcontext():
            res = compress(state0)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t = res.timings
        groups = {n: codec.meta(n).n_groups for n in codec.level_names}
        launched_enc = read_launches(t["phase1_epochs"] + t["finetune_epochs"], f"{label} encode")
        if not all(res.state.level(n).compressed.all() for n in codec.level_names):
            raise AssertionError(f"the {label} encode left groups uncoded")
        print(f"{label} encode (reference schedule, phase 1 {t['phase1_epochs']} epochs, 1-epoch "
              f"finetunes; groups coded "
              + ", ".join(f"{n} {groups[n]}" for n in reversed(codec.level_names))
              + f", all): wall {enc_s:.3f} s (optimize {t['optimize_s']:.3f} s, code "
              f"{t['code_s']:.3f} s); distortion {np.mean(res.distortion):.4f} "
              f"({'RMSD' if cfg.name == 'protein' else 'PSNR dB'}) @ {res.bitrate:.4f} [{card}]")
        check_bitstream(codec, res, X, cfg, art, f"{label} encode")
        epochs(2)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        epochs(10)
        torch.cuda.synchronize()
        epoch_s = (time.perf_counter() - t0) / 10
        epoch_peak = torch.cuda.max_memory_allocated()
        step_s = {n: wall_s(lambda: encoder.encode_step(codec, state0, n), 5)
                  for n in reversed(codec.level_names)}
        out["encode"] = {"epoch_s": epoch_s, "peak_mib": epoch_peak / 2**20,
                         "code_step_s": step_s, "wall_s": enc_s}
        print(f"{label} epoch_s {epoch_s:.6f} (R={R}, S={S}, mean of 10 warm epochs), peak device "
              f"memory {epoch_peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB allocated before "
              f"the epochs); code_step_s "
              + ", ".join(f"{n} {v:.6f}" for n, v in step_s.items())
              + f" (one encode_step, mean of 5) [{card}]")
        busy_us, wall_us, by_kernel = device_time_by_kernel(lambda: epochs(1), 5)
        out["encode"]["idle"] = 1 - busy_us / wall_us
        out["encode"]["device_ms"] = busy_us / 5e3
        out["encode"]["conv_share"] = conv_share(by_kernel)
        print(f"{label} epoch under the profiler: {busy_us / 5e3:.3f} ms device time per epoch in "
              f"{wall_us / 5e3:.3f} ms wall, idle share {1 - busy_us / wall_us:.4f}; the conv "
              f"stack's cuDNN kernels {100 * out['encode']['conv_share']:.1f}%")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
            print(f"  {us / 5e3:8.4f} ms/epoch {100 * us / busy_us:5.1f}%  {name[:100]}")
        stacks = {"plain": apply_upsample, "phase": apply_upsample_phased}
        stack_s = {name: [] for name in stacks}
        for name in ("plain", "phase", "phase", "plain"):
            with stack(stacks[name]):
                stack_s[name].append(wall_s(lambda: epochs(5), 1) / 5)
        out["encode"]["epoch_s_by_stack"] = stack_s
        print(f"{label} epoch_s by conv stack (order plain, phase, phase, plain): "
              + ", ".join(f"{n} {v[0]:.6f} / {v[1]:.6f}" for n, v in stack_s.items())
              + f"; lpe_to_pe uses {mappings.STACK.__name__} [{card}]")
        if modes:
            out["encode"]["epoch_s_by_mode"] = by_mode(lambda: wall_s(lambda: epochs(10), 1) / 10)
            print(mode_line(f"{label} epoch_s (R={R}, S={S}, 10 warm epochs)",
                            out["encode"]["epoch_s_by_mode"]) + f" [{card}]")
            with platform.ambient("highest"):
                busy_hi, wall_hi, by_kernel_hi = device_time_by_kernel(lambda: epochs(1), 5)
            out["encode"]["highest"] = {"device_ms": busy_hi / 5e3, "idle": 1 - busy_hi / wall_hi,
                                        "conv_share": conv_share(by_kernel_hi)}
            print(f"{label} epoch under the profiler at --precision highest: "
                  f"{busy_hi / 5e3:.3f} ms device time per epoch in {wall_hi / 5e3:.3f} ms wall, "
                  f"idle share "
                  f"{1 - busy_hi / wall_hi:.4f}; the conv stack's cuDNN kernels "
                  f"{100 * conv_share(by_kernel_hi):.1f}% (ambient above: "
                  f"{out['encode']['device_ms']:.3f} ms, {100 * out['encode']['conv_share']:.1f}%) "
                  f"[{card}]")
        if flags:
            out["encode"]["flags"] = {k: sorted(v) for k, v in rec.seen.items()}
            print(f"{label} encode, (cuBLAS TF32, cuDNN TF32) at every product, by part: "
                  f"{out['encode']['flags']}")
            want = {"phase 1": [(True, True)], "finetunes": [(False, False)],
                    "A* scoring": [(False, False)], "decode": [(False, False)]}
            if out["encode"]["flags"] != want:
                raise AssertionError(f"{label}: the precision modes' auto did not run the "
                                     f"finetunes exact and phase 1 at TF32: want {want}")

    if remat:
        with phase(f"{label} remat"):
            def run(remat):
                g = torch.Generator(device="cuda").manual_seed(seed)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                st = encoder.optimize(codec, state0, X, Y, cfg, g, n_epochs=REMAT_EPOCHS,
                                      sample_size=S, remat=remat)
                torch.cuda.synchronize()
                return (st, (time.perf_counter() - t0) / REMAT_EPOCHS,
                        torch.cuda.max_memory_allocated())

            epochs(1, remat=True)
            runs = {False: [], True: []}
            for on in (False, True, True, False):
                runs[on].append(run(on))
            repeat = same_posteriors(runs[False][0][0], runs[False][1][0])
            equal = same_posteriors(runs[True][0][0], runs[False][0][0])
            out["remat"] = {k: {"epoch_s": [r[1] for r in v], "peak_mib": v[0][2] / 2**20}
                            for k, v in (("on", runs[True]), ("off", runs[False]))}
            print(f"{label} {REMAT_EPOCHS} epochs from one state and generator state (order off, "
                  f"on, on, off): remat on epoch_s {runs[True][0][1]:.6f} / "
                  f"{runs[True][1][1]:.6f}, peak {runs[True][0][2] / 2**20:.1f} MiB; off epoch_s "
                  f"{runs[False][0][1]:.6f} / {runs[False][1][1]:.6f}, peak "
                  f"{runs[False][0][2] / 2**20:.1f} MiB; off twice bitwise equal {repeat}; on vs "
                  f"off bitwise equal {equal} [{card}]")
            if not (repeat and equal):
                raise AssertionError(f"the {label} epochs do not repeat bit for bit, or remat "
                                     "changes the posteriors")

    if resume:
        with phase(f"{label} resume"):
            with tempfile.TemporaryDirectory() as tmp:
                extra = {"state_path": os.path.join(tmp, "enc_state.npz"),
                         "save_every": SAVE_EVERY,
                         "state_extra": {"prior_fingerprint": prior_fingerprint(art)}}
                with crash_after_first_snapshot("coding", level="h"):
                    try:
                        compress(state0, **extra)
                        raise AssertionError("no snapshot was taken at level h")
                    except Crash:
                        pass
                resume_kw, state = resume_from(extra["state_path"], art, "cuda")
                coded = {n: int(state.level(n).compressed.sum(1).max())
                         for n in codec.level_names}
                print(f"crashed after the first snapshot at level h; resuming with groups coded "
                      f"{coded}")
                res_r = compress(state, **extra, **resume_kw)
            indices_equal = all(np.array_equal(res_r.indices[n], res.indices[n])
                                for n in codec.level_names)
            posteriors_equal = same_posteriors(res_r.state, res.state)
            print(f"{label} encode crashed at level h and resumed vs uninterrupted: indices "
                  f"bitwise equal {indices_equal}, posteriors bitwise equal {posteriors_equal}")
            check_bitstream(codec, res_r, X, cfg, art, f"resumed {label} encode")
            if not (indices_equal and posteriors_equal):
                raise AssertionError(f"the resumed {label} encode differs from the uninterrupted "
                                     "one")
    key = label.lower()
    out["launches"] = {f"{key}_decode": launched_dec, f"{key}_encode": launched_enc}
    return out


def kodak_phases(seed: int, card: str, errs: list, bwd_errs: list) -> dict:
    """The phases at KODAK's full geometry (levels w, h, hh of 96, 6 and 1
    rows, P = 4,096, S = 5) on one smooth 512 x 768 image: both kernels at
    P = 4,096 (and siren_bwd at B = 20), decode, encode, remat, and a crash
    at level h resumed; epoch_s under each precision mode."""
    return config_phases(KODAK, kodak_data(seed), seed, card, errs, bwd_errs, "Kodak",
                         small_bwd=True, remat=True, resume=True, modes=True)


def modality_phases(seed: int, card: str, errs: list, bwd_errs: list) -> dict:
    """AUDIO (60 / 15 / 1 rows, P = 800, widths 32-32-32-32-1), VIDEO (64 / 4
    / 1 rows, P = 6,144, widths 34-32-32-32-3, the 3-D stack with its
    (6, 4, 4) factor) and PROTEIN (1,000 chains, P = 96, one level) at their
    full geometry, each with the export; video also with the phase stack
    held against the plain one, remat off/on/on/off (the epochs repeat bit
    for bit), a crash at level h resumed and epoch_s under each precision
    mode; audio's encode with its TF32 flags recorded (the per-modality
    auto: exact finetunes) and its epoch_s under each precision mode;
    audio's and video's kernels on their own fixed-width instances,
    siren_fwd at the encode's B * S too."""
    return {
        "audio": config_phases(AUDIO, audio_data(seed), seed, card, errs, bwd_errs, "Audio",
                               media=True, flags=True, modes=True, instances=True),
        "video": config_phases(VIDEO, video_data(seed), seed, card, errs, bwd_errs, "Video",
                               stack_check=True, remat=True, resume=True, media=True,
                               modes=True, instances=True),
        "protein": config_phases(PROTEIN, protein_data(seed), seed, card, errs, bwd_errs,
                                 "Protein", media=True),
    }


def determinism(codec, state0, X, Y, cfg, seed: int) -> dict:
    """Whether two 20-epoch optimize runs from one state and generator state
    agree bit for bit, as optimize runs them (cuDNN restricted to
    deterministic algorithms) and with cuDNN's own choice of algorithms,
    and epoch_s under each."""
    def run(n=20):
        g = torch.Generator(device=codec.device).manual_seed(seed)
        return encoder.optimize(codec, state0, X, Y, cfg, g, n_epochs=n,
                                sample_size=SAMPLE_SIZE)

    out = {"default": same_posteriors(run(), run()),
           "epoch_s_default": wall_s(lambda: run(10), 1) / 10}
    restricted = encoder.deterministic_convs
    encoder.deterministic_convs = contextlib.nullcontext
    try:
        out["cudnn_choice"] = same_posteriors(run(), run())
        out["epoch_s_cudnn_choice"] = wall_s(lambda: run(10), 1) / 10
    finally:
        encoder.deterministic_convs = restricted
    return out

# ------------------------------------------------------------ prior training

# The prior-training phases: CIFAR at the README's cli.train size, R =
# 2,000, cut in depth only (the reference's 550 EM iterations of 200 / 100
# epochs -> 4 iterations of 20 / 10); rd_sweep with the same cut and its
# encode cut as ENCODE_*'s (10 phase-1 epochs, 1-epoch finetunes); Kodak's
# three levels at 2 iterations of 3 epochs.
TRAIN_ROWS = 2000
TRAIN_EM = ["--n_em_iters", "4", "--first_epochs", "20", "--later_epochs", "10"]
TRAIN_CHUNKS = trainer.em_chunks(4, 10, 20, 10)
TRAIN_EPOCHS = sum(n * e for n, e in TRAIN_CHUNKS)
TRAIN_BITRATE = 2.0
KODAK_TRAIN_IMAGES = 4
KODAK_TRAIN = KODAK
# a decoded reconstruction, card against CPU: the tests' DECODE_TOL
DECODE_TOL = dict(atol=3e-5, rtol=1e-5)
# a trained state, card against CPU from one state and one noise draw: the
# tests' bound (tests/test_torch_trainer.py::_state_close): every leaf's
# difference within 1e-6 of its norm plus 1e-2 of the norm of the change
# the epoch made, every element within 2 lr (one normalised Adam step each
# way); the epoch's mse and KL at rtol 1e-4
TRAIN_LR = 2e-4
# kernel-name words of each part of a training epoch's device time, first
# match wins: cuDNN's convolutions include its FFT ones (fft2d_* and their
# complex "cf32" GEMMs); the real f32 GEMMs left are cuBLAS's, the
# A-transforms and their gradients
EPOCH_PARTS = (("siren_bwd", ("siren_bwd",)), ("siren_fwd", ("siren_fwd",)),
               ("conv stack (cuDNN)", CONV_KERNEL_WORDS + ("cf32",)),
               ("cuBLAS GEMMs (A-transforms and their gradients)", ("gemm", "gemv")))
OTHER_PART = "elementwise, reductions and copies (sampling, KL, Adam, layouts)"


def conv_share(by_kernel: dict) -> float:
    """The conv stack's cuDNN kernels' share of the device time."""
    conv = sum(us for name, us in by_kernel.items()
               if any(k in name.lower() for k in CONV_KERNEL_WORDS))
    return conv / sum(by_kernel.values())


def epoch_parts(by_kernel: dict) -> dict:
    """Device microseconds of each part of an epoch (``EPOCH_PARTS``)."""
    parts = {name: 0.0 for name, _ in EPOCH_PARTS}
    parts[OTHER_PART] = 0.0
    for kname, us in by_kernel.items():
        low = kname.lower()
        part = next((name for name, words in EPOCH_PARTS if any(w in low for w in words)),
                    OTHER_PART)
        parts[part] += us
    return parts


def epoch_pieces(state, cfg, gen) -> dict:
    """Device milliseconds by CUDA events of the pieces of a training epoch
    that the profiler's kernel names do not separate, each on its own at
    the epoch's shapes and precision (the ambient, deterministic cuDNN):
    the conv stack's forward, its data gradient (forward and input
    gradient, less the forward) and its weight gradient (forward and every
    gradient, less the forward and input gradient); the A-transforms'
    forward and gradients; and Adam's step over every leaf."""
    R = state.w.loc.shape[0]
    noise = trainer.draw_noise(state, cfg, 1, gen)
    lpe = (state.lpe.loc[:, None] + state.lpe.scale[:, None] * noise[0]).detach()
    up = {c: {k: v.detach().requires_grad_() for k, v in d.items()} for c, d in state.up.items()}
    weights = [v for d in up.values() for v in d.values()]
    lpe_g = lpe.clone().requires_grad_()
    dy = torch.randn(R, 1, cfg.n_pixels, cfg.upsample_out, generator=gen, device="cuda")
    h_w = (state.w.loc + state.w.scale * noise[1][:, 0]).detach().requires_grad_()
    A = [a.detach().requires_grad_() for a in state.A]
    dtheta = torch.randn(R, cfg.n_inr_params, generator=gen, device="cuda")
    with precision(), deterministic_convs():
        def stack_grads(of):
            return torch.autograd.grad(mappings.lpe_to_pe(up, lpe_g, cfg), of, dy)

        with torch.no_grad():
            t_fwd = cuda_ms(lambda: mappings.lpe_to_pe(up, lpe, cfg), 10)
            t_a = cuda_ms(lambda: fused_inr.materialize_theta(h_w, A, cfg), 10)
        t_in = cuda_ms(lambda: stack_grads([lpe_g]), 10)
        t_all = cuda_ms(lambda: stack_grads([lpe_g, *weights]), 10)
        t_a_all = cuda_ms(lambda: torch.autograd.grad(
            fused_inr.materialize_theta(h_w, A, cfg), [h_w, *A], dtheta), 10)
    leaves = [t.clone() for t in state.leaves()]
    grads = [torch.randn(t.shape, generator=gen, device="cuda") for t in leaves]
    adam0 = encoder.adam_init(leaves)
    adam_ms = cuda_ms(lambda: encoder.adam_step(leaves, grads, adam0, TRAIN_LR), 10)
    return {"conv forward": t_fwd, "conv data gradient": t_in - t_fwd,
            "conv weight gradient": t_all - t_in, "A-transforms forward": t_a,
            "A-transforms gradients": t_a_all - t_a, "Adam step": adam_ms}


def states_close(got: trainer.PriorState, want: trainer.PriorState,
                 start: trainer.PriorState, steps: int) -> float:
    """Raises unless ``got`` is within the tests' trained-state bound of
    ``want`` (both trained from ``start`` for ``steps`` Adam steps at
    TRAIN_LR); returns the largest leaf's difference norm over its bound."""
    worst = 0.0
    for g, w, w0 in zip(got.leaves(), want.leaves(), start.leaves(), strict=True):
        g, w, w0 = (t.detach().double().cpu() for t in (g, w, w0))
        bound = 1e-6 * w.norm().item() + 1e-2 * (w - w0).norm().item()
        gap = (g - w).norm().item()
        worst = max(worst, gap / bound)
        if gap > bound or (g - w).abs().max().item() > (1e-6 * w.abs().max().item()
                                                        + 2 * TRAIN_LR * steps):
            raise AssertionError(f"trained state leaf {tuple(w.shape)}: difference norm "
                                 f"{gap:.3e} against its bound {bound:.3e}")
    return worst


class ProgressFiltered(io.TextIOBase):
    """A text stream that passes lines on to ``out`` but compress's
    per-group progress lines ("[w] 12/554"), which it counts."""

    LINE = re.compile(r"^\[(w|h|hh)\] \d+/\d+$")

    def __init__(self, out):
        self.out, self.buf, self.dropped = out, "", 0

    def write(self, text: str) -> int:
        *lines, self.buf = (self.buf + text).split("\n")
        for line in lines:
            if self.LINE.match(line):
                self.dropped += 1
            else:
                self.out.write(line + "\n")
        return len(text)

    def flush(self) -> None:
        self.out.flush()


def same_state(a: trainer.PriorState, b: trainer.PriorState) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves(), strict=True))


@contextlib.contextmanager
def replaced(module, name: str, fn):
    """``module.name`` replaced by ``fn(original)`` for the duration."""
    saved = getattr(module, name)
    setattr(module, name, fn(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def train_phases(seed: int, card: str, errs: list, bwd_errs: list, tmp_root: str) -> dict:
    """Prior training on the card: cli.train at CIFAR R = 2,000 on PNGs from
    ``seed``, the trained prior decoded card against CPU; an epoch's time,
    profile and peak memory; determinism (two runs, a save and load, card
    against CPU); cli.rd_sweep (train, encode every group, a crash after
    the first train-state snapshot resumed twice); Kodak's three levels.
    The PNGs and cli.train's argv and artifact stay in ``tmp_root`` for
    the scale-out phases."""
    cfg = CIFAR
    out = {}
    with phase("CIFAR train"):
        train_dir = os.path.join(tmp_root, "train")
        os.makedirs(train_dir)
        t0 = time.perf_counter()
        for i, img in enumerate(smooth_images(TRAIN_ROWS, seed + 7)):
            export.write_png(os.path.join(train_dir, f"{i:04d}.png"), img)
        png_s = time.perf_counter() - t0
        saving = os.path.join(tmp_root, "prior")
        zero_launches()
        t0 = time.perf_counter()
        train_argv = ["--train_dir", train_dir, "--dataset", "cifar", "--train_size",
                      str(TRAIN_ROWS), "--max_bitrate", str(TRAIN_BITRATE), "--saving_dir",
                      saving, "--seed", str(seed), *TRAIN_EM]
        res = train_cli.main(train_argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launched = dict(fused_inr.launches)
        check_train_launches(launched, "cli.train")
        stem = f"train_size_{TRAIN_ROWS}_max_bitrate={TRAIN_BITRATE:.3f}"
        art = load_prior_artifact(os.path.join(saving, f"PRIOR_{stem}.npz"))
        g = art.w.grouping
        gmax = decoder._round_up(g.max_group_size)
        print(f"cli.train CIFAR R={TRAIN_ROWS} ({png_s:.2f} s to write the PNGs): wall "
              f"{train_s:.3f} s; last record {res.elbo_history[-1]}; artifact "
              f"{g.n_groups} groups, largest {g.max_group_size} (Gmax {gmax}), "
              f"{cfg.bitrate_of_groups(g.n_groups):.4f} bpp at target {TRAIN_BITRATE} "
              f"[{card}]")
        codec, _ = init_codec(art, 8)
        rng = np.random.default_rng(seed)
        idx = {"w": rng.integers(0, 2**cfg.bits_per_group, (8, g.n_groups))}
        feats = grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)
        X8 = np.ascontiguousarray(np.broadcast_to(feats, (8, *feats.shape)))
        y = decode(codec, idx, X8, cfg).cpu()
        y_cpu = decode(init_codec(art, 8, device="cpu")[0], idx, X8, cfg)
        derr = (y - y_cpu).abs().max().item()
        print(f"trained prior decode, 8 rows, card vs CPU: max abs diff {derr:.3e} (atol "
              f"{DECODE_TOL['atol']}, rtol {DECODE_TOL['rtol']})")
        torch.testing.assert_close(y, y_cpu, **DECODE_TOL)
        out["cifar_train"] = {"wall_s": train_s, "groups": g.n_groups, "gmax": gmax,
                              "launches": launched, "decode_err": derr, "argv": train_argv,
                              "train_dir": train_dir,
                              "prior": os.path.join(saving, f"PRIOR_{stem}.npz")}
        del codec

    X_np, Y_np = load_training_set(train_dir, cfg, seed, TRAIN_ROWS)
    X, Y = torch.from_numpy(X_np).cuda(), torch.from_numpy(Y_np).cuda()
    state, priors, beta = res.state, res.priors, res.kl_beta
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def sgd(n, st=state, source=gen):
        return trainer.sgd_epochs(st, X, Y, priors, beta, source, cfg=cfg, n_epochs=n,
                                  lr=TRAIN_LR)

    with phase("train timing"):
        sgd(2)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sgd(1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        sgd(10)
        torch.cuda.synchronize()
        epoch_s = (time.perf_counter() - t0) / 10
        busy_us, wall_us, by_kernel = device_time_by_kernel(lambda: sgd(10), 1)
        parts = epoch_parts(by_kernel)
        pieces = epoch_pieces(state, cfg, gen)
        device_ms = busy_us / 1e4
        print(f"train_epoch_s {epoch_s:.6f} (CIFAR R={TRAIN_ROWS}, S=1, mean of 10 warm "
              f"epochs); peak device memory of an epoch {peak / 2**20:.1f} MiB "
              f"({base / 2**20:.1f} MiB allocated before it) [{card}]")
        print(f"10 epochs under the profiler: {device_ms:.3f} ms device time per epoch in "
              f"{wall_us / 1e4:.3f} ms wall, idle share {1 - busy_us / wall_us:.4f}; by "
              "kernel name:")
        for name, us in parts.items():
            print(f"  {us / 1e4:8.4f} ms/epoch {100 * us / busy_us:5.1f}%  {name}")
        print("the pieces on their own by CUDA events, against the epoch's device time:")
        for name, ms_ in pieces.items():
            print(f"  {ms_:8.4f} ms {100 * ms_ / device_ms:5.1f}%  {name}")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
            print(f"  {us / 1e4:8.4f} ms/epoch {100 * us / busy_us:5.1f}%  {name[:100]}")
        # the same under --precision highest (exact f32): what TF32 moved
        with platform.ambient("highest"):
            busy_hi, wall_hi, by_kernel_hi = device_time_by_kernel(lambda: sgd(10), 1)
        parts_hi = epoch_parts(by_kernel_hi)
        print(f"under --precision highest: {busy_hi / 1e4:.3f} ms device time per epoch in "
              f"{wall_hi / 1e4:.3f} ms wall; by kernel name:")
        for name, us in parts_hi.items():
            print(f"  {us / 1e4:8.4f} ms/epoch {100 * us / busy_hi:5.1f}%  {name}")
        epoch_by_mode = by_mode(lambda: wall_s(lambda: sgd(10), 1) / 10)
        print(mode_line(f"train_epoch_s (CIFAR R={TRAIN_ROWS}, S=1, 10 warm epochs)",
                        epoch_by_mode) + f" [{card}]")
        with exact_f32():
            fwd, bwd = kernel_checks(art, TRAIN_ROWS, 1, gen, card, errs, bwd_errs,
                                     "CIFAR train")
        out["timing"] = {"train_epoch_s": epoch_s, "peak_mib": peak / 2**20,
                         "device_ms": busy_us / 1e4, "idle": 1 - busy_us / wall_us,
                         "parts_ms": {k: v / 1e4 for k, v in parts.items()},
                         "pieces_ms": pieces, "siren_fwd": fwd, "siren_bwd": bwd,
                         "train_epoch_s_by_mode": epoch_by_mode,
                         "device_ms_highest": busy_hi / 1e4,
                         "parts_ms_highest": {k: v / 1e4 for k, v in parts_hi.items()}}

    with phase("train determinism"):
        lo, hi = cfg.bits_budget(TRAIN_BITRATE)

        def em(st, pr, b, g, n=2):
            return trainer.em_iters(st, X, Y, pr, b, g, lo, hi, cfg=cfg, n_iters=n,
                                    n_epochs=3, lr=TRAIN_LR)

        g_state = gen.get_state()
        runs = []
        for _ in range(2):
            gen.set_state(g_state)
            runs.append(em(state, priors, beta, gen))
        equal_runs = (same_state(runs[0][0], runs[1][0])
                      and all(torch.equal(a, b) for a, b in zip(runs[0][1].leaves(),
                                                                  runs[1][1].leaves()))
                      and runs[0][2] == runs[1][2])

        def weight_grads():
            leaves = [t.detach().clone().requires_grad_() for t in state.leaves()]
            s = state.with_leaves(leaves)
            g = torch.Generator(device="cuda").manual_seed(seed)
            with precision(), deterministic_convs():
                y_hat = trainer.forward(s, X, cfg, generator=g)[:, 0]
                loss = (torch.mean((y_hat - Y) ** 2) * TRAIN_ROWS
                        + beta * trainer.total_kl(s, priors))
                return torch.autograd.grad(loss, leaves)

        ga, gb = weight_grads(), weight_grads()
        equal_grads = all(torch.equal(a, b) for a, b in zip(ga, gb))
        n_post = 2 * len(state.posteriors())
        del ga, gb
        st1, pr1, beta1, _ = runs[0]
        path = os.path.join(tmp_root, "ts.npz")
        train_state.save_train_state(path, st1, pr1, float(beta1), 2)
        st_l, pr_l, beta_l, done_l, _ = train_state.load_train_state(path, cfg, "cuda")
        gen.set_state(g_state)
        cont_mem = em(st1, pr1, beta1, gen, 1)
        gen.set_state(g_state)
        cont_disk = em(st_l, pr_l, beta_l, gen, 1)
        equal_resume = (same_state(cont_mem[0], cont_disk[0]) and cont_mem[2] == cont_disk[2]
                        and done_l == 2)
        print(f"two 2-iteration em_iters runs (3 epochs each) from one state and generator "
              f"state, R={TRAIN_ROWS}: bitwise equal {equal_runs}; the loss's gradients "
              f"twice, the {len(state.leaves()) - n_post} A and conv weight and bias leaves "
              f"included: bitwise equal {equal_grads}; a train state saved, loaded and "
              f"continued vs continued in memory: bitwise equal {equal_resume} [{card}]")
        if not (equal_runs and equal_grads and equal_resume):
            raise AssertionError("training on the card does not repeat bit for bit")
        del runs, cont_mem, cont_disk, st_l, pr_l
        # one epoch at R = 64 from one state and one noise draw, card vs CPU,
        # under --precision highest (exact f32 on the card, as the CPU computes)
        rows = slice(0, 64)
        small = trainer.PriorState(
            w=trainer.Gaussian(state.w.loc[rows], state.w.log_scale[rows]),
            lpe=trainer.Gaussian(state.lpe.loc[rows], state.lpe.log_scale[rows]),
            h=None, hh=None, A=state.A, up=state.up)
        noise = trainer.draw_noise(small, cfg, 1, torch.Generator(device="cuda")
                                   .manual_seed(seed))
        small_cpu, pr_cpu = small.to("cpu"), priors.to("cpu")
        with platform.ambient("highest"):
            card_out = trainer.sgd_epochs(small, X[rows], Y[rows], priors, beta,
                                          lambda: noise, cfg=cfg, n_epochs=1, lr=TRAIN_LR)
        cpu_out = trainer.sgd_epochs(small_cpu, torch.from_numpy(X_np[rows]),
                                     torch.from_numpy(Y_np[rows]), pr_cpu, beta,
                                     lambda: [n.cpu() for n in noise], cfg=cfg,
                                     n_epochs=1, lr=TRAIN_LR)
        worst = states_close(card_out[0], cpu_out[0], small_cpu, 1)
        m_err = abs(card_out[1].mse.item() / cpu_out[1].mse.item() - 1)
        k_err = abs(card_out[1].kl.item() / cpu_out[1].kl.item() - 1)
        print(f"one epoch at R=64 from one state and one noise draw, card (--precision "
              f"highest) vs CPU: mse "
              f"relative diff {m_err:.3e}, KL {k_err:.3e} (rtol 1e-4); every leaf within "
              f"{worst:.3f} of its bound (1e-6 of its norm + 1e-2 of the change's, every "
              f"element within 2 lr) [{card}]")
        if m_err > 1e-4 or k_err > 1e-4:
            raise AssertionError("one epoch on the card differs from the CPU's")
        out["determinism"] = {"runs": equal_runs, "grads": equal_grads,
                              "resume": equal_resume, "card_vs_cpu_of_bound": worst,
                              "mse_rel": m_err, "kl_rel": k_err}

    with phase("rd_sweep"):
        got = {}

        def capture_codec(f):
            def wrapped(art_, *a, **kw):
                got["art"] = art_
                return f(art_, *a, **kw)
            return wrapped

        def capture_compress(f):
            def wrapped(codec_, state_, Xte, Yte, cfg_, *a, **kw):
                got.update(codec=codec_, X=Xte, res=f(codec_, state_, Xte, Yte, cfg_, *a, **kw))
                return got["res"]
            return wrapped

        sweep = ["--dataset", "cifar", "--synthetic", str(TRAIN_ROWS), "--n_test",
                 str(N_ROWS), "--bitrates", str(TRAIN_BITRATE), *TRAIN_EM,
                 "--n_encode_epochs", "10", "--finetune_epochs", "1", "--seed", str(seed),
                 "--out", os.path.join(tmp_root, "rd.json")]
        zero_launches()
        t0 = time.perf_counter()
        quiet = ProgressFiltered(sys.stdout)
        with replaced(rd_sweep, "init_codec", capture_codec), \
                replaced(rd_sweep, "compress", capture_compress), \
                contextlib.redirect_stdout(quiet):
            (point,) = rd_sweep.main(sweep + [
                "--train_state_dir", os.path.join(tmp_root, "ts_sweep"),
                "--state_dir", os.path.join(tmp_root, "enc")])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        res_e = got["res"]
        launched_sweep = dict(fused_inr.launches)
        t = res_e.timings
        n_ep = TRAIN_EPOCHS + t["phase1_epochs"] + t["finetune_epochs"]
        print(f"({quiet.dropped} per-group progress lines of the encode left out)")
        print(f"kernel launches in rd_sweep: {launched_sweep}; epochs {n_ep} (training "
              f"{TRAIN_EPOCHS}, encode {t['phase1_epochs']} + {t['finetune_epochs']})")
        if launched_sweep["siren_bwd"] != n_ep:
            raise AssertionError("rd_sweep did not launch siren_bwd once per epoch")
        if not res_e.state.w.compressed.all():
            raise AssertionError("rd_sweep's encode left groups uncoded")
        print(f"rd_sweep CIFAR: trained on {TRAIN_ROWS}, encoded {point['n_rows']} rows, "
              f"{point['n_groups']['w']} groups, all coded; wall {sweep_s:.3f} s (encode "
              f"optimize {t['optimize_s']:.3f} s, code {t['code_s']:.3f} s); PSNR "
              f"{point['distortion_mean']:.4f} dB @ {point['actual_bitrate']:.4f} bpp "
              f"[{card}]")
        check_bitstream(got["codec"], res_e, torch.as_tensor(got["X"]).cuda(), cfg,
                        got["art"], "rd_sweep encode")
        # a crash after the first train-state snapshot, relaunched twice
        crash = sweep + ["--skip_encode", "--train_state_dir",
                         os.path.join(tmp_root, "ts_crash")]
        saved = {}

        def crashing(f):
            def wrapped(path_, *a, **kw):
                f(path_, *a, **kw)
                saved["controller"] = dict(kw["controller"])
                raise Crash("train state")
            return wrapped

        with replaced(train_state, "save_train_state", crashing):
            try:
                rd_sweep.main(crash)
                raise AssertionError("rd_sweep took no train-state snapshot")
            except Crash:
                pass
        snap = os.path.join(tmp_root, "ts_crash", f"train_state_cifar_{TRAIN_BITRATE:g}.npz")
        passed, finals = [], []

        def watching(f):
            def wrapped(*a, **kw):
                passed.append((kw["controller"], kw["em_iter_offset"]))
                return f(*a, **kw)
            return wrapped

        with replaced(trainer, "em_train", watching):
            for k in (1, 2):
                ts = os.path.join(tmp_root, f"ts_re{k}")
                os.makedirs(ts)
                shutil.copy(snap, ts)
                rd_sweep.main(sweep + ["--skip_encode", "--train_state_dir", ts,
                                       "--save_prior_dir", os.path.join(tmp_root, f"p{k}")])
                finals.append(train_state.load_train_state(
                    os.path.join(ts, os.path.basename(snap)), cfg, "cuda"))
        prior_name = f"PRIOR_rd_cifar_bitrate={TRAIN_BITRATE:g}.npz"
        arts = [np.load(os.path.join(tmp_root, f"p{k}", prior_name)) for k in (1, 2)]
        equal_art = all(np.array_equal(arts[0][f], arts[1][f]) for f in arts[0].files)
        equal_state = (same_state(finals[0][0], finals[1][0])
                       and finals[0][2:] == finals[1][2:])
        restored = passed == [(saved["controller"], 1)] * 2
        print(f"rd_sweep crashed after its first train-state snapshot (controller "
              f"{saved['controller']}), relaunched twice from it: controller restored "
              f"{restored}; final train states (EM {finals[0][3]}) bitwise equal "
              f"{equal_state}; saved priors bitwise equal {equal_art} [{card}]")
        if not (restored and equal_state and equal_art):
            raise AssertionError("the relaunched rd_sweeps differ, or the controller was not "
                                 "restored")
        out["rd_sweep"] = {"wall_s": sweep_s, "point": point, "launches": launched_sweep}
        del got, finals, arts

    with phase("Kodak train"):
        kcfg = KODAK_TRAIN
        hw = tuple(n * p for n, p in zip(kcfg.patch_nums, kcfg.pixel_sizes))
        Xk, Yk = points_from_data(list(smooth_images(KODAK_TRAIN_IMAGES, seed + 9, hw)),
                                  kcfg)
        Xk, Yk = torch.from_numpy(Xk).cuda(), torch.from_numpy(Yk).cuda()
        per_image = kcfg.patches_per_datapoint
        zero_launches()
        t0 = time.perf_counter()
        res_k = trainer.em_train(torch.Generator(device="cuda").manual_seed(seed), kcfg, Xk,
                                 Yk, 0.5, n_em_iters=2, first_epochs=3, later_epochs=3)
        torch.cuda.synchronize()
        kodak_s = time.perf_counter() - t0
        launched_k = dict(fused_inr.launches)
        rows = {n: getattr(res_k.state, n).loc.shape[0] for n in ("w", "h", "hh")}
        R = KODAK_TRAIN_IMAGES * per_image
        if launched_k["siren_bwd"] != 6 or rows != {"w": R, "h": kcfg.rows_level2(R),
                                                    "hh": kcfg.rows_level3(R)}:
            raise AssertionError(f"Kodak training: rows {rows}, launches {launched_k}")
        art_k = build_prior_artifact(res_k.state, res_k.priors, res_k.kl_beta, kcfg,
                                     codebook_seed=seed)
        codec_k, state_k = init_codec(art_k, per_image)
        groups = {n: codec_k.meta(n).n_groups for n in codec_k.level_names}
        idx = {n: np.random.default_rng(seed).integers(
            0, 2**kcfg.bits_per_group, (state_k.level(n).q.loc.shape[0], groups[n]))
            for n in codec_k.level_names}
        y_k = decode(codec_k, idx, Xk[:per_image], kcfg)
        if not torch.isfinite(y_k).all() or any(p is None for p in res_k.priors.leaves()):
            raise AssertionError("the Kodak prior does not decode")
        print(f"Kodak em_train: {KODAK_TRAIN_IMAGES} images, rows {rows}, 2 EM iterations x 3 "
              f"epochs in {kodak_s:.3f} s (launches {launched_k}); three-level M-step and "
              f"artifact, groups {groups}; init_codec and a decode of one image on the card "
              f"[{card}]")
        with exact_f32():
            fwd_k, bwd_k = kernel_checks(art_k, R, 1, gen, card, errs, bwd_errs,
                                         "Kodak train")
        out["kodak_train"] = {"wall_s": kodak_s, "groups": groups, "launches": launched_k,
                              "siren_fwd": fwd_k, "siren_bwd": bwd_k}
    return out


# ----------------------------------------------------------------- scale-out

# the world-2 training cut: 2 EM iterations of 3 epochs at R = 2,000 (1,000
# rows a rank)
SCALE_EM = dict(n_em_iters=2, first_epochs=3, later_epochs=3)
SCALE_EPOCHS = 6
SCALE_RANKS = 2
SCALE_TIMEOUT_S = 600
SCALE_TIMED = 10  # warm epochs timed for a rank's train_epoch_s and epoch_s
# the precision modes of a data-parallel rank: the ambient (TF32, what
# --n_devices gives a user) and --precision highest (exact)
SCALE_MODES = {"highest": "highest", "ambient": None}
# a world-1 run under the launcher: starts the group (NCCL), checks it with
# one all_reduce, times both, then runs the CLI module given with its argv
# with the launch counts zeroed just before, and prints them (and the
# encode's epochs) as a JSON line after
LAUNCHED = (
    "import importlib, json, sys, time, torch, torch.distributed as dist\n"
    "t0 = time.perf_counter()\n"
    "from recombiner_tpu_torch.ops import fused_inr\n"
    "from recombiner_tpu_torch.parallel import launch\n"
    "assert launch.maybe_initialize_distributed('cuda')\n"
    "t1 = time.perf_counter()\n"
    "x = torch.ones(1, device='cuda')\n"
    "dist.all_reduce(x)\n"
    "torch.cuda.synchronize()\n"
    "print(f'process group: backend {dist.get_backend()}, world {dist.get_world_size()}, '\n"
    "      f'init_process_group {t1 - t0:.3f} s, first collective {time.perf_counter() - t1:.3f} "
    "s', flush=True)\n"
    "assert dist.get_backend() == 'nccl' and dist.get_world_size() == 1 and x.item() == 1\n"
    "fused_inr.launches.update(dict.fromkeys(fused_inr.launches, 0))\n"
    "res = importlib.import_module(sys.argv[1]).main(sys.argv[2:])\n"
    "torch.cuda.synchronize()\n"
    "t = getattr(res, 'timings', None)\n"
    "print(json.dumps({'launches': dict(fused_inr.launches), 'epochs': None if t is None else "
    "t['phase1_epochs'] + t['finetune_epochs']}), flush=True)\n")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_launched(module: str, argv: list, what: str) -> dict:
    """``module``'s main(argv) in a subprocess under torchrun's environment at
    world size 1 (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    returns that process's launch counts of the run (``launches``) and, for
    an encode, its epochs (``epochs``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()),
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", LAUNCHED, module, *argv], env=env, cwd=root,
                         capture_output=True, text=True, timeout=SCALE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-3000:])
        raise AssertionError(f"{what} under the launcher exited with {res.returncode}")
    lines = res.stdout.splitlines()
    group = next(line for line in lines if line.startswith("process group"))
    counts = json.loads(next(line for line in reversed(lines) if line.startswith('{"launches"')))
    print(f"{what} under the launcher (subprocess, {wall:.3f} s): {group}; kernel launches in "
          f"its run {counts['launches']}")
    return counts


def check_train_launches(launched: dict, what: str) -> None:
    """cli.train at TRAIN_EM: siren_bwd once per epoch, siren_fwd once per
    epoch and once per log forward."""
    print(f"kernel launches in {what}: {launched}; epochs run {TRAIN_EPOCHS}, log forwards "
          f"{len(TRAIN_CHUNKS)} (chunks {TRAIN_CHUNKS})")
    if (launched["siren_bwd"] != TRAIN_EPOCHS
            or launched["siren_fwd"] != TRAIN_EPOCHS + len(TRAIN_CHUNKS)):
        raise AssertionError(f"{what} did not launch siren_bwd once per epoch and siren_fwd "
                             "once per epoch and once per log forward")


def npz_equal(a: str, b: str) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[f], y[f]) for f in x.files)


def scaleout_world1(seed: int, card: str, tmp_root: str, train_argv: list,
                    train_prior: str) -> dict:
    """cli.train and cli.compress at world size 1 on NCCL under the
    launcher's environment, each bitwise against the same CLI run with no
    process group; each launched run's own launch counts."""
    cfg = CIFAR
    out = {}
    saving = os.path.join(tmp_root, "prior_launched")
    argv = [saving if a == os.path.dirname(train_prior) else a for a in train_argv]
    got = run_launched("recombiner_tpu_torch.cli.train", argv + ["--n_devices", "1"], "cli.train")
    check_train_launches(got["launches"], "cli.train at world size 1 on NCCL")
    out["train_launches"] = got["launches"]
    launched_prior = os.path.join(saving, os.path.basename(train_prior))
    out["train_equal"] = npz_equal(launched_prior, train_prior)
    print(f"cli.train CIFAR R={TRAIN_ROWS} at world size 1 on NCCL vs no group: artifact "
          f"bitwise equal {out['train_equal']} [{card}]")

    test_dir = os.path.join(tmp_root, "test")
    os.makedirs(test_dir)
    for i, img in enumerate(smooth_images(N_ROWS, seed + 11)):
        export.write_png(os.path.join(test_dir, f"{i:04d}.png"), img)
    art = make_cifar_artifact(seed)
    prior = os.path.join(tmp_root, "cifar_prior.npz")
    save_prior_artifact(prior, art)

    def argv_c(save_dir):
        return ["--test_dir", test_dir, "--test_idx", "0", "--prior_path", prior, "--save_dir",
                save_dir, "--n_epochs", str(ENCODE_PHASE1_EPOCHS), "--finetune_epochs",
                str(ENCODE_FINETUNE_EPOCHS), "--sample_size", str(SAMPLE_SIZE), "--seed",
                str(seed)]

    plain_dir, launched_dir = (os.path.join(tmp_root, d) for d in ("enc_plain", "enc_nccl"))
    zero_launches()
    with contextlib.redirect_stdout(ProgressFiltered(sys.stdout)):
        res = compress_cli.main(argv_c(plain_dir))
    out["no_group_launches"] = read_launches(
        res.timings["phase1_epochs"] + res.timings["finetune_epochs"],
        "cli.compress with no process group")
    got = run_launched("recombiner_tpu_torch.cli.compress",
                       argv_c(launched_dir) + ["--n_devices", "1"], "cli.compress")
    out["compress_launches"] = got["launches"]
    if (got["launches"]["siren_bwd"] != got["epochs"]
            or got["launches"]["siren_fwd"] < got["epochs"] + 1):
        raise AssertionError("cli.compress at world size 1 on NCCL did not launch siren_bwd "
                             "once per epoch and siren_fwd once per epoch plus the decode")
    files = sorted(os.listdir(plain_dir))
    same_files = files == sorted(os.listdir(launched_dir)) and all(
        open(os.path.join(plain_dir, f), "rb").read()
        == open(os.path.join(launched_dir, f), "rb").read() for f in files)
    _, idx = read_bitstream(os.path.join(launched_dir, "bitstream_test_id_0.rctb"))
    feats = grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)
    X = np.ascontiguousarray(np.broadcast_to(feats, (N_ROWS, *feats.shape)))
    y = decode(init_codec(art, N_ROWS)[0], idx, X, cfg).cpu().numpy()
    out["compress_equal"] = (same_files and np.array_equal(y, res.reconstruction)
                             and got["launches"] == out["no_group_launches"])
    print(f"cli.compress CIFAR R={N_ROWS} S={SAMPLE_SIZE} at world size 1 on NCCL vs no group: "
          f"{files} bytewise equal {same_files}; the launched bitstream decoded equal to the "
          f"reconstruction {np.array_equal(y, res.reconstruction)}; launches {got['launches']} "
          f"against {out['no_group_launches']} with no group, {got['epochs']} epochs [{card}]")
    if not (out["train_equal"] and out["compress_equal"]):
        raise AssertionError("the CLIs at world size 1 on NCCL differ from the runs with no "
                             "process group")
    return out


def scaleout_rank(rank: int, inp: str, out_dir: str, modes: dict, repeats: int) -> None:
    """One rank of a data-parallel run (``launch.spawn``), on its own card or
    a share of one. For each precision mode of ``modes`` (name: the
    ``platform.ambient`` argument), em_train at CIFAR R = 2,000 (SCALE_EM)
    and progressive.compress at R = 500, S = 5 (the encode slice's cut),
    each ``repeats`` times from one seed, with the launches and the time in
    collectives of every run (timed between synchronisations around each
    ``mesh.all_gather``); then SCALE_TIMED warm epochs of each
    (``train_epoch_s``, ``epoch_s``) and an epoch's noise drawn for every
    rank's rows against this rank's alone. Keeps the first run's gathered
    state, shared leaves, indices, reconstruction and PSNR, and whether
    every repeat was bitwise equal to it; rank 0 writes each mode's
    bitstream. The inputs come from ``inp`` (seed, Y_train, Y_encode); the
    results go to ``out_dir/rank_{rank}.pt``."""
    from recombiner_tpu_torch.parallel import mesh as mesh_mod

    c = torch.load(inp, weights_only=False)
    seed, cfg = c["seed"], CIFAR
    mesh = mesh_mod.make_mesh()
    coll = {"s": 0.0, "n": 0}
    real = mesh_mod.all_gather

    def timed(t, m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = real(t, m)
        torch.cuda.synchronize()
        coll["s"] += time.perf_counter() - t0
        coll["n"] += 1
        return got

    def run(fn):
        zero_launches()
        coll.update(s=0.0, n=0)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, {"wall_s": time.perf_counter() - t0, "launches": dict(fused_inr.launches),
                     "collective_s": coll["s"], "collectives": coll["n"]}

    def timed_epochs(fn):
        fn(2)
        torch.cuda.synchronize()
        coll.update(s=0.0, n=0)
        t0 = time.perf_counter()
        fn(SCALE_TIMED)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SCALE_TIMED, coll["s"] / SCALE_TIMED

    mesh_mod.all_gather = timed
    feats = torch.from_numpy(grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)).cuda()
    art = make_cifar_artifact(seed)
    out = {"rank": rank, "device": torch.cuda.current_device(), "card": card_line()}
    torch.cuda.reset_peak_memory_stats()
    for mode, prec in modes.items():
        m = out[mode] = {"train": [], "encode": []}
        with platform.ambient(prec):
            part = mesh_mod.partition(mesh, TRAIN_ROWS)
            X = mesh_mod.shard_rows(feats.expand(TRAIN_ROWS, *feats.shape), part)
            Y = mesh_mod.shard_rows(torch.from_numpy(c["Y_train"]), part).cuda()
            for k in range(repeats):
                res, stats = run(lambda: trainer.em_train(
                    torch.Generator(device="cuda").manual_seed(seed), cfg, X, Y, TRAIN_BITRATE,
                    lr=TRAIN_LR, part=part, **SCALE_EM))
                state = [t.cpu() for t in res.state.gathered().leaves()]
                if k == 0:
                    first = state
                    m["state"] = state
                    m["shared"] = [t.cpu() for t in
                                   res.state.leaves()[2 * len(res.state.posteriors()):]]
                stats["equal_to_first"] = all(torch.equal(a, b) for a, b in zip(state, first))
                m["train"].append(stats)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            m["train_epoch_s"], m["train_collective_s"] = timed_epochs(
                lambda n: trainer.sgd_epochs(res.state, X, Y, res.priors, res.kl_beta, gen,
                                             cfg=cfg, n_epochs=n, lr=TRAIN_LR))
            # an epoch's noise: every rank's rows drawn and this rank's kept, against
            # drawing this rank's rows alone (what the global draw costs)
            local = [t.shape for t in trainer.draw_noise(res.state, cfg, 1)]
            m["noise_ms"] = cuda_ms(lambda: trainer.draw_noise(res.state, cfg, 1, gen), 20)
            m["noise_local_ms"] = cuda_ms(
                lambda: [torch.randn(s, generator=gen, device="cuda") for s in local], 20)
            del X, Y, res, state, first

            codec, state0 = init_codec(art, N_ROWS)
            part = mesh_mod.partition(mesh, N_ROWS)
            Xe = mesh_mod.shard_rows(feats.expand(N_ROWS, *feats.shape), part)
            Ye = mesh_mod.shard_rows(torch.from_numpy(c["Y_encode"]), part).cuda()
            st = mesh_mod.shard_rows(state0, part)
            for k in range(repeats):
                r, stats = run(lambda: progressive.compress(
                    codec, st, Xe, Ye, cfg, torch.Generator(device="cuda").manual_seed(seed),
                    n_optimize_epochs=ENCODE_PHASE1_EPOCHS, sample_size=SAMPLE_SIZE,
                    finetune_overrides={"w": ENCODE_FINETUNE_EPOCHS}))
                stats["epochs"] = r.timings["phase1_epochs"] + r.timings["finetune_epochs"]
                if k == 0:
                    m.update(indices=r.indices["w"], reconstruction=r.reconstruction,
                             psnr=float(np.mean(r.distortion)))
                stats["equal_to_first"] = bool(
                    np.array_equal(r.indices["w"], m["indices"])
                    and np.array_equal(r.reconstruction, m["reconstruction"]))
                m["encode"].append(stats)
            if rank == 0:
                write_bitstream(os.path.join(out_dir, f"bitstream_{mode}.rctb"), r.indices,
                                config_name=cfg.name, codebook_seed=art.codebook_seed,
                                codebook_kind=art.codebook_kind,
                                bits_per_group=cfg.bits_per_group)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            m["epoch_s"], _ = timed_epochs(
                lambda n: encoder.optimize(codec, st, Xe, Ye, cfg, gen, n_epochs=n,
                                           sample_size=SAMPLE_SIZE))
            del codec, state0, st, Xe, Ye, r
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    torch.save(out, os.path.join(out_dir, f"rank_{rank}.pt"))


def row_count_invariance(codec, cfg, seed: int) -> dict:
    """Whether the first 1/k of B = R * S rows of each per-row product come
    out bitwise as they do alone (k = 2, 4, 8), exact and at TF32: the
    A-transforms (``ATransform``: forward and the row-major latent gradient)
    and the conv stack (forward and data gradient). A data-parallel rank
    holding 1/k of the rows repeats world size 1 bit for bit only where
    every product does."""
    B = N_ROWS * SAMPLE_SIZE
    g = torch.Generator(device="cuda").manual_seed(seed)
    args = (cfg.data_dim, cfg.layerwise_scale_factors, cfg.paddings)
    out = {}
    for mode in MODES:
        with platform.ambient(None if mode == "ambient" else mode), precision(), \
                deterministic_convs():
            res = {}
            for i, A in enumerate(codec.A):
                At = A.t().contiguous()
                h = torch.randn(B, A.shape[0], generator=g, device="cuda")
                up = torch.randn(B, A.shape[0], generator=g, device="cuda")
                res[f"A{i} forward"] = [torch.equal((h @ A)[:B // k], h[:B // k] @ A)
                                        for k in (2, 4, 8)]
                res[f"A{i} latent gradient"] = [torch.equal((up @ At)[:B // k], up[:B // k] @ At)
                                                for k in (2, 4, 8)]
                if i == 0:  # what ATransform avoids: cuBLAS's transposed operand
                    res["A0 latent gradient as grad @ A.t()"] = [
                        torch.equal((up @ A.t())[:B // k], up[:B // k] @ A.t()) for k in (2, 4, 8)]
            lpe = torch.randn(B, *cfg.lpe_spatial, cfg.latent_dim, generator=g, device="cuda",
                              requires_grad=True)
            pe = apply_upsample_phased(codec.up, lpe, *args)
            up = torch.randn(pe.shape, generator=g, device="cuda")
            (grad,) = torch.autograd.grad((pe * up).sum(), lpe)
            fwd, dgrad = [], []
            for k in (2, 4, 8):
                part = lpe[:B // k].detach().clone().requires_grad_(True)
                pe_k = apply_upsample_phased(codec.up, part, *args)
                (grad_k,) = torch.autograd.grad((pe_k * up[:B // k]).sum(), part)
                fwd.append(torch.equal(pe[:B // k], pe_k))
                dgrad.append(torch.equal(grad[:B // k], grad_k))
            res["conv stack forward"], res["conv stack data gradient"] = fwd, dgrad
        out[mode] = res
        print(f"row-count invariance, {mode} ({B} rows against their first 1/2, 1/4, 1/8 "
              "alone, bitwise):")
        for what, eq in res.items():
            print(f"  {what}: {eq}")
    return out


def scaleout_world2(seed: int, card: str, tmp_root: str, train_dir: str) -> dict:
    """SCALE_RANKS ranks on the one card over gloo (NCCL refuses two ranks
    on one device), under --precision highest and at the ambient (TF32),
    against the same runs at world size 1 in this process."""
    cfg = CIFAR
    out_dir = os.path.join(tmp_root, "world2")
    os.makedirs(out_dir)
    _, Y_train = load_training_set(train_dir, cfg, seed, TRAIN_ROWS)
    Y_encode = smooth_images(N_ROWS, seed).reshape(N_ROWS, cfg.n_pixels, cfg.output_dim)
    inp = os.path.join(out_dir, "in.pt")
    torch.save({"seed": seed, "Y_train": Y_train, "Y_encode": Y_encode}, inp)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(ProgressFiltered(sys.stdout)):
        launch.spawn(scaleout_rank, SCALE_RANKS, (inp, out_dir, SCALE_MODES, 2),
                     backend="gloo", cuda="shared", timeout_s=SCALE_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank_{r}.pt"), weights_only=False)
             for r in range(SCALE_RANKS)]

    # world size 1 in this process: the exact training, and in each mode the
    # encode and, to show how far rounding alone moves it, the encode with its
    # initial posteriors nudged by 1e-7 relative
    feats = torch.from_numpy(grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)).cuda()
    X = feats.expand(TRAIN_ROWS, *feats.shape)
    with platform.ambient("highest"):
        start = trainer.init_prior_state(cfg, TRAIN_ROWS,
                                         torch.Generator(device="cuda").manual_seed(seed))
        one = trainer.em_train(torch.Generator(device="cuda").manual_seed(seed), cfg, X,
                               torch.from_numpy(Y_train).cuda(), TRAIN_BITRATE, lr=TRAIN_LR,
                               **SCALE_EM)
    art = make_cifar_artifact(seed)
    codec, state0 = init_codec(art, N_ROWS)
    Xe = feats.expand(N_ROWS, *feats.shape)
    nudged = dataclasses.replace(state0, w=dataclasses.replace(state0.w, q=Gaussian(
        state0.w.q.loc * (1 + 1e-7), state0.w.q.log_scale)))
    one_enc, nudge_frac = {}, {}
    for mode, prec in SCALE_MODES.items():
        with platform.ambient(prec), contextlib.redirect_stdout(ProgressFiltered(sys.stdout)):
            one_enc[mode], nudge_enc = (
                progressive.compress(codec, s, Xe, torch.from_numpy(Y_encode).cuda(), cfg,
                                     torch.Generator(device="cuda").manual_seed(seed),
                                     n_optimize_epochs=ENCODE_PHASE1_EPOCHS,
                                     sample_size=SAMPLE_SIZE,
                                     finetune_overrides={"w": ENCODE_FINETUNE_EPOCHS})
                for s in (state0, nudged))
        nudge_frac[mode] = float(np.mean(nudge_enc.indices["w"] == one_enc[mode].indices["w"]))
    invariance = row_count_invariance(codec, cfg, seed)
    print("world size 1's encode with its initial posteriors nudged by 1e-7 relative: indices "
          + ", ".join(f"{mode} {f:.5f}" for mode, f in nudge_frac.items()) + f" equal [{card}]")
    got = one.state.with_leaves([t.cuda() for t in ranks[0]["highest"]["state"]])
    worst = states_close(got, one.state, start, SCALE_EPOCHS)

    checks, enc = {}, {}
    for mode in SCALE_MODES:
        ms_ = [r[mode] for r in ranks]
        checks[f"{mode}: train launches = epochs on every rank"] = all(
            t["launches"] == {"siren_fwd": SCALE_EPOCHS, "siren_bwd": SCALE_EPOCHS}
            for m in ms_ for t in m["train"])
        checks[f"{mode}: encode launches: siren_bwd = epochs, siren_fwd >= epochs + 1 on every "
               "rank"] = all(e["launches"]["siren_bwd"] == e["epochs"]
                             and e["launches"]["siren_fwd"] >= e["epochs"] + 1
                             for m in ms_ for e in m["encode"])
        checks[f"{mode}: A and conv weights bitwise equal on both ranks"] = all(
            torch.equal(a, b) for a, b in zip(ms_[0]["shared"], ms_[1]["shared"]))
        checks[f"{mode}: two world-2 trainings bitwise equal"] = all(
            t["equal_to_first"] for m in ms_ for t in m["train"])
        checks[f"{mode}: two world-2 encodes bitwise equal"] = all(
            e["equal_to_first"] for m in ms_ for e in m["encode"])
        checks[f"{mode}: both ranks return the same encode"] = np.array_equal(
            ms_[0]["indices"], ms_[1]["indices"])
        ref = one_enc[mode]
        frac = float(np.mean(ms_[0]["indices"] == ref.indices["w"]))
        psnr_gap = ms_[0]["psnr"] - float(np.mean(ref.distortion))
        bitwise = bool(np.array_equal(ms_[0]["indices"], ref.indices["w"])
                       and np.array_equal(ms_[0]["reconstruction"], ref.reconstruction))
        if mode == "highest":  # the JAX package's bar (tests/test_parallel.py)
            floor = 0.98
        else:  # at most twice the cells that a 1e-7 nudge moves at world size 1
            floor = 1 - 2 * (1 - nudge_frac[mode])
        checks[f"{mode}: encode indices >= {floor:.5f} equal to world size 1"] = frac >= floor
        checks[f"{mode}: encode PSNR within 0.3 dB of world size 1"] = abs(psnr_gap) < 0.3
        _, idx = read_bitstream(os.path.join(out_dir, f"bitstream_{mode}.rctb"))
        y = decode(codec, idx, Xe, cfg).cpu()
        derr = (y - torch.from_numpy(ms_[0]["reconstruction"])).abs().max().item()
        torch.testing.assert_close(y, torch.from_numpy(ms_[0]["reconstruction"]), **DECODE_TOL)
        checks[f"{mode}: rank 0's bitstream decodes in one process within DECODE_TOL"] = True
        enc[mode] = {"index_agreement": frac, "floor": floor, "psnr_gap_db": psnr_gap,
                     "bitwise_world1": bitwise, "nudge_index_agreement": nudge_frac[mode],
                     "decode_err": derr}
        print(f"world size {SCALE_RANKS} on one card (gloo), {mode}: encode R={N_ROWS} "
              f"({N_ROWS // 2} rows a rank) against world size 1: indices equal {frac:.5f} "
              f"(floor {floor:.5f}), PSNR {ms_[0]['psnr']:.4f} against "
              f"{np.mean(ref.distortion):.4f} dB ({psnr_gap:+.5f}), indices and reconstruction "
              f"bitwise equal {bitwise}; rank 0's bitstream decoded in one process: max abs "
              f"diff {derr:.3e} [{card}]")
    print(f"world size {SCALE_RANKS} on one card (gloo; spawn and both ranks {spawn_s:.3f} s): "
          f"training (2 EM iterations x 3 epochs, R={TRAIN_ROWS}, {TRAIN_ROWS // 2} rows a rank, "
          f"--precision highest) against world size 1: every leaf within {worst:.3f} of the "
          f"trained-state bound [{card}]")
    for what, ok in checks.items():
        print(f"  {what}: {ok}")
    print(f"per rank (correctness plumbing on one shared card, not a scale-out speed) [{card}]:")
    for r in ranks:
        for mode in SCALE_MODES:
            m = r[mode]
            t, e = m["train"][0], m["encode"][0]
            print(f"  rank {r['rank']} (cuda:{r['device']}), {mode}: train_epoch_s "
                  f"{m['train_epoch_s']:.6f} (collectives {1e3 * m['train_collective_s']:.3f} ms "
                  f"an epoch), epoch_s {m['epoch_s']:.6f} (S={SAMPLE_SIZE}, no collective); "
                  f"em_train {t['wall_s']:.3f} s with {t['collectives']} collectives in "
                  f"{t['collective_s']:.3f} s, launches {t['launches']}; compress "
                  f"{e['wall_s']:.3f} s with {e['collectives']} collectives in "
                  f"{e['collective_s']:.3f} s, launches {e['launches']}; an epoch's noise drawn "
                  f"for every rank's rows {m['noise_ms']:.4f} ms against this rank's alone "
                  f"{m['noise_local_ms']:.4f} ms")
        print(f"  rank {r['rank']}: peak memory {r['peak_mib']:.1f} MiB")
    if not all(checks.values()):
        raise AssertionError("world size 2: " + ", ".join(k for k, v in checks.items() if not v))
    return {"ranks": [{"rank": r["rank"], "peak_mib": r["peak_mib"]}
                      | {mode: {k: r[mode][k] for k in ("train_epoch_s", "train_collective_s",
                                                         "epoch_s", "noise_ms",
                                                         "noise_local_ms")}
                         | {"train_launches": r[mode]["train"][0]["launches"],
                            "encode_launches": r[mode]["encode"][0]["launches"],
                            "em_train_collective_s": r[mode]["train"][0]["collective_s"],
                            "compress_collective_s": r[mode]["encode"][0]["collective_s"]}
                         for mode in SCALE_MODES}
                      for r in ranks],
            "train_of_bound": worst, "encode": enc, "row_count_invariance": invariance,
            "spawn_s": spawn_s}


# ------------------------------------------------- Kodak's patch rows over ranks

# the kinds of collective a rank's epoch makes on a split Kodak image: the
# conv canvas's halo (forward and backward), the rank-ordered sums (the
# gradient of a level every rank holds whole), the gathers (posteriors for
# the annealing and the coding steps, indices, scalars)
COLLECTIVE_KINDS = ("halo", "sums", "gathers")
# the halo-split lpe_to_pe check on the card: within this share of the
# largest entry of the whole canvas's PEs and LPE gradient (exact f32), the
# CPU tests' tolerance (tests/test_torch_patch_parallel.py)
HALO_OF_MAX = 1e-5


def _collective_kind(frame) -> str:
    if frame.f_globals.get("__name__", "").endswith("parallel.halo"):
        return "halo"
    return "sums" if frame.f_code.co_name.startswith("sum") else "gathers"


def halo_inputs(cfg, R: int, seed: int):
    """An LPE (R, 1, *lpe_spatial, latent) and a cotangent of its PEs on the
    card, from a generator seeded ``seed`` (the same on every rank)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lpe = torch.randn(R, 1, *cfg.lpe_spatial, cfg.latent_dim, generator=g, device="cuda")
    dy = torch.randn(R, 1, cfg.n_pixels, cfg.upsample_out, generator=g, device="cuda")
    return lpe, dy


def halo_lpe_to_pe(up, cfg, R: int, seed: int, part):
    """``lpe_to_pe`` and its LPE gradient at exact f32 on deterministic cuDNN:
    on this rank's slab of ``halo_inputs`` (``part``), gathered, or with
    ``part`` None on the whole canvas."""
    from recombiner_tpu_torch.parallel import mesh as mesh_mod

    lpe, dy = halo_inputs(cfg, R, seed)
    with exact_f32(), deterministic_convs():
        lpe = mesh_mod.shard_rows(lpe, part).requires_grad_()
        pe = mappings.lpe_to_pe(up, lpe, cfg, part)
        (g,) = torch.autograd.grad(pe, lpe, mesh_mod.shard_rows(dy, part))
    return (mesh_mod.gather_rows(pe.detach(), part).cpu(), mesh_mod.gather_rows(g, part).cpu())


def patch_rank(rank: int, inp: str, out_dir: str, modes: dict) -> None:
    """One rank of a Kodak encode whose one image's patch rows are split over
    the ranks (``partition(mesh, 1, KODAK)``: at 2 ranks 48 rows a rank,
    h split, hh whole; at 4, 24 rows a rank, h and hh whole), on its own
    card or a share of one. First the halo-split ``lpe_to_pe`` and its
    gradient (``halo_lpe_to_pe``); then for each precision mode of
    ``modes`` (name: the ``platform.ambient`` argument)
    ``progressive.compress`` at the Kodak encode's cut (CUT_PHASE1_EPOCHS,
    1-epoch finetunes) with its launches and the time in each kind of
    collective (``COLLECTIVE_KINDS``, timed between synchronisations around
    each ``mesh.all_gather``), and SCALE_TIMED warm epochs twice: as a user
    runs them (``epoch_s``), then with each collective so timed
    (``epoch_s_timed`` and each kind's time an epoch: the synchronisations
    stall the host, and a rank's wait for the slowest one counts in the
    collective); and, on a card of its own, 5 epochs under the profiler
    (device time an epoch, of it NCCL's kernels, and the idle share). Rank 0
    writes each mode's bitstream. The seed comes from ``inp``; the results
    go to ``out_dir/patch_{rank}.pt``."""
    from recombiner_tpu_torch.parallel import mesh as mesh_mod

    seed = torch.load(inp, weights_only=False)["seed"]
    cfg, S = KODAK, SAMPLE_SIZE
    mesh = mesh_mod.make_mesh()
    coll = {k: [0.0, 0] for k in COLLECTIVE_KINDS}
    real = mesh_mod.all_gather

    def timed(t, m):
        kind = _collective_kind(sys._getframe(1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = real(t, m)
        torch.cuda.synchronize()
        coll[kind][0] += time.perf_counter() - t0
        coll[kind][1] += 1
        return got

    def reset():
        for v in coll.values():
            v[:] = [0.0, 0]

    mesh_mod.all_gather = timed
    art = make_artifact(cfg, seed)
    X_np, Y_np = points_from_data(kodak_data(seed), cfg)
    R = X_np.shape[0]
    codec, state0 = init_codec(art, R)
    part = mesh_mod.partition(mesh, 1, cfg)
    X = mesh_mod.shard_rows(torch.from_numpy(X_np).cuda(), part)
    Y = mesh_mod.shard_rows(torch.from_numpy(Y_np).cuda(), part)
    st = mesh_mod.shard_rows(state0, part)
    out = {"rank": rank, "device": torch.cuda.current_device(), "card": card_line(),
           "sharded": part.sharded, "reason": part.reason, "rows": X.shape[0]}
    out["pe"], out["grad"] = halo_lpe_to_pe(codec.up, cfg, R, seed + 3, part)
    torch.cuda.reset_peak_memory_stats()
    finetunes = {n: CUT_FINETUNE_EPOCHS for n in codec.level_names}
    for mode, prec in modes.items():
        with platform.ambient(prec):
            zero_launches()
            reset()
            t0 = time.perf_counter()
            r = progressive.compress(codec, st, X, Y, cfg,
                                     torch.Generator(device="cuda").manual_seed(seed),
                                     n_optimize_epochs=CUT_PHASE1_EPOCHS, sample_size=S,
                                     finetune_overrides=finetunes)
            torch.cuda.synchronize()
            m = out[mode] = {"wall_s": time.perf_counter() - t0,
                             "launches": dict(fused_inr.launches),
                             "epochs": r.timings["phase1_epochs"] + r.timings["finetune_epochs"],
                             "collective_s": {k: v[0] for k, v in coll.items()},
                             "collectives": {k: v[1] for k, v in coll.items()},
                             "indices": r.indices, "reconstruction": r.reconstruction,
                             "psnr": float(np.mean(r.distortion))}
            if rank == 0:
                write_bitstream(os.path.join(out_dir, f"kodak_{mode}.rctb"), r.indices,
                                config_name=cfg.name, codebook_seed=art.codebook_seed,
                                codebook_kind=art.codebook_kind,
                                bits_per_group=cfg.bits_per_group)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            encoder.optimize(codec, st, X, Y, cfg, gen, n_epochs=2, sample_size=S)
            for on in (False, True):  # epoch_s as a user runs it, then each collective timed
                mesh_mod.all_gather = timed if on else real
                torch.cuda.synchronize()
                reset()
                t0 = time.perf_counter()
                encoder.optimize(codec, st, X, Y, cfg, gen, n_epochs=SCALE_TIMED, sample_size=S)
                torch.cuda.synchronize()
                m["epoch_s_timed" if on else "epoch_s"] = (time.perf_counter() - t0) / SCALE_TIMED
            m["epoch_collective_ms"] = {k: 1e3 * v[0] / SCALE_TIMED for k, v in coll.items()}
            m["device_ms"] = m["idle"] = m["nccl_ms"] = None
            if mesh.world <= torch.cuda.device_count():  # a card of its own: profile it
                mesh_mod.all_gather = real
                busy_us, wall_us, by_kernel = device_time_by_kernel(
                    lambda: encoder.optimize(codec, st, X, Y, cfg, gen, n_epochs=1,
                                             sample_size=S), 5)
                mesh_mod.all_gather = timed
                m["device_ms"], m["idle"] = busy_us / 5e3, 1 - busy_us / wall_us
                m["nccl_ms"] = sum(us for k, us in by_kernel.items() if "nccl" in k.lower()) / 5e3
            del r
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    torch.save(out, os.path.join(out_dir, f"patch_{rank}.pt"))


def kodak_world1(seed: int, modes: dict) -> dict:
    """World size 1 in this process: for each mode the Kodak encode of
    ``patch_rank``, and the same with its initial w means nudged by 1e-7
    (relative), to show how far rounding alone moves it. Returns (the
    encodes, each mode's index agreement with its nudged run, the codec,
    the artifact, X)."""
    cfg = KODAK
    art = make_artifact(cfg, seed)
    X_np, Y_np = points_from_data(kodak_data(seed), cfg)
    codec, state0 = init_codec(art, X_np.shape[0])
    X, Y = torch.from_numpy(X_np).cuda(), torch.from_numpy(Y_np).cuda()
    nudged = dataclasses.replace(state0, w=dataclasses.replace(state0.w, q=Gaussian(
        state0.w.q.loc * (1 + 1e-7), state0.w.q.log_scale)))
    finetunes = {n: CUT_FINETUNE_EPOCHS for n in codec.level_names}
    one, nudge = {}, {}
    for mode, prec in modes.items():
        with platform.ambient(prec):
            one[mode], again = (
                progressive.compress(codec, s, X, Y, cfg,
                                     torch.Generator(device="cuda").manual_seed(seed),
                                     n_optimize_epochs=CUT_PHASE1_EPOCHS,
                                     sample_size=SAMPLE_SIZE, finetune_overrides=finetunes)
                for s in (state0, nudged))
        nudge[mode] = index_agreement(again.indices, one[mode].indices)
    return {"encode": one, "nudge": nudge, "codec": codec, "art": art, "X": X}


def index_agreement(a: dict, b: dict) -> float:
    """The share of equal indices over every level."""
    x = np.concatenate([np.ravel(a[n]) for n in sorted(a)])
    y = np.concatenate([np.ravel(b[n]) for n in sorted(b)])
    return float(np.mean(x == y))


def kodak_world2(seed: int, card: str, tmp_root: str) -> dict:
    """SCALE_RANKS ranks on the one card over gloo, one Kodak image's 96
    patch rows split 48 a rank (``patch_rank``), under --precision highest
    and at the ambient (TF32), against world size 1 in this process
    (``kodak_world1``): both ranks return the same encode; its indices at
    least 1 - 2 (1 - a) equal to world size 1's, a world size 1's agreement
    with its own nudged encode; the PSNR within 0.3 dB; rank 0's bitstream
    decoded in one process within DECODE_TOL of the reconstruction; the
    encode's launches held to its epochs on every rank; the halo-split
    ``lpe_to_pe`` and its gradient within HALO_OF_MAX of the whole canvas."""
    cfg = KODAK
    out_dir = os.path.join(tmp_root, "kodak_world2")
    os.makedirs(out_dir)
    inp = os.path.join(out_dir, "in.pt")
    torch.save({"seed": seed}, inp)
    t0 = time.perf_counter()
    launch.spawn(patch_rank, SCALE_RANKS, (inp, out_dir, SCALE_MODES), backend="gloo",
                 cuda="shared", timeout_s=SCALE_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"patch_{r}.pt"), weights_only=False)
             for r in range(SCALE_RANKS)]
    one = kodak_world1(seed, SCALE_MODES)
    codec, X = one["codec"], one["X"]
    R = X.shape[0]
    pe, grad = halo_lpe_to_pe(codec.up, cfg, R, seed + 3, None)
    checks, out = {}, {"spawn_s": spawn_s, "layout": ranks[0]["reason"], "encode": {}}
    for what, got, want in (("PEs", ranks[0]["pe"], pe), ("LPE gradient", ranks[0]["grad"], grad)):
        err = (got - want).abs().max().item()
        of_max = err / want.abs().max().item()
        out[f"halo_{what}"] = of_max
        print(f"Kodak lpe_to_pe over {SCALE_RANKS} ranks (halo-split canvas, exact) vs the whole "
              f"canvas on the card, {what}: max abs diff {err:.3e}, {of_max:.3e} of the largest "
              f"entry (tolerance {HALO_OF_MAX})")
        checks[f"halo-split {what} within {HALO_OF_MAX} of the largest entry"] = (
            of_max <= HALO_OF_MAX)
    for mode in SCALE_MODES:
        ms_ = [r[mode] for r in ranks]
        ref = one["encode"][mode]
        frac = index_agreement(ms_[0]["indices"], ref.indices)
        floor = 1 - 2 * (1 - one["nudge"][mode])
        gap = ms_[0]["psnr"] - float(np.mean(ref.distortion))
        checks[f"{mode}: both ranks return the same encode"] = all(
            all(np.array_equal(m["indices"][n], ms_[0]["indices"][n]) for n in m["indices"])
            and np.array_equal(m["reconstruction"], ms_[0]["reconstruction"]) for m in ms_)
        checks[f"{mode}: launches: siren_bwd = epochs, siren_fwd >= epochs + 1 on every rank"] = (
            all(m["launches"]["siren_bwd"] == m["epochs"]
                and m["launches"]["siren_fwd"] >= m["epochs"] + 1 for m in ms_))
        checks[f"{mode}: indices >= {floor:.5f} equal to world size 1"] = frac >= floor
        checks[f"{mode}: PSNR within 0.3 dB of world size 1"] = abs(gap) < 0.3
        _, idx = read_bitstream(os.path.join(out_dir, f"kodak_{mode}.rctb"))
        y = decode(codec, idx, X, cfg).cpu()
        derr = (y - torch.from_numpy(ms_[0]["reconstruction"])).abs().max().item()
        torch.testing.assert_close(y, torch.from_numpy(ms_[0]["reconstruction"]), **DECODE_TOL)
        checks[f"{mode}: rank 0's bitstream decodes in one process within DECODE_TOL"] = True
        out["encode"][mode] = {"index_agreement": frac, "floor": floor, "psnr_gap_db": gap,
                               "nudge_index_agreement": one["nudge"][mode], "decode_err": derr}
        print(f"Kodak over {SCALE_RANKS} ranks on one card (gloo), {mode}: encode "
              f"(R={R}, {ranks[0]['rows']} rows a rank) against world size 1: indices equal "
              f"{frac:.5f} (floor {floor:.5f}; world size 1 against itself nudged by 1e-7 "
              f"{one['nudge'][mode]:.5f}), PSNR {ms_[0]['psnr']:.4f} against "
              f"{np.mean(ref.distortion):.4f} dB ({gap:+.5f}); rank 0's bitstream decoded in "
              f"one process: max abs diff {derr:.3e} [{card}]")
    print(f"Kodak over {SCALE_RANKS} ranks ({ranks[0]['reason']}; spawn and both ranks "
          f"{spawn_s:.3f} s):")
    for what, ok in checks.items():
        print(f"  {what}: {ok}")
    print(f"per rank (correctness plumbing on one shared card, not a scale-out speed) [{card}]:")
    out["ranks"] = []
    for r in ranks:
        entry = {"rank": r["rank"], "peak_mib": r["peak_mib"]}
        for mode in SCALE_MODES:
            m = r[mode]
            entry[mode] = {"epoch_s": m["epoch_s"], "epoch_s_timed": m["epoch_s_timed"],
                           "epoch_collective_ms": m["epoch_collective_ms"],
                           "encode_s": m["wall_s"], "encode_collective_s": m["collective_s"],
                           "encode_launches": m["launches"]}
            print(f"  rank {r['rank']} (cuda:{r['device']}), {mode}: epoch_s {m['epoch_s']:.6f} "
                  f"(S={SAMPLE_SIZE}); with each collective timed {m['epoch_s_timed']:.6f}, of "
                  "which collectives an epoch: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in m["epoch_collective_ms"].items())
                  + f"; compress (collectives timed) {m['wall_s']:.3f} s, {m['epochs']} epochs, "
                  "collectives "
                  + ", ".join(f"{k} {m['collectives'][k]} in {v:.3f} s"
                              for k, v in m["collective_s"].items())
                  + f"; launches {m['launches']}")
        print(f"  rank {r['rank']}: peak memory {r['peak_mib']:.1f} MiB")
        out["ranks"].append(entry)
    if not all(checks.values()):
        raise AssertionError("Kodak over ranks: " + ", ".join(k for k, v in checks.items()
                                                               if not v))
    return out


# the CIFAR decode check (card rows 0-7 against the CPU's, atol 1e-4 and
# rtol 1e-4) repeated this many times under each choice of cuDNN algorithms
DECODE_REPEATS = 5


def decode_repeats(codec, art, idx, X, cfg) -> dict:
    """The CIFAR decode check DECODE_REPEATS times on deterministic cuDNN
    algorithms (decode's own, since this slice) and on cuDNN's own choice
    (what decode ran on before): each mode's largest gap to the CPU, whether
    its decodes are bitwise equal, the decode wall in turns (own choice,
    deterministic, deterministic, own choice; mean of 20 after a warm
    call) and the device time of 10 decodes under the profiler."""
    feats, rows = X[0].cpu(), idx["w"][:8]
    y_cpu = decode(init_codec(art, len(rows), device="cpu")[0], {"w": rows},
                   feats.expand(len(rows), *feats.shape), cfg)
    out = {}
    choices = {"deterministic": decoder.deterministic_convs,
               "cudnn_choice": contextlib.nullcontext}
    for name in ("cudnn_choice", "deterministic"):
        with replaced(decoder, "deterministic_convs", lambda _: choices[name]):
            ys = [decode(codec, idx, X, cfg) for _ in range(DECODE_REPEATS)]
        gaps = [(y[:len(rows)].cpu() - y_cpu).abs() for y in ys]
        out[name] = {"max_gap": max(g.max().item() for g in gaps),
                     "bitwise_equal": all(torch.equal(y, ys[0]) for y in ys),
                     "over_tol": sum(int((g > ATOL + RTOL * y_cpu.abs()).sum()) for g in gaps),
                     "wall_ms": []}
    for name in ("cudnn_choice", "deterministic", "deterministic", "cudnn_choice"):
        with replaced(decoder, "deterministic_convs", lambda _: choices[name]):
            out[name]["wall_ms"].append(1e3 * wall_s(lambda: decode(codec, idx, X, cfg), 20))
    for name in choices:
        with replaced(decoder, "deterministic_convs", lambda _: choices[name]):
            busy, wall, _ = device_time_by_kernel(lambda: decode(codec, idx, X, cfg), 10)
        out[name]["device_ms"], out[name]["idle"] = busy / 1e4, 1 - busy / wall
    return out


def precision_modes(codec, state0, X, Y, art, idx, res, seed: int, card: str, kodak: dict,
                    modalities: dict, train: dict) -> dict:
    """The precision modes on the card: epoch_s (CIFAR S = 5 and S = 3, and
    the Kodak, video and training ones measured in their phases) under the
    ambient (TF32) and under --precision highest; a CIFAR epoch's device
    time and conv share under each; the CIFAR encode of the encode slice
    repeated (bitwise) and run again under highest, both bitstreams decoded
    back, the PSNR gap; the audio encode's flags; one epoch traced with
    ``utils.tracing.trace``; ``blocked_inr`` against ``inr_forward_fused``;
    the decode check repeated (``decode_repeats``)."""
    cfg = CIFAR
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def epochs(n, S=SAMPLE_SIZE):
        return encoder.optimize(codec, state0, X, Y, cfg, gen, n_epochs=n, sample_size=S)

    times = {
        f"CIFAR epoch_s (R={N_ROWS}, S={SAMPLE_SIZE})":
            by_mode(lambda: wall_s(lambda: epochs(10), 1) / 10),
        f"CIFAR epoch_s at S=3 (R={N_ROWS})":
            by_mode(lambda: wall_s(lambda: epochs(10, 3), 1) / 10),
        f"Kodak epoch_s (R={kodak['rows']}, S={SAMPLE_SIZE})": kodak["encode"]["epoch_s_by_mode"],
        f"Video epoch_s (R={modalities['video']['rows']}, S={SAMPLE_SIZE})":
            modalities["video"]["encode"]["epoch_s_by_mode"],
        f"Audio epoch_s (R={modalities['audio']['rows']}, S={SAMPLE_SIZE})":
            modalities["audio"]["encode"]["epoch_s_by_mode"],
        f"train_epoch_s (CIFAR R={TRAIN_ROWS}, S=1)": train["timing"]["train_epoch_s_by_mode"],
    }
    print("host clock around 10 warm epochs, synchronised; each mode twice, in turns ambient, "
          "highest, highest, ambient:")
    for what, t in times.items():
        print("  " + mode_line(what, t) + f" [{card}]")
    out["epoch_s_by_mode"] = times
    prof = {}
    for m in MODES:
        with platform.ambient(None if m == "ambient" else m):
            busy, wall, by_kernel = device_time_by_kernel(lambda: epochs(1), 5)
        prof[m] = {"device_ms": busy / 5e3, "idle": 1 - busy / wall,
                   "conv_share": conv_share(by_kernel)}
        print(f"CIFAR epoch (R={N_ROWS}, S={SAMPLE_SIZE}) at {m}, 5 epochs under the profiler: "
              f"{prof[m]['device_ms']:.3f} ms device time per epoch, idle share "
              f"{prof[m]['idle']:.4f}, the conv stack's cuDNN kernels "
              f"{100 * prof[m]['conv_share']:.1f}% [{card}]")
    tt = train["timing"]
    print(f"training epoch (CIFAR R={TRAIN_ROWS}, S=1) device time: ambient "
          f"{tt['device_ms']:.3f} ms (conv stack "
          f"{100 * tt['parts_ms']['conv stack (cuDNN)'] / tt['device_ms']:.1f}%), highest "
          f"{tt['device_ms_highest']:.3f} ms (conv stack "
          f"{100 * tt['parts_ms_highest']['conv stack (cuDNN)'] / tt['device_ms_highest']:.1f}%) "
          f"[{card}]")
    out["cifar_epoch_profile"] = prof

    def encode():
        return progressive.compress(
            codec, state0, X, Y, cfg, torch.Generator(device="cuda").manual_seed(seed),
            n_optimize_epochs=ENCODE_PHASE1_EPOCHS, sample_size=SAMPLE_SIZE,
            finetune_overrides={"w": ENCODE_FINETUNE_EPOCHS})

    again = encode()
    with platform.ambient("highest"):
        hi = encode()
    repeat = (np.array_equal(again.indices["w"], res.indices["w"])
              and same_posteriors(again.state, res.state)
              and np.array_equal(again.reconstruction, res.reconstruction))
    runs = {"none": res, "highest": hi}
    nbytes = {m: check_bitstream(codec, r, X, cfg, art, f"CIFAR encode, --precision {m}")
              for m, r in runs.items()}
    psnr = {m: float(np.mean(r.distortion)) for m, r in runs.items()}
    moved = int((hi.indices["w"] != res.indices["w"]).sum())
    print(f"CIFAR encode R={N_ROWS} (phase 1 {ENCODE_PHASE1_EPOCHS} epochs, 1-epoch finetunes) "
          f"from one generator state: --precision none {nbytes['none']} bytes, "
          f"{res.bitrate:.4f} bpp, PSNR {psnr['none']:.4f} dB (optimize "
          f"{res.timings['optimize_s']:.3f} s, code {res.timings['code_s']:.3f} s); highest "
          f"{nbytes['highest']} bytes, {hi.bitrate:.4f} bpp, PSNR {psnr['highest']:.4f} dB "
          f"(optimize {hi.timings['optimize_s']:.3f} s, code {hi.timings['code_s']:.3f} s); PSNR "
          f"gap none - highest {psnr['none'] - psnr['highest']:+.4f} dB; {moved} of "
          f"{hi.indices['w'].size} indices differ; the none-mode encode repeated: bitwise "
          f"equal {repeat} [{card}]")
    if not repeat:
        raise AssertionError("the CIFAR encode at the ambient TF32 does not repeat bit for bit")
    out["encode"] = {"bytes": nbytes, "psnr": psnr, "psnr_gap": psnr["none"] - psnr["highest"],
                     "indices_differ": moved, "repeat": repeat}
    out["audio_flags"] = modalities["audio"]["encode"]["flags"]
    print(f"audio encode (--precision none): (cuBLAS TF32, cuDNN TF32) at every product "
          f"{out['audio_flags']}: the unrounded-PSNR auto ran its finetunes exact")

    with tempfile.TemporaryDirectory() as tmp:
        with tracing.trace(tmp):
            epochs(1)
        path = os.path.join(tmp, tracing.TRACE_FILE)
        with open(path) as f:
            text = f.read()
    names_bwd = "siren_bwd" in text
    print(f"one CIFAR epoch under utils.tracing.trace: {tracing.TRACE_FILE} of {len(text)} bytes, "
          f"names siren_bwd {names_bwd}")
    if not names_bwd:
        raise AssertionError("the trace of a CIFAR epoch does not name the siren_bwd kernel")
    out["trace_bytes"] = len(text)

    with torch.no_grad(), exact_f32():
        g = torch.Generator(device="cuda").manual_seed(seed + 3)
        n = cfg.n_inr_params
        x = torch.randn(N_ROWS, SAMPLE_SIZE, cfg.n_pixels, cfg.input_dim, generator=g,
                        device="cuda")
        loc = torch.as_tensor(art.w.p_loc[:n], device="cuda")
        scale = torch.as_tensor(art.w.p_scale[:n], device="cuda")
        h_w = loc + scale * torch.randn(N_ROWS, SAMPLE_SIZE, n, generator=g, device="cuda")
        fused = fused_inr.inr_forward_fused(x, h_w, codec.A, cfg)
        blocked = inr_forward_blocked(x, h_w, codec.A, cfg)
        err = (blocked - fused).abs()
        bad = int((err > ATOL + RTOL * fused.abs()).sum())
        ms = {"fused": cuda_ms(lambda: fused_inr.inr_forward_fused(x, h_w, codec.A, cfg), 10),
              "blocked": cuda_ms(lambda: inr_forward_blocked(x, h_w, codec.A, cfg), 10)}
    print(f"blocked_inr vs inr_forward_fused (siren_fwd), R={N_ROWS} S={SAMPLE_SIZE} "
          f"P={cfg.n_pixels}, exact f32: max abs diff {err.max().item():.3e} (atol {ATOL}, rtol "
          f"{RTOL}); {ms['blocked']:.4f} ms blocked (4 samples per block-diagonal bmm), "
          f"{ms['fused']:.4f} ms fused, A-transforms included [{card}]")
    if bad or not torch.isfinite(blocked).all():
        raise AssertionError(f"blocked_inr disagrees with inr_forward_fused in {bad} entries")
    out["blocked_inr"] = {"max_abs_err": err.max().item(), "ms": ms}
    del x, h_w, fused, blocked, err

    repeats = decode_repeats(codec, art, idx, X, cfg)
    for name, r in repeats.items():
        on = {"deterministic": "deterministic cuDNN algorithms",
              "cudnn_choice": "cuDNN's own choice of algorithms"}[name]
        print(f"CIFAR decode check x{DECODE_REPEATS} on {on}: "
              f"largest gap card rows 0-7 vs CPU {r['max_gap']:.3e} (atol {ATOL}, rtol {RTOL}), "
              f"{r['over_tol']} entries over; decodes bitwise equal {r['bitwise_equal']}; decode "
              f"R={N_ROWS} wall {r['wall_ms'][0]:.3f} / {r['wall_ms'][1]:.3f} ms, device "
              f"{r['device_ms']:.3f} ms (idle share {r['idle']:.4f}) [{card}]")
    if repeats["deterministic"]["over_tol"] or not repeats["deterministic"]["bitwise_equal"]:
        raise AssertionError("decode on deterministic algorithms missed its CPU check or did not "
                             "repeat")
    out["decode_repeats"] = repeats
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    cfg = CIFAR
    dims = cfg.net_dims
    P = cfg.n_pixels

    with phase("card"):
        card = card_line()
        print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    with phase("build"):
        for name, built in _build.build_all(["siren_fwd", "siren_bwd"]).items():
            print(f"nvcc build {name}: {built.seconds:.2f} s -> {built.path}")
            for line in built.log.splitlines():
                if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                    print("  " + line.strip())
            for inst, regs in ptxas_by_instance(built.log).items():
                print(f"  {name} instance {inst}: {regs}")
        for name in ("siren_fwd", "siren_bwd"):
            print(f"{name} design: {DESIGN[name]}")
            for c in (CIFAR, AUDIO, VIDEO, TINY):
                print(f"  launch plan at {c.name}'s widths {list(c.net_dims)}: "
                      f"{fused_inr.launch_plan(name, list(c.net_dims))}")

    art = make_cifar_artifact(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = []
    with phase("kernel vs plain version"), exact_f32():
        x, theta = kernel_inputs(art, N_ROWS, P, gen)
        ref = fused_inr.siren_forward_reference(x, theta, dims, cfg.w0)
        for spb in (1, 8):
            got = fused_inr.siren_forward(x, theta, dims, cfg.w0, samples_per_block=spb)
            torch.cuda.synchronize()
            errs.append(max_err(got, ref))
            print(f"B={N_ROWS} P={P} samples_per_block={spb}: max abs diff {errs[-1]:.3e} "
                  f"(atol {ATOL}, rtol {RTOL})")
            if spb == 1:
                gap = f64_gaps(got, ref, fused_inr.siren_forward_reference(
                    x.double(), theta.double(), dims, cfg.w0))
                cifar_fwd_ratio = gap[0] / gap[1]
                print(f"  vs an f64 evaluation: max abs diff over the largest entry {gap[0]:.3e} "
                      f"kernel, {gap[1]:.3e} plain version")
        x3, theta3 = kernel_inputs(art, 3, 1000, gen)
        ref3 = fused_inr.siren_forward_reference(x3, theta3, dims, cfg.w0)
        for spb in (1, 8):
            got = fused_inr.siren_forward(x3, theta3, dims, cfg.w0, samples_per_block=spb)
            torch.cuda.synchronize()
            errs.append(max_err(got, ref3))
            print(f"B=3 P=1000 samples_per_block={spb}: max abs diff {errs[-1]:.3e}")

    B_enc = N_ROWS * SAMPLE_SIZE
    bwd_errs = []
    with phase("siren_bwd vs plain version"), exact_f32():
        xb, thetab = kernel_inputs(art, B_enc, P, gen)
        dyb = torch.randn(B_enc, P, cfg.output_dim, generator=gen, device="cuda")
        # the forward at the encode's shape, in the launch SirenMLP makes
        got = fused_inr.siren_forward(xb, thetab, dims, cfg.w0, samples_per_block=1)
        torch.cuda.synchronize()
        errs.append(max_err(got, fused_inr.siren_forward_reference(xb, thetab, dims, cfg.w0)))
        print(f"siren_fwd B={B_enc} P={P} samples_per_block=1: max abs diff {errs[-1]:.3e} "
              f"(atol {ATOL}, rtol {RTOL})")
        cases = [(xb, thetab, dyb)]
        x3b, theta3b = kernel_inputs(art, 3, 1000, gen)
        cases.append((x3b, theta3b, torch.randn(3, 1000, cfg.output_dim, generator=gen,
                                                device="cuda")))
        for i, (xc, tc, dyc) in enumerate(cases):
            got = fused_inr.siren_backward(xc, tc, dyc, dims, cfg.w0)
            again = fused_inr.siren_backward(xc, tc, dyc, dims, cfg.w0)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                raise AssertionError("two siren_bwd launches on the same inputs differ")
            ref_dx, ref_dtheta = fused_inr.siren_backward_reference(xc, tc, dyc, dims, cfg.w0)
            e = (max_err_of_max(got[0], ref_dx, "dx"), max_err_of_max(got[1], ref_dtheta, "dtheta"))
            bwd_errs += e
            print(f"B={xc.shape[0]} P={xc.shape[1]}: max abs diff dx {e[0]:.3e} (largest "
                  f"{ref_dx.abs().max().item():.3e}), dtheta {e[1]:.3e} (largest "
                  f"{ref_dtheta.abs().max().item():.3e}); tolerance {BWD_OF_MAX} of the largest; "
                  "two launches bitwise equal")
            if i == 0:
                ref64 = fused_inr.siren_backward_reference(
                    xc.double(), tc.double(), dyc.double(), dims, cfg.w0)
                gaps = [f64_gaps(k, r, r64) for k, r, r64 in zip(got, (ref_dx, ref_dtheta), ref64)]
                cifar_bwd_ratio = max(k / p for k, p in gaps)
                del ref64
                print(f"B={xc.shape[0]} P={xc.shape[1]} vs an f64 evaluation: max abs diff over "
                      f"the largest entry, dx {gaps[0][0]:.3e} kernel, {gaps[0][1]:.3e} plain; "
                      f"dtheta {gaps[1][0]:.3e} kernel, {gaps[1][1]:.3e} plain")
        # freed here and drawn again for the timings, so that decode's peak
        # memory below counts what it counted before this phase existed
        del ref_dx, ref_dtheta, got, again, cases, xb, thetab, dyb

    with phase("run-time-width instance vs plain version"), exact_f32():
        runtime = runtime_instance_checks(args.seed, card, errs, bwd_errs)

    with phase("decode slice"):
        codec, state0 = init_codec(art, N_ROWS)
        rng = np.random.default_rng(args.seed)
        idx = {"w": rng.integers(0, 2**cfg.bits_per_group, (N_ROWS, codec.w.n_groups))}
        feats = torch.from_numpy(grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim))
        X = feats.cuda().expand(N_ROWS, *feats.shape)
        torch.cuda.synchronize()
        for k in fused_inr.launches:
            fused_inr.launches[k] = 0
        y = decode(codec, idx, X, cfg)
        torch.cuda.synchronize()
        launched = dict(fused_inr.launches)
        print(f"kernel launches in decode: {launched}")
        if launched["siren_fwd"] < 1:
            raise AssertionError("decode did not go through the siren_fwd kernel")
        if y.shape != (N_ROWS, P, cfg.output_dim) or not torch.isfinite(y).all():
            raise AssertionError(f"decode output: shape {tuple(y.shape)}, finite "
                                 f"{bool(torch.isfinite(y).all())}")
        codec_cpu, _ = init_codec(art, 8, device="cpu")
        y_cpu = decode(codec_cpu, {"w": idx["w"][:8]}, feats.expand(8, *feats.shape), cfg)
        derr = (y[:8].cpu() - y_cpu).abs()
        print(f"decode rows 0-7, card vs CPU: max abs diff {derr.max().item():.3e} "
              f"(atol {ATOL}, rtol {RTOL}); output range "
              f"[{y.min().item():.4f}, {y.max().item():.4f}]")
        if (derr > ATOL + RTOL * y_cpu.abs()).any():
            raise AssertionError("decode on the card disagrees with decode on the CPU")

    with phase("encode slice"):
        imgs = smooth_images(N_ROWS, args.seed)
        Y = torch.from_numpy(imgs.reshape(N_ROWS, P, cfg.output_dim)).cuda()
        gen_enc = torch.Generator(device="cuda").manual_seed(args.seed)
        torch.cuda.synchronize()
        for k in fused_inr.launches:
            fused_inr.launches[k] = 0
        res = progressive.compress(
            codec, state0, X, Y, cfg, gen_enc, n_optimize_epochs=ENCODE_PHASE1_EPOCHS,
            sample_size=SAMPLE_SIZE, finetune_overrides={"w": ENCODE_FINETUNE_EPOCHS})
        torch.cuda.synchronize()
        launched_enc = dict(fused_inr.launches)
        epochs = res.timings["phase1_epochs"] + res.timings["finetune_epochs"]
        print(f"kernel launches in compress: {launched_enc}; epochs run {epochs} "
              f"({res.timings['phase1_epochs']} phase 1 + {res.timings['finetune_epochs']} "
              f"finetune over {codec.w.n_groups} groups); cut from the reference schedule's "
              f"30000 + {progressive.finetune_epochs(cfg, codec.w.n_groups, 'w')} x "
              f"{codec.w.n_groups}")
        if launched_enc["siren_bwd"] != epochs or launched_enc["siren_fwd"] < epochs + 1:
            raise AssertionError("compress did not launch siren_bwd once per epoch and "
                                 "siren_fwd once per epoch plus the decode")
        if not res.state.w.compressed.all():
            raise AssertionError("compress left groups uncoded")
        print(f"encode R={N_ROWS} S={SAMPLE_SIZE}: optimize {res.timings['optimize_s']:.3f} s, "
              f"code {res.timings['code_s']:.3f} s, mean PSNR {np.mean(res.distortion):.4f} dB "
              f"@ {res.bitrate:.4f} bpp [{card}]")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bitstream_test_id_0.rctb")
            nbytes = write_bitstream(path, res.indices, config_name=cfg.name,
                                     codebook_seed=art.codebook_seed,
                                     codebook_kind=art.codebook_kind,
                                     bits_per_group=cfg.bits_per_group)
            _, idx_back = read_bitstream(path)
        y_back = decode(codec, idx_back, X, cfg).cpu().numpy()
        dist_back = metric(imgs.reshape(N_ROWS, P, cfg.output_dim), y_back, cfg.name)
        rec_err = float(np.abs(y_back - res.reconstruction).max())
        print(f"bitstream {nbytes} bytes, read back and decoded on the card: reconstruction max "
              f"abs diff {rec_err:.3e} to compress's, PSNR max diff "
              f"{np.abs(dist_back - res.distortion).max():.3e} dB (tolerance 1e-6 both)")
        if not np.isfinite(y_back).all() or rec_err > 1e-6 or (
                np.abs(dist_back - res.distortion).max() > 1e-6):
            raise AssertionError("the decoded bitstream does not reproduce compress's result")
        # one encode step on the card against the CPU's, from one state
        steps = []
        for dev in ("cuda", "cpu"):
            c8, s8 = init_codec(art, 8, device=dev)
            g8 = torch.Generator().manual_seed(args.seed)
            loc = s8.w.q.loc + 0.01 * torch.randn(s8.w.q.loc.shape, generator=g8).to(dev)
            s8 = dataclasses.replace(s8, w=dataclasses.replace(s8.w, q=Gaussian(
                loc, s8.w.q.log_scale)))
            steps.append(encoder.encode_step(c8, s8).w.indices.cpu())
        if not torch.equal(steps[0], steps[1]):
            raise AssertionError("encode_step on the card picks other samples than on the CPU")
        print("encode_step rows 0-7, card vs CPU: indices equal")

    with phase("timing"), exact_f32():
        ms = {spb: cuda_ms(lambda: fused_inr.siren_forward(x, theta, dims, cfg.w0, spb), 50)
              for spb in (1, 8)}
        plain_ms = cuda_ms(lambda: fused_inr.siren_forward_reference(x, theta, dims, cfg.w0), 20)
        flops, nbytes = fwd_work(x, theta, dims)
        bound_ms, bound_by, ops_route, fma_bound_ms = bounds(flops, nbytes)
        for spb in (1, 8):
            print(f"siren_fwd samples_per_block={spb}: {ms[spb]:.4f} ms "
                  f"({flops / ms[spb] / 1e9:.2f} TFLOP/s)")
        print(f"plain version (torch.baddbmm + sin): {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"by {bound_by} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; operations term "
              f"{ops_route}); FP32-FMA bound {fma_bound_ms:.4f} ms [{card}]")
        cifar_fwd = {"shape": [N_ROWS, P], "widths": list(dims), "ms": ms[1],
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "f64_ratio": cifar_fwd_ratio, **instance_report("siren_fwd", dims, N_ROWS, P)}

        decode(codec, idx, X, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            decode(codec, idx, X, cfg)
        torch.cuda.synchronize()
        dec_s = (time.perf_counter() - t0) / reps
        peak = torch.cuda.max_memory_allocated()
        print(f"decode R={N_ROWS}: {dec_s * 1e3:.3f} ms, {N_ROWS / dec_s:.1f} datapoints/s, "
              f"peak device memory {peak / 2**20:.1f} MiB [{card}]")

        xb, thetab = kernel_inputs(art, B_enc, P, gen)
        dyb = torch.randn(B_enc, P, cfg.output_dim, generator=gen, device="cuda")
        bwd_ms = cuda_ms(lambda: fused_inr.siren_backward(xb, thetab, dyb, dims, cfg.w0), 10)
        bwd_plain_ms = cuda_ms(
            lambda: fused_inr.siren_backward_reference(xb, thetab, dyb, dims, cfg.w0), 3, 1)
        bwd_flops, bwd_bytes = bwd_work(xb, thetab, dyb, dims)
        bwd_bound_ms, bwd_bound_by, bwd_ops_route, bwd_fma_bound_ms = bounds(bwd_flops,
                                                                              bwd_bytes)
        print(f"siren_bwd B={B_enc} P={P}: {bwd_ms:.4f} ms ({bwd_flops / bwd_ms / 1e9:.2f} "
              f"TFLOP/s); plain version (torch.bmm chain) {bwd_plain_ms:.4f} ms; bound "
              f"{bwd_bound_ms:.4f} ms by {bwd_bound_by} ({bwd_flops / 1e9:.3f} GFLOP, "
              f"{bwd_bytes / 1e6:.2f} MB; operations term {bwd_ops_route}); FP32-FMA bound "
              f"{bwd_fma_bound_ms:.4f} ms [{card}]")
        cifar_bwd = {"shape": [B_enc, P], "widths": list(dims), "ms": bwd_ms,
                     "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
                     "bound_by": bwd_bound_by, "f64_ratio": cifar_bwd_ratio,
                     **instance_report("siren_bwd", dims, B_enc, P)}
        print(f"instances at CIFAR's widths: siren_fwd {cifar_fwd['instance']} (ptxas "
              f"{cifar_fwd['ptxas']}), siren_bwd {cifar_bwd['instance']} (ptxas "
              f"{cifar_bwd['ptxas']})")
        del xb, thetab, dyb

        # S = 5 epochs at R = 500 from the fresh state, as phase 1 runs them
        def epochs(n):
            return encoder.optimize(codec, state0, X, Y, cfg, gen_enc, n_epochs=n,
                                    sample_size=SAMPLE_SIZE)

        epochs(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        epochs(10)
        torch.cuda.synchronize()
        epoch_s = (time.perf_counter() - t0) / 10
        epoch_peak = torch.cuda.max_memory_allocated()
        encoder.encode_step(codec, state0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            encoder.encode_step(codec, state0)
        torch.cuda.synchronize()
        code_step_s = (time.perf_counter() - t0) / 5
        print(f"epoch_s {epoch_s:.6f} (R={N_ROWS}, S={SAMPLE_SIZE}, mean of 10 warm epochs at "
              f"the ambient TF32), peak device memory {epoch_peak / 2**20:.1f} MiB; code_step_s "
              f"{code_step_s:.6f} (one encode_step, exact in every mode, mean of 5) [{card}]")

    n_prof = 10
    with phase("decode profile"):
        busy_us, wall_us, by_kernel = device_time_by_kernel(lambda: decode(codec, idx, X, cfg),
                                                            n_prof)
        print(f"decode R={N_ROWS}, {n_prof} decodes under the profiler: "
              f"{busy_us / 1e3 / n_prof:.3f} ms device time per decode in "
              f"{wall_us / 1e3 / n_prof:.3f} ms wall of the same decodes, idle share "
              f"{1 - busy_us / wall_us:.4f} (unprofiled decode {dec_s * 1e3:.3f} ms)")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {us / 1e3 / n_prof:8.4f} ms/decode {100 * us / busy_us:5.1f}%  {name[:100]}")

    with phase("epoch profile"):
        busy_us, wall_us, by_kernel = device_time_by_kernel(lambda: epochs(1), n_prof)
        epoch_idle = 1 - busy_us / wall_us
        print(f"encode R={N_ROWS} S={SAMPLE_SIZE}, {n_prof} epochs at the ambient TF32 under the "
              f"profiler: {busy_us / 1e3 / n_prof:.3f} ms device time per epoch in "
              f"{wall_us / 1e3 / n_prof:.3f} ms wall of the same epochs, idle share "
              f"{epoch_idle:.4f} (unprofiled epoch_s {epoch_s * 1e3:.3f} ms); the conv stack's "
              f"cuDNN kernels {100 * conv_share(by_kernel):.1f}%")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
            print(f"  {us / 1e3 / n_prof:8.4f} ms/epoch {100 * us / busy_us:5.1f}%  {name[:100]}")

    with phase("conv stacks"), exact_f32():
        lpe = torch.randn(N_ROWS * SAMPLE_SIZE, *cfg.lpe_spatial, cfg.latent_dim, generator=gen,
                          device="cuda")
        args_up = (cfg.data_dim, cfg.layerwise_scale_factors, cfg.paddings)
        plain_pe = apply_upsample(codec.up, lpe, *args_up)
        phase_pe = apply_upsample_phased(codec.up, lpe, *args_up)
        torch.cuda.synchronize()
        stack_err = (phase_pe - plain_pe).abs().max().item()
        print(f"phase stack vs plain stack on the card, {tuple(lpe.shape)} -> "
              f"{tuple(plain_pe.shape)}: max abs diff {stack_err:.3e} (atol {STACK_TOL['atol']}, "
              f"rtol {STACK_TOL['rtol']})")
        torch.testing.assert_close(phase_pe, plain_pe, **STACK_TOL)
        del lpe, plain_pe, phase_pe
        stacks = {"plain": apply_upsample, "phase": apply_upsample_phased}
        stack_times = {name: {"epoch_s": [], "decode_s": []} for name in stacks}
        for name in ("plain", "phase", "phase", "plain"):
            with stack(stacks[name]):
                stack_times[name]["epoch_s"].append(wall_s(lambda: epochs(10), 1) / 10)
                stack_times[name]["decode_s"].append(wall_s(lambda: decode(codec, idx, X, cfg),
                                                            5))
        for name, t in stack_times.items():
            print(f"{name} stack: epoch_s {t['epoch_s'][0]:.6f} / {t['epoch_s'][1]:.6f}, decode "
                  f"{1e3 * t['decode_s'][0]:.3f} / {1e3 * t['decode_s'][1]:.3f} ms (R={N_ROWS}, "
                  f"S={SAMPLE_SIZE}, epochs at the ambient TF32, decode exact; runs in the order "
                  f"plain, phase, phase, plain) [{card}]")
        print(f"mappings.lpe_to_pe uses: {mappings.STACK.__name__}")
        other = next(n for n, f in stacks.items() if f is not mappings.STACK)
        with stack(stacks[other]):
            busy_us, wall_us, by_kernel = device_time_by_kernel(lambda: epochs(1), n_prof)
        print(f"{other} stack, {n_prof} epochs under the profiler: {busy_us / 1e3 / n_prof:.3f} ms "
              f"device time per epoch in {wall_us / 1e3 / n_prof:.3f} ms wall (the epoch profile "
              "above is the other stack's)")
        for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {us / 1e3 / n_prof:8.4f} ms/epoch {100 * us / busy_us:5.1f}%  {name[:100]}")

    with phase("determinism"):
        det = determinism(codec, state0, X, Y, cfg, args.seed)
        print(f"two 20-epoch optimize runs from one state and generator state (R={N_ROWS}, "
              f"S={SAMPLE_SIZE}): bitwise equal {det['default']} on deterministic cuDNN "
              f"algorithms (epoch_s {det['epoch_s_default']:.6f}), {det['cudnn_choice']} on "
              f"cuDNN's own choice (epoch_s {det['epoch_s_cudnn_choice']:.6f}) [{card}]")
        if not det["default"]:
            raise AssertionError("two optimize runs from one state and generator state differ on "
                                 "the card: coding/encoder.py's determinism claim fails")

    with phase("adaptive encode"):
        zero_launches()
        t0 = time.perf_counter()
        res_a = progressive.compress(codec, state0, X, Y, cfg,
                                     torch.Generator(device="cuda").manual_seed(args.seed),
                                     sample_size=SAMPLE_SIZE, **ADAPTIVE)
        torch.cuda.synchronize()
        adaptive_s = time.perf_counter() - t0
        ta = res_a.timings
        launched_ad = read_launches(ta["phase1_epochs"] + ta["finetune_epochs"], "adaptive encode")
        p1_fired = ta["phase1_epochs"] < ADAPTIVE["n_optimize_epochs"]
        ft_fired = ta["finetune_epochs"] < ta["finetune_budget"]
        print(f"adaptive encode R={N_ROWS}: phase 1 {ta['phase1_epochs']} of "
              f"{ADAPTIVE['n_optimize_epochs']} epochs (S=3; stop fired {p1_fired}); finetunes "
              f"{ta['finetune_epochs']} of a budget of {ta['finetune_budget']} epochs (a stop "
              f"fired {ft_fired}); wall {adaptive_s:.3f} s (optimize {ta['optimize_s']:.3f} s, "
              f"code {ta['code_s']:.3f} s); mean PSNR {np.mean(res_a.distortion):.4f} dB @ "
              f"{res_a.bitrate:.4f} bpp [{card}]")
        if not (p1_fired and ft_fired and res_a.state.w.compressed.all()):
            raise AssertionError("the adaptive encode's stop tests did not both fire, or it left "
                                 "groups uncoded")
        check_bitstream(codec, res_a, X, cfg, art, "adaptive encode")
        epoch_s3 = wall_s(lambda: encoder.optimize(codec, state0, X, Y, cfg, gen_enc,
                                                   n_epochs=10, sample_size=3), 1) / 10
        print(f"epoch_s at S=3 {epoch_s3:.6f} (R={N_ROWS}, mean of 10 warm epochs) [{card}]")

    with phase("quality encode, crash and resume"):
        def quality(state, **kw):
            return progressive.compress(codec, state, X, Y, cfg,
                                        torch.Generator(device="cuda").manual_seed(args.seed),
                                        sample_size=SAMPLE_SIZE, **QUALITY, **kw)

        zero_launches()
        t0 = time.perf_counter()
        res_q = quality(state0)
        torch.cuda.synchronize()
        quality_s = time.perf_counter() - t0
        tq = res_q.timings
        launched_q = read_launches(tq["phase1_epochs"] + tq["finetune_epochs"], "quality encode")
        print(f"quality encode R={N_ROWS}: phase 1 {tq['phase1_epochs']} epochs, finetunes "
              f"{tq['finetune_epochs']} of {tq['finetune_budget']}; wall {quality_s:.3f} s; mean "
              f"PSNR {np.mean(res_q.distortion):.4f} dB @ {res_q.bitrate:.4f} bpp [{card}]")
        check_bitstream(codec, res_q, X, cfg, art, "quality encode")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "enc_state.npz")
            extra = {"state_path": path, "state_extra": {"prior_fingerprint":
                                                         prior_fingerprint(art)}}
            resume, state = {}, state0
            for crash_in in ("phase1", "coding"):
                with crash_after_first_snapshot(crash_in):
                    try:
                        quality(state, **extra, **resume)
                        raise AssertionError(f"no snapshot was taken in {crash_in}")
                    except Crash:
                        pass
                resume, state = resume_from(path, art, "cuda")
                print(f"crashed after the first {crash_in} snapshot; resuming at phase-1 epoch "
                      f"{resume['phase1_epochs_done']}, {int(state.w.compressed.sum(1).max())} "
                      "groups coded")
            res_r = quality(state, **extra, **resume)
        indices_equal = np.array_equal(res_r.indices["w"], res_q.indices["w"])
        posteriors_equal = same_posteriors(res_r.state, res_q.state)
        print(f"resumed twice vs uninterrupted: indices bitwise equal {indices_equal}, "
              f"posteriors bitwise equal {posteriors_equal}")
        check_bitstream(codec, res_r, X, cfg, art, "resumed quality encode")
        if not res_r.state.w.compressed.all():
            raise AssertionError("the resumed encode left groups uncoded")
        if not (indices_equal and posteriors_equal):
            raise AssertionError("the resumed encode differs from the uninterrupted one")

    kodak = kodak_phases(args.seed, card, errs, bwd_errs)
    modalities = modality_phases(args.seed, card, errs, bwd_errs)
    paths = {"kodak": kodak, **modalities}
    tmp_root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train = train_phases(args.seed, card, errs, bwd_errs, tmp_root)
        ct = train["cifar_train"]
        with phase("scale-out: world size 1 on NCCL through the CLIs"):
            world1 = scaleout_world1(args.seed, card, tmp_root, ct["argv"], ct["prior"])
        with phase(f"scale-out: world size {SCALE_RANKS} on one card (gloo)"):
            world2 = scaleout_world2(args.seed, card, tmp_root, ct["train_dir"])
        with phase(f"Kodak over {SCALE_RANKS} ranks on one card (gloo)"):
            kodak2 = kodak_world2(args.seed, card, tmp_root)
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)
    scale_out = {"world1": world1, "world2": world2, "kodak_world2": kodak2}
    train_launches = {"cifar_train": train["cifar_train"]["launches"],
                      "rd_sweep": train["rd_sweep"]["launches"],
                      "kodak_train": train["kodak_train"]["launches"],
                      "cli_compress_no_group": world1["no_group_launches"],
                      "scaleout_world1_nccl_cli_train": world1["train_launches"],
                      "scaleout_world1_nccl_cli_compress": world1["compress_launches"],
                      **{f"scaleout_world2_rank{r['rank']}_{mode}_{p}": r[mode][f"{p}_launches"]
                         for r in world2["ranks"] for mode in SCALE_MODES
                         for p in ("train", "encode")},
                      **{f"kodak_world2_rank{r['rank']}_{mode}_encode": r[mode]["encode_launches"]
                         for r in kodak2["ranks"] for mode in SCALE_MODES}}
    train_shapes = {"cifar_train": train["timing"], "kodak_train": train["kodak_train"]}
    with phase("precision modes"):
        modes = precision_modes(codec, state0, X, Y, art, idx, res, args.seed, card, kodak,
                                modalities, train)

    kernels = [{
        "name": "siren_fwd",
        "route": "cuda",
        "source": "recombiner_tpu_torch/ops/csrc/siren_fwd.cu",
        "replaces": "recombiner_tpu/ops/fused_inr.py:52",
        "also_replaces": "recombiner_tpu/ops/pallas_inr.py:40",
        "held_against": "recombiner_tpu_torch/ops/fused_inr.py::siren_forward_reference",
        "launches": launched_enc["siren_fwd"],
        "launches_by_path": {"decode": launched["siren_fwd"], "encode": launched_enc["siren_fwd"],
                             "adaptive_encode": launched_ad["siren_fwd"],
                             "quality_encode": launched_q["siren_fwd"],
                             **{p: n["siren_fwd"] for c in paths.values()
                                for p, n in c["launches"].items()},
                             **{p: n["siren_fwd"] for p, n in train_launches.items()}},
        "max_abs_err": max(errs),
        "ms": ms[1],
        "ms_8_samples_per_block": ms[8],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_route": ops_route if bound_by == "operations" else "HBM",
        "fp32_fma_bound_ms": fma_bound_ms,
        "library_ms": None,
        "instance": cifar_fwd["instance"],
        "instances": instance_rows("siren_fwd", cifar_fwd, paths, train_shapes, runtime),
        **{name: c["siren_fwd"] for name, c in paths.items()},
        **{name: c["siren_fwd"] for name, c in train_shapes.items()},
    }, {
        "name": "siren_bwd",
        "route": "cuda",
        "source": "recombiner_tpu_torch/ops/csrc/siren_bwd.cu",
        "replaces": "recombiner_tpu/ops/fused_inr.py:67",
        "held_against": "recombiner_tpu_torch/ops/fused_inr.py::siren_backward_reference",
        "launches": launched_enc["siren_bwd"],
        "launches_by_path": {"decode": launched["siren_bwd"], "encode": launched_enc["siren_bwd"],
                             "adaptive_encode": launched_ad["siren_bwd"],
                             "quality_encode": launched_q["siren_bwd"],
                             **{p: n["siren_bwd"] for c in paths.values()
                                for p, n in c["launches"].items()},
                             **{p: n["siren_bwd"] for p, n in train_launches.items()}},
        "max_abs_err": max(bwd_errs),
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "bound_route": bwd_ops_route if bwd_bound_by == "operations" else "HBM",
        "fp32_fma_bound_ms": bwd_fma_bound_ms,
        "library_ms": None,
        "instance": cifar_bwd["instance"],
        "instances": instance_rows("siren_bwd", cifar_bwd, paths, train_shapes, runtime),
        **{name: c["siren_bwd"] for name, c in paths.items()},
        **{name: c["siren_bwd"] for name, c in train_shapes.items()},
    }]
    print("kernels: siren_fwd (CUDA, replaces recombiner_tpu/ops/fused_inr.py::_fwd_kernel and "
          "recombiner_tpu/ops/pallas_inr.py::_kernel), held against siren_forward_reference "
          f"at atol {ATOL} rtol {RTOL}; siren_bwd (CUDA, replaces "
          "recombiner_tpu/ops/fused_inr.py::_bwd_kernel), held against siren_backward_reference "
          f"at {BWD_OF_MAX} of the largest gradient entry")
    print(f"encode: epoch_s {epoch_s:.6f}, code_step_s {code_step_s:.6f}, epoch peak memory "
          f"{epoch_peak / 2**20:.1f} MiB, epoch idle share {epoch_idle:.4f}, epoch_s at S=3 "
          f"{epoch_s3:.6f}, adaptive encode {adaptive_s:.3f} s, quality encode "
          f"{quality_s:.3f} s [{card}]")
    ke = kodak["encode"]
    print(f"Kodak (R={kodak['rows']}, S={SAMPLE_SIZE}): epoch_s {ke['epoch_s']:.6f}, epoch peak "
          f"memory {ke['peak_mib']:.1f} MiB, epoch idle share {ke['idle']:.4f}, code_step_s "
          + ", ".join(f"{n} {v:.6f}" for n, v in ke["code_step_s"].items())
          + f", encode {ke['wall_s']:.3f} s; decode {kodak['decode']['wall_ms']:.3f} ms wall, "
          f"{kodak['decode']['device_ms']:.3f} ms device, peak {kodak['decode']['peak_mib']:.1f} "
          f"MiB; remat epoch_s on {kodak['remat']['on']['epoch_s']}, off "
          f"{kodak['remat']['off']['epoch_s']}, peak on {kodak['remat']['on']['peak_mib']:.1f} / "
          f"off {kodak['remat']['off']['peak_mib']:.1f} MiB [{card}]")
    for name, c in modalities.items():
        e, d = c["encode"], c["decode"]
        print(f"{name} (R={c['rows']}, S={SAMPLE_SIZE}): epoch_s {e['epoch_s']:.6f} (device "
              f"{e['device_ms']:.3f} ms, conv kernels {100 * e['conv_share']:.1f}%), epoch peak "
              f"memory {e['peak_mib']:.1f} MiB, epoch idle share {e['idle']:.4f}, code_step_s "
              + ", ".join(f"{n} {v:.6f}" for n, v in e["code_step_s"].items())
              + f", encode {e['wall_s']:.3f} s; decode {d['wall_ms']:.3f} ms wall, "
              f"{d['device_ms']:.3f} ms device, peak {d['peak_mib']:.1f} MiB; export "
              f"{c['export']['files']} {c['export']['kind']} files [{card}]")
    tt, det = train["timing"], train["determinism"]
    print(f"prior training (CIFAR R={TRAIN_ROWS}, S=1): train_epoch_s {tt['train_epoch_s']:.6f}, "
          f"device {tt['device_ms']:.3f} ms per epoch, idle share {tt['idle']:.4f}, epoch peak "
          f"memory {tt['peak_mib']:.1f} MiB; cli.train {train['cifar_train']['wall_s']:.3f} s, "
          f"{train['cifar_train']['groups']} groups; rd_sweep {train['rd_sweep']['wall_s']:.3f} s, "
          f"PSNR {train['rd_sweep']['point']['distortion_mean']:.4f} dB @ "
          f"{train['rd_sweep']['point']['actual_bitrate']:.4f} bpp; Kodak em_train "
          f"{train['kodak_train']['wall_s']:.3f} s; repeats, resume and the relaunched "
          f"rd_sweeps bitwise equal, card vs CPU epoch within {det['card_vs_cpu_of_bound']:.3f} "
          f"of its bound [{card}]")
    e = modes["encode"]
    print("precision modes: highest / ambient epoch_s "
          + ", ".join(f"{what.split(' (')[0]} {sum(t['highest']) / sum(t['ambient']):.3f}"
                      for what, t in modes["epoch_s_by_mode"].items())
          + f"; CIFAR encode PSNR none {e['psnr']['none']:.4f}, highest "
          f"{e['psnr']['highest']:.4f} dB (gap {e['psnr_gap']:+.4f}), none repeats bitwise; "
          f"decode x{DECODE_REPEATS} largest gap "
          f"{modes['decode_repeats']['deterministic']['max_gap']:.3e} [{card}]")
    print(f"scale-out: world size 1 on NCCL bitwise equal to no group (cli.train, "
          f"cli.compress); world size {SCALE_RANKS} on one card (gloo): training (exact) within "
          f"{world2['train_of_bound']:.3f} of its bound; encode indices equal to world size 1 "
          + ", ".join(f"{mode} {e['index_agreement']:.5f} (floor {e['floor']:.5f}, PSNR "
                      f"{e['psnr_gap_db']:+.5f} dB)" for mode, e in world2["encode"].items())
          + "; per rank " + ", ".join(
              f"{mode} train_epoch_s {r[mode]['train_epoch_s']:.6f} (collectives "
              f"{1e3 * r[mode]['train_collective_s']:.3f} ms), epoch_s {r[mode]['epoch_s']:.6f}"
              for r in world2["ranks"] for mode in SCALE_MODES)
          + f" (correctness plumbing on one card, not a scale-out speed) [{card}]")
    print(f"Kodak over {SCALE_RANKS} ranks on one card (gloo; {kodak2['layout']}): encode "
          "indices equal to world size 1 "
          + ", ".join(f"{mode} {e['index_agreement']:.5f} (floor {e['floor']:.5f}, PSNR "
                      f"{e['psnr_gap_db']:+.5f} dB)" for mode, e in kodak2["encode"].items())
          + f"; halo-split PEs / gradient within {kodak2['halo_PEs']:.3e} / "
          f"{kodak2['halo_LPE gradient']:.3e} of the largest entry; per rank " + ", ".join(
              f"{mode} epoch_s {r[mode]['epoch_s']:.6f} (halo "
              f"{r[mode]['epoch_collective_ms']['halo']:.3f} ms, gathers "
              f"{r[mode]['epoch_collective_ms']['gathers']:.3f} ms)"
              for r in kodak2["ranks"] for mode in SCALE_MODES)
          + f" (one shared card, not a scale-out speed) [{card}]")
    for k in kernels:
        for r in k["instances"]:
            print(f"{k['name']} instance {r['instance']} at {r['where']} B={r['shape'][0]} "
                  f"P={r['shape'][1]}: {r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}; gap to f64 "
                  f"{r['f64_ratio']:.3f} times the plain version's; ptxas {r['ptxas']} [{card}]")
    print(f"total: {time.perf_counter() - t_all:.2f} s [{card}]")
    print(json.dumps({"scale_out": scale_out}))
    print(json.dumps({"precision_modes": modes}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
