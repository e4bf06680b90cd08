"""Compression CLI of the port, flag-compatible with
``recombiner_tpu/cli/compress.py``: encode one test batch (images from a
directory; audio and video clips or protein chains from its
``test_dataset.npz``) on the CUDA card (or, with ``--device cpu``, on the
CPU) on the reference, adaptive or quality schedule, resumable from
``--state_path``, and write the same ``Distortion_*.csv`` (unrounded PSNR
for the audio family, RMSD per chain for protein), ``GroupIndex_*.csv``
(and ``H_``/``HH_`` ones for a patch config such as kodak, audio or video)
and ``.rctb`` bitstream.

    python -m recombiner_tpu_torch.cli.compress --test_dir DIR --test_idx 0 \\
        --prior_path out/PRIOR_....npz --save_dir out/ [--schedule adaptive] \\
        [--state_path out/enc_state.npz] [--n_devices 2]

Data-parallel with ``--n_devices`` (``parallel/launch.py``): the rows are
sharded over the ranks by ``parallel/mesh.py::partition``, whole
datapoints when their count divides by the world size, and for a patch
config also one datapoint's patch rows in slabs of its canvas (a Kodak
image at 2 or 4 ranks); the line "Encoding on W ranks (rows sharded: ...)"
or "(replicated: ...)" says which and why. Rank 0 writes every file.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from recombiner_tpu_torch.coding.decoder import init_codec
from recombiner_tpu_torch.coding.progressive import compress
from recombiner_tpu_torch.data.load_data import load_test_set
from recombiner_tpu_torch.device import resolve_device
from recombiner_tpu_torch.io import encode_state
from recombiner_tpu_torch.io.atomic import load_snapshot_or_none
from recombiner_tpu_torch.io.bitstream import write_bitstream
from recombiner_tpu_torch.io.checkpoint import (
    accepted_fingerprints,
    load_prior_artifact,
    prior_fingerprint,
)
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.parallel.mesh import make_mesh, partition, shard_rows
from recombiner_tpu_torch.utils.memory import resolve_remat
from recombiner_tpu_torch.utils.platform import PRECISION_CHOICES, apply_precision_mode

PRECISION_HELP = (
    "matmul precision on the card, where the ambient f32 product is TF32 (cuBLAS and cuDNN "
    "allow_tf32 on) and 'highest' is exact f32. A* scoring and decode are exact in every "
    "mode. Default: phase 1 and finetunes at TF32, but exact finetunes for the "
    "unrounded-PSNR (audio-family) configs. 'default': TF32 finetunes for every config. "
    "'scoped': exact finetunes. 'scoped_high': TF32 finetunes (computes what 'default' "
    "computes). 'high': the process at TF32 (computes what the default computes). "
    "'highest': the process at exact f32, training included")


def parse_args(argv=None):
    """The JAX CLI's flags (``recombiner_tpu/cli/compress.py::parse_args``),
    each with its type, nargs, choices, action and default, plus
    ``--device``'s meaning here: the torch device."""
    p = argparse.ArgumentParser(description="Compress test datapoints with a trained prior "
                                            "(PyTorch port)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--test_dir", required=True)
    p.add_argument("--test_idx", type=int, required=True)
    p.add_argument("--dataset", default=None, help="must match the prior artifact if given")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' to run without one)")
    p.add_argument("--prior_path", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--save_bitstream", default=True)
    p.add_argument("--n_epochs", type=int, default=None,
                   help="phase-1 posterior optimisation epochs (default: the reference's "
                        "30000)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--sample_size", type=int, default=5)
    p.add_argument("--finetune_epochs", type=int, default=None,
                   help="per-group finetune epochs (default: the reference schedule)")
    p.add_argument("--state_path", default=None,
                   help="encode-state snapshot path: written every --save_every groups "
                        "and resumed from if it exists")
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks (one card each, or CPU processes with "
                        "--device cpu); default every visible card")
    p.add_argument("--sync_every", type=int, default=1,
                   help="flow-control batching in the JAX package; results identical, "
                        "so the port accepts and ignores it")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                   help="recompute the ELBO's forward in its backward (changes no number). "
                        "Default: on when the stored-activation estimate exceeds 8 GB, as in "
                        "the JAX package; --no-remat forces it off")
    p.add_argument("--finetune_crn", action=argparse.BooleanOptionalAction, default=None,
                   help="one noise stream for every coding finetune; default on for "
                        "patch configs only")
    p.add_argument("--schedule", default="reference",
                   choices=("reference", "adaptive", "quality"),
                   help="encode schedule: 'reference' (fixed budgets), 'adaptive' "
                        "(S=3 cosine-lr phase 1 and finetunes up to a plateau) or "
                        "'quality' (adaptive with S=5 phase 1 and cosine finetune lr 4e-4); "
                        "explicit flags override the preset")
    p.add_argument("--ft_lr", type=float, default=None)
    p.add_argument("--ft_lr_schedule", default=None, choices=(None, "cosine"))
    p.add_argument("--p1_stop", type=float, nargs=3, default=None,
                   metavar=("WINDOW", "REL_TOL", "MIN_EPOCHS"))
    p.add_argument("--ft_stop", type=float, nargs=3, default=None,
                   metavar=("WINDOW", "REL_TOL", "MIN_EPOCHS"))
    p.add_argument("--p1_lr", type=float, nargs=2, default=None, metavar=("PEAK", "FLOOR"))
    p.add_argument("--p1_samples", type=int, default=None)
    p.add_argument("--p1_monitor", default="mse", choices=("mse", "loss"),
                   help="phase-1 plateau statistic; only read with --p1_stop")
    p.add_argument("--fused_steps", type=int, default=None,
                   help="group steps per snapshot (the JAX package's fused coding "
                        "path); changes no number")
    p.add_argument("--precision", default=None, choices=PRECISION_CHOICES,
                   help=PRECISION_HELP)
    return p.parse_args(argv)


# Encode-schedule presets of the JAX package (recombiner_tpu/cli/compress.py:
# 140-170), measured there on the CIFAR head-to-head: presets, not format
# fields.
ADAPTIVE_PRESET = {
    "n_epochs": 15000,
    "p1_lr": (6e-4, 2e-5),
    "p1_samples": 3,
    "p1_stop": (2000.0, 2e-3, 8000.0),
    "ft_stop": (40.0, 1e-3, 80.0),
    "fused_steps": 8,
    "ft_lr": None,
    "ft_lr_schedule": None,
}
QUALITY_PRESET = {
    **ADAPTIVE_PRESET,
    "p1_samples": None,  # S = --sample_size (the reference's 5)
    "ft_lr": 4e-4,
    "ft_lr_schedule": "cosine",
}
SCHEDULE_PRESETS = {"adaptive": ADAPTIVE_PRESET, "quality": QUALITY_PRESET}


def resolve_schedule(args):
    """Explicit flags beat the --schedule preset. Returns (n_epochs, p1_lr,
    p1_samples, p1_stop, ft_stop, fused_steps, ft_lr, ft_lr_schedule);
    'reference' leaves the reference's fixed budgets (30k phase-1 epochs,
    main_compression.py:148)."""
    knobs = {k: getattr(args, k, None) for k in ADAPTIVE_PRESET}
    if args.schedule in SCHEDULE_PRESETS:
        for k, v in SCHEDULE_PRESETS[args.schedule].items():
            if knobs[k] is None:
                knobs[k] = v
    if knobs["n_epochs"] is None:
        knobs["n_epochs"] = 30000  # main_compression.py:148
    return tuple(knobs[k] for k in ("n_epochs", "p1_lr", "p1_samples", "p1_stop", "ft_stop",
                                    "fused_steps", "ft_lr", "ft_lr_schedule"))


def resume_from(state_path: str, art, device):
    """(keyword arguments of ``compress`` that continue the snapshot at
    ``state_path``, the state to start from), or ({}, None) when there is
    none to continue: the resume flow of ``recombiner_tpu/cli/compress.py``
    with the port's generator state and the phase-1 window carry."""
    dev = torch.device(device)
    try:
        loaded, reason = load_snapshot_or_none(
            state_path,
            lambda p: encode_state.load_encode_state_full(p, accepted_fingerprints(art),
                                                          device=dev))
    except encode_state.FingerprintMismatch as e:
        # a snapshot from another prior: refusing beats a silently wrong
        # bitstream (its frozen samples index the other prior's codebooks)
        loaded, reason = None, str(e)
    if reason:
        print(f"WARNING: {reason}; encoding from scratch", flush=True)
    if loaded is None:
        return {}, None
    state, header, opt_leaves = loaded
    gen_state = encode_state.generator_state(header, dev)
    if gen_state is None:
        print(f"Snapshot {state_path} holds no {dev.type} generator state (written by the "
              "JAX package or on another device): the noise stream restarts from --seed",
              flush=True)
    print(f"Resumed encode state from {state_path}", flush=True)
    return {"phase1_epochs_done": int(header.get("phase1_epochs_done", 0)),
            "phase1_opt_leaves": opt_leaves,
            "phase1_es": header.get("phase1_es"),
            "resume_generator_state": gen_state}, state


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if launch.spawn_if_needed("recombiner_tpu_torch.cli.compress", argv, args.n_devices, dev):
        return None  # the spawned ranks ran it
    mesh = make_mesh(args.n_devices)
    dev = launch.rank_device(dev)
    primary = launch.is_primary()
    coding_precision = apply_precision_mode(args.precision)
    art = load_prior_artifact(args.prior_path)
    cfg = art.config
    if args.dataset is not None and args.dataset != cfg.name:
        raise SystemExit(f"--dataset {args.dataset} does not match the prior artifact "
                         f"({cfg.name})")
    X, Y = load_test_set(args.test_dir, args.test_idx, cfg)
    codec, state = init_codec(art, X.shape[0], device=dev)
    resume = {}
    if args.state_path:
        resume, restored = resume_from(args.state_path, art, dev)
        state = state if restored is None else restored
    part = partition(mesh, X.shape[0] // cfg.patches_per_datapoint, cfg)
    state = shard_rows(state, part)
    X, Y = shard_rows(X, part), shard_rows(Y, part)
    if mesh.world > 1 and primary:
        print(f"Encoding on {mesh.world} ranks "
              f"({'rows sharded' if part.sharded else 'replicated'}: {part.reason})", flush=True)
    remat = resolve_remat(args.remat, cfg, X.shape[0], args.sample_size)  # this rank's rows
    n_groups = [codec.meta(n).n_groups for n in codec.level_names]
    if primary:
        print(f"Model initialized. Expected bitrate {cfg.bitrate_of_groups(*n_groups):.3f}",
              flush=True)
    (n_epochs, p1_lr, p1_samples, p1_stop, ft_stop, fused_steps,
     ft_lr, ft_lr_schedule) = resolve_schedule(args)
    result = compress(
        codec, state, X, Y, cfg, torch.Generator(device=dev).manual_seed(args.seed),
        n_optimize_epochs=n_epochs, lr=args.lr, sample_size=args.sample_size,
        phase1_stop=tuple(p1_stop) if p1_stop is not None else None,
        finetune_stop=tuple(ft_stop) if ft_stop is not None else None,
        phase1_monitor=args.p1_monitor,
        phase1_lr=tuple(p1_lr) if p1_lr else None,
        phase1_sample_size=p1_samples,
        fused_steps=fused_steps,
        finetune_lr=ft_lr,
        finetune_lr_schedule=ft_lr_schedule,
        finetune_overrides=(None if args.finetune_epochs is None
                            else {k: args.finetune_epochs for k in codec.level_names}),
        verbose=True,
        state_path=args.state_path,
        save_every=args.save_every,
        remat=remat,
        state_extra={"prior_fingerprint": prior_fingerprint(art)},
        finetune_crn=args.finetune_crn,
        coding_precision=coding_precision,
        **resume,
    )

    if not primary:
        return result
    os.makedirs(args.save_dir, exist_ok=True)
    np.savetxt(os.path.join(args.save_dir, f"Distortion_test_id_{args.test_idx}.csv"),
               np.atleast_2d(result.distortion), delimiter=",")
    if int(bool(args.save_bitstream)):
        prefix = {"w": "", "h": "H_", "hh": "HH_"}
        for name, idx in result.indices.items():
            np.savetxt(os.path.join(args.save_dir,
                                    f"{prefix[name]}GroupIndex_test_id_{args.test_idx}.csv"),
                       idx, delimiter=",")
        n = write_bitstream(
            os.path.join(args.save_dir, f"bitstream_test_id_{args.test_idx}.rctb"),
            result.indices,
            config_name=cfg.name,
            codebook_seed=art.codebook_seed,
            codebook_kind=art.codebook_kind,
            bits_per_group=cfg.bits_per_group,
            extra={"test_idx": args.test_idx},
        )
        print(f"Bitstream: {n} bytes", flush=True)
    print(f"Distortion {np.mean(result.distortion):.4f} @ {result.bitrate:.4f} "
          f"(optimize {result.timings['optimize_s']:.1f}s, code {result.timings['code_s']:.1f}s)",
          flush=True)
    return result


if __name__ == "__main__":
    main()
