"""Compression CLI of the port, flag-compatible with
``recombiner_tpu/cli/compress.py`` on its reference schedule: encode one test
batch on the CUDA card (or, with ``--device cpu``, on the CPU) and write the
same ``Distortion_*.csv``, ``GroupIndex_*.csv`` and ``.rctb`` bitstream.

    python -m recombiner_tpu_torch.cli.compress --test_dir DIR --test_idx 0 \\
        --prior_path out/PRIOR_....npz --save_dir out/
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
from recombiner_tpu_torch.io.bitstream import write_bitstream
from recombiner_tpu_torch.io.checkpoint import load_prior_artifact

# The JAX CLI's other flags, accepted so that they fail with the queue that
# ports them rather than as unknown arguments.
NOT_PORTED = {
    "state_path": "io/encode_state resume",
    "save_every": "io/encode_state resume",
    "n_devices": "scale-out",
    "sync_every": "scale-out",
    "remat": "remat",
    "finetune_crn": "finetune common random numbers",
    "ft_lr": "the fused coding path",
    "ft_lr_schedule": "the fused coding path",
    "p1_stop": "optimize_adaptive",
    "ft_stop": "optimize_adaptive",
    "p1_lr": "the adaptive/quality presets",
    "p1_samples": "the adaptive/quality presets",
    "p1_monitor": "optimize_adaptive",
    "fused_steps": "encode_chunk",
    "precision": "precision modes (the port encodes in exact f32)",
}


def parse_args(argv=None):
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
    p.add_argument("--n_epochs", type=int, default=30000,
                   help="phase-1 posterior optimisation epochs (the reference's 30000)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--sample_size", type=int, default=5)
    p.add_argument("--finetune_epochs", type=int, default=None,
                   help="per-group finetune epochs (default: the reference schedule)")
    p.add_argument("--schedule", default="reference", choices=("reference", "adaptive", "quality"),
                   help="encode schedule; only 'reference' is ported")
    for name, queue in NOT_PORTED.items():
        p.add_argument(f"--{name}", nargs="*", default=None,
                       help=f"not ported yet (ROADMAP.md, port queue: {queue})")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    given = [n for n in NOT_PORTED if getattr(args, n) is not None]
    if args.schedule != "reference":
        given.insert(0, f"schedule {args.schedule}")
    if given:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(f"--{n}" for n in given)
            + " (ROADMAP.md, port queue 1: the rest of encode)")
    art = load_prior_artifact(args.prior_path)
    cfg = art.config
    if args.dataset is not None and args.dataset != cfg.name:
        raise SystemExit(f"--dataset {args.dataset} does not match the prior artifact "
                         f"({cfg.name})")
    dev = resolve_device(args.device)
    X, Y = load_test_set(args.test_dir, args.test_idx, cfg)
    codec, state = init_codec(art, X.shape[0], device=dev)
    print(f"Model initialized. Expected bitrate {cfg.bitrate_of_groups(codec.w.n_groups):.3f}",
          flush=True)
    result = compress(
        codec, state, X, Y, cfg, torch.Generator(device=dev).manual_seed(args.seed),
        n_optimize_epochs=args.n_epochs, lr=args.lr, sample_size=args.sample_size,
        finetune_overrides=(None if args.finetune_epochs is None
                            else {"w": args.finetune_epochs}),
        verbose=True,
    )

    os.makedirs(args.save_dir, exist_ok=True)
    np.savetxt(os.path.join(args.save_dir, f"Distortion_test_id_{args.test_idx}.csv"),
               np.atleast_2d(result.distortion), delimiter=",")
    if int(bool(args.save_bitstream)):
        np.savetxt(os.path.join(args.save_dir, f"GroupIndex_test_id_{args.test_idx}.csv"),
                   result.indices["w"], delimiter=",")
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
