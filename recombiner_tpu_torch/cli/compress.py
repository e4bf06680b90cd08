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

# The queue that ports each flag's values that the port does not run yet
# (ROADMAP.md, port queue 1 unless named).
_QUEUE = {
    "schedule": "the adaptive/quality presets",
    "state_path": "io/encode_state resume",
    "n_devices": "scale-out (queue 7)",
    "remat": "remat (queue 1 item 4)",
    "finetune_crn": "finetune common random numbers",
    "ft_lr": "the fused coding path",
    "ft_lr_schedule": "the fused coding path",
    "p1_stop": "optimize_adaptive",
    "ft_stop": "optimize_adaptive",
    "p1_lr": "the adaptive/quality presets",
    "p1_samples": "the adaptive/quality presets",
    "precision": "precision modes (the port encodes in exact f32)",
}


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
    p.add_argument("--state_path", default=None, help="not ported: encode-state snapshots")
    p.add_argument("--save_every", type=int, default=10,
                   help="snapshot cadence; only read with --state_path")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel device count; the port encodes on one device")
    p.add_argument("--sync_every", type=int, default=1,
                   help="flow-control batching in the JAX package; results identical, "
                        "so the port accepts and ignores it")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                   help="rematerialisation; the port stores activations (--no-remat or "
                        "the default)")
    p.add_argument("--finetune_crn", action=argparse.BooleanOptionalAction, default=None,
                   help="one noise stream for every finetune; default off on non-patch "
                        "configs, as the port runs")
    p.add_argument("--schedule", default="reference",
                   choices=("reference", "adaptive", "quality"),
                   help="encode schedule; only 'reference' is ported")
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
                   help="group steps per compiled program in the JAX package; "
                        "bit-identical there, so the port accepts and ignores it")
    p.add_argument("--precision", default=None,
                   choices=("scoped", "scoped_high", "default", "high", "highest"),
                   help="the port runs exact f32 throughout: the default or 'highest'")
    return p.parse_args(argv)


def unported(args) -> list:
    """``--flag value (queue)`` for each given value that would make the port
    run something other than what it runs; empty when it runs them all."""
    bad = {
        "schedule": args.schedule != "reference",
        "state_path": args.state_path is not None,
        "n_devices": args.n_devices is not None and args.n_devices > 1,
        "remat": bool(args.remat),
        "finetune_crn": bool(args.finetune_crn),
        "ft_lr": args.ft_lr is not None,
        "ft_lr_schedule": args.ft_lr_schedule is not None,
        "p1_stop": args.p1_stop is not None,
        "ft_stop": args.ft_stop is not None,
        "p1_lr": args.p1_lr is not None,
        "p1_samples": args.p1_samples not in (None, args.sample_size),
        "precision": args.precision not in (None, "highest"),
    }
    return [f"--{name} {getattr(args, name)} ({_QUEUE[name]})"
            for name, on in bad.items() if on]


def main(argv=None):
    args = parse_args(argv)
    given = unported(args)
    if given:
        raise NotImplementedError("not ported yet: " + ", ".join(given) + " (ROADMAP.md)")
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
        n_optimize_epochs=30000 if args.n_epochs is None else args.n_epochs, lr=args.lr,
        sample_size=args.sample_size,
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
