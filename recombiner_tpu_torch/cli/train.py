"""Prior-training CLI of the port, flag-compatible with
``recombiner_tpu/cli/train.py`` (itself the reference's
main_prior_training.py:11-21): EM on a seeded subset of the training set,
on the CUDA card (or, with ``--device cpu``, on the CPU), writing the same
``PRIOR_train_size_{R}_max_bitrate={b}.npz`` artifact at every chunk
boundary, the same ``LOSS_*.json`` history and the same log lines
(training PSNR, or RMSD for protein).

    python -m recombiner_tpu_torch.cli.train --train_dir DIR --dataset cifar \\
        --max_bitrate 2.0 --train_size 2000 --saving_dir out/ [--n_devices 2]

Data-parallel with ``--n_devices`` (``parallel/launch.py``: spawned ranks,
the env gate or torchrun): every rank loads the same seeded subset and
keeps its block of whole datapoints (replicated when they do not divide by
the world size); rank 0 writes the artifact and the history.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.data.load_data import load_training_set
from recombiner_tpu_torch.device import precision, resolve_device
from recombiner_tpu_torch.io.checkpoint import save_prior_artifact
from recombiner_tpu_torch.metrics import batch_psnr
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.parallel.mesh import make_mesh, partition, shard_rows
from recombiner_tpu_torch.priors import trainer
from recombiner_tpu_torch.priors.artifact import build_prior_artifact


def parse_args(argv=None):
    """The JAX CLI's flags, each with its type and default, with
    ``--device`` meaning the torch device here."""
    p = argparse.ArgumentParser(description="Train a RECOMBINER prior (PyTorch port)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--train_size", type=int, default=10_000_000_000,
                   help="number of training rows (patches in patch mode); capped at the "
                        "dataset size")
    p.add_argument("--dataset", required=True,
                   help="cifar|kodak|video|audio|protein (or a test config name)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' to run without one)")
    p.add_argument("--max_bitrate", type=float, required=True)
    p.add_argument("--saving_dir", default="./")
    p.add_argument("--n_em_iters", type=int, default=550)
    p.add_argument("--first_epochs", type=int, default=200)
    p.add_argument("--later_epochs", type=int, default=100)
    p.add_argument("--em_schedule", default="reference", choices=("reference", "adaptive"),
                   help="'adaptive' stops EM once the windowed mse plateaus and the "
                        "realized rate has settled (--n_em_iters becomes a ceiling)")
    p.add_argument("--em_stop", type=float, nargs=3, default=None,
                   metavar=("WINDOW", "REL_TOL", "MIN_ITERS"),
                   help="explicit adaptive EM stop spec (overrides --em_schedule's preset)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks (one card each, or CPU processes with "
                        "--device cpu); default every visible card")
    p.add_argument("--rate_control", action=argparse.BooleanOptionalAction, default=True,
                   help="steer the EM KL window so that the realized post-grouping bitrate "
                        "lands within about 1.5%% of --max_bitrate")
    return p.parse_args(argv)


def log_line(cfg, Y: np.ndarray, y_hat: np.ndarray, em_iter: int, rec: dict,
             seconds: float) -> str:
    """The JAX CLI's log line: training PSNR (unrounded), or for protein the
    training RMSD in Angstrom."""
    tail = f"KL {rec['kl_bits']:.2f} bits; beta {rec['kl_beta']:.3g}; {seconds:.0f}s"
    if cfg.name == "protein":
        mses = ((y_hat - Y) ** 2).reshape(Y.shape[0], -1).mean(1) * 3
        return f"[{em_iter}] Training RMSD {np.mean(mses ** 0.5) * 25:.4f}; {tail}"
    return (f"[{em_iter}] Training PSNR {batch_psnr(Y, y_hat, round8=False).mean():.4f}; "
            f"{tail}")


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if launch.spawn_if_needed("recombiner_tpu_torch.cli.train", argv, args.n_devices, dev):
        return None  # the spawned ranks ran it
    mesh = make_mesh(args.n_devices)
    dev = launch.rank_device(dev)
    primary = launch.is_primary()
    cfg = get_config(args.dataset)

    n_datapoints = args.train_size // cfg.patches_per_datapoint if cfg.patch else args.train_size
    X_np, Y_np = load_training_set(args.train_dir, cfg, args.seed, n_datapoints)
    train_size = X_np.shape[0]
    if primary:
        print(f"Prior is trained on {train_size} patches/datapoints.", flush=True)
    part = partition(mesh, train_size // cfg.patches_per_datapoint)
    if mesh.world > 1 and primary:
        print(f"Training on {mesh.world} ranks "
              f"({'rows sharded' if part.sharded else 'replicated'})", flush=True)
    X = shard_rows(torch.from_numpy(X_np), part).to(dev)
    Y = shard_rows(torch.from_numpy(Y_np), part).to(dev)

    os.makedirs(args.saving_dir, exist_ok=True)
    stem = f"train_size_{train_size}_max_bitrate={args.max_bitrate:.3f}"
    ckpt_path = os.path.join(args.saving_dir, f"PRIOR_{stem}.npz")
    history_path = os.path.join(args.saving_dir, f"LOSS_{stem}.json")
    t0 = time.perf_counter()

    def checkpoint_fn(em_iter, state, priors, kl_beta, controller):
        # every rank builds (the state is gathered); rank 0 writes
        art = build_prior_artifact(state, priors, kl_beta, cfg, codebook_seed=args.seed)
        if primary:
            save_prior_artifact(ckpt_path, art)

    def log_fn(em_iter, rec, state, priors):
        with torch.no_grad(), precision():
            y_hat = trainer.forward(state, X, cfg,
                                    generator=torch.Generator(device=dev).manual_seed(em_iter))
        y_hat = launch.fetch_global(y_hat[:, 0], part)
        if primary:
            print(log_line(cfg, Y_np, y_hat, em_iter, rec, time.perf_counter() - t0),
                  flush=True)

    res = trainer.em_train(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, X, Y,
        max_bitrate=args.max_bitrate, n_em_iters=args.n_em_iters,
        first_epochs=args.first_epochs, later_epochs=args.later_epochs, lr=args.lr,
        checkpoint_fn=checkpoint_fn, log_fn=log_fn, rate_control=args.rate_control,
        em_stop=trainer.resolve_em_schedule(
            args.em_schedule, tuple(args.em_stop) if args.em_stop else None, args.n_em_iters),
        part=part,
    )
    if not primary:
        return res
    stp = (res.controller or {}).get("em_stop")
    if stp:
        print(f"em_stop: plateau+rate-settled at EM {stp['stopped_at']}/{stp['schedule']}",
              flush=True)
    with open(history_path, "w") as f:
        json.dump(res.elbo_history, f)
    print(f"Saved prior artifact to {ckpt_path}", flush=True)
    return res


if __name__ == "__main__":
    main()
