"""Rate-distortion sweep of the port, flag-compatible with
``recombiner_tpu/cli/rd_sweep.py``: train a prior at each bitrate target
and encode a test set with it, on the CUDA card (or, with ``--device cpu``,
on the CPU), printing one JSON point per target and writing the curve to
``--out``.

    python -m recombiner_tpu_torch.cli.rd_sweep --dataset cifar --train_dir ... \\
        --test_dir ... --bitrates 0.5 1.0 2.0 --out rd.json

``--synthetic N`` trains on N synthetic datapoints (``data/synthetic.py``)
and encodes ``--n_test`` more; ``--train_state_dir`` snapshots EM at every
chunk boundary and resumes from it, ``--state_dir`` the encode;
``--save_prior_dir``/``--load_prior_dir`` keep or reuse the priors and
``--skip_encode`` stops after training. ``--n_devices`` runs both
data-parallel (``parallel/launch.py``): the training rows and the test rows
are each sharded by whole datapoints (or replicated), and rank 0 writes.
"""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.coding.decoder import init_codec
from recombiner_tpu_torch.coding.progressive import compress
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.data.load_data import load_test_set, load_training_set
from recombiner_tpu_torch.data.synthetic import synthetic_dataset
from recombiner_tpu_torch.device import resolve_device
from recombiner_tpu_torch.io import train_state
from recombiner_tpu_torch.io.atomic import load_snapshot_or_none
from recombiner_tpu_torch.io.checkpoint import (
    load_prior_artifact,
    prior_fingerprint,
    save_prior_artifact,
)
from recombiner_tpu_torch.parallel import launch
from recombiner_tpu_torch.parallel.mesh import Partition, make_mesh, partition, shard_rows
from recombiner_tpu_torch.priors import trainer
from recombiner_tpu_torch.priors.artifact import build_prior_artifact
from recombiner_tpu_torch.utils.memory import resolve_remat
from recombiner_tpu_torch.utils.platform import PRECISION_CHOICES, apply_precision_mode


def parse_args(argv=None):
    """The JAX CLI's flags, each with its type, nargs, choices and default,
    plus ``--device``: the torch device."""
    p = argparse.ArgumentParser(description="RD sweep (PyTorch port)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' to run without one)")
    p.add_argument("--train_dir", default=None)
    p.add_argument("--test_dir", default=None)
    p.add_argument("--test_idx", type=int, default=0)
    p.add_argument("--synthetic", type=int, default=0, help="use N synthetic datapoints")
    p.add_argument("--synthetic_kind", default="smooth", choices=("smooth", "speech", "backbone"),
                   help="synthetic signal family (speech: audio; backbone: protein)")
    p.add_argument("--test_wav", default=None,
                   help="encode this WAV file as the test datum (audio geometries)")
    p.add_argument("--bitrates", type=float, nargs="+", required=True)
    p.add_argument("--train_size", type=int, default=10_000_000_000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n_em_iters", type=int, default=550)
    p.add_argument("--first_epochs", type=int, default=200)
    p.add_argument("--later_epochs", type=int, default=100)
    p.add_argument("--em_schedule", default="reference", choices=("reference", "adaptive"))
    p.add_argument("--em_stop", type=float, nargs=3, default=None,
                   metavar=("WINDOW", "REL_TOL", "MIN_ITERS"))
    p.add_argument("--n_encode_epochs", type=int, default=None,
                   help="phase-1 epochs (default: the reference's 30000)")
    p.add_argument("--finetune_epochs", type=int, default=None)
    p.add_argument("--sample_size", type=int, default=5)
    p.add_argument("--schedule", default="reference",
                   choices=("reference", "adaptive", "quality"),
                   help="encode-schedule preset, as cli/compress's")
    p.add_argument("--ft_lr", type=float, default=None)
    p.add_argument("--ft_lr_schedule", default=None, choices=(None, "cosine"))
    p.add_argument("--p1_stop", type=float, nargs=3, default=None,
                   metavar=("WINDOW", "REL_TOL", "MIN_EPOCHS"))
    p.add_argument("--ft_stop", type=float, nargs=3, default=None,
                   metavar=("WINDOW", "REL_TOL", "MIN_EPOCHS"))
    p.add_argument("--p1_lr", type=float, nargs=2, default=None, metavar=("PEAK", "FLOOR"))
    p.add_argument("--p1_samples", type=int, default=None)
    p.add_argument("--p1_monitor", default="mse", choices=("mse", "loss"))
    p.add_argument("--fused_steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--out", default="rd_curve.json")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks (one card each, or CPU processes with "
                        "--device cpu); default every visible card")
    p.add_argument("--n_test", type=int, default=None,
                   help="with --synthetic: synthetic test datapoints (default synthetic // 2)")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--export_dir", default=None,
                   help="write decoded media (PNG/WAV/PDB/NPZ) per RD point here")
    p.add_argument("--save_prior_dir", default=None)
    p.add_argument("--load_prior_dir", default=None)
    p.add_argument("--state_dir", default=None,
                   help="snapshot the encode here and resume from it")
    p.add_argument("--skip_encode", action="store_true")
    p.add_argument("--em_chunk", type=int, default=None,
                   help="EM iterations per chunk (the trainer's checkpoint_every); default "
                        "1 for audio, 10 otherwise, as in the JAX package")
    p.add_argument("--rate_control", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--train_state_dir", default=None,
                   help="snapshot the EM state here at every chunk and resume from it")
    p.add_argument("--probe_every", type=int, default=10,
                   help="minimum EM iterations between realized-rate probes")
    p.add_argument("--finetune_crn", action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--precision", default=None, choices=PRECISION_CHOICES,
                   help=compress_cli.PRECISION_HELP)
    return p.parse_args(argv)


def resolve_schedule_args(args):
    """The encode-schedule knobs through cli/compress's preset logic: one
    preset definition for every CLI."""
    return compress_cli.resolve_schedule(SimpleNamespace(
        schedule=args.schedule, n_epochs=args.n_encode_epochs, p1_lr=args.p1_lr,
        p1_samples=args.p1_samples, p1_stop=args.p1_stop, ft_stop=args.ft_stop,
        fused_steps=args.fused_steps, ft_lr=args.ft_lr, ft_lr_schedule=args.ft_lr_schedule))


def train_prior(args, cfg, Xtr, Ytr, max_bitrate: float, dev, part: Partition):
    """EM for one target on this rank's rows of ``part`` (Xtr, Ytr), resumed
    from and snapshotted to ``--train_state_dir`` when given; returns its
    artifact (built on every rank)."""
    state0, priors0, kl_beta0, done, controller0 = None, None, 1e-8, 0, None
    ts_path = None
    if args.train_state_dir is not None:
        ts_path = os.path.join(args.train_state_dir, f"train_state_{cfg.name}_{max_bitrate:g}")
        loaded, reason = load_snapshot_or_none(
            ts_path, lambda p: train_state.load_train_state(p, cfg, dev))
        if reason:
            print(f"WARNING: {reason}; training from scratch", flush=True)
        if loaded is not None:
            state0, priors0, kl_beta0, done, extra = loaded
            controller0 = extra.get("controller")
            state0 = shard_rows(state0, part)
            print(f"Resumed EM state from {ts_path} ({done} iters done, controller "
                  f"{controller0})", flush=True)

    def log(em_iter, rec, state, priors):
        if not launch.is_primary():
            return
        rate = (f" rate {rec['realized_bitrate']:.3f} aim {rec['budget_aim']:.3f}"
                if "realized_bitrate" in rec else "")
        print(f"  EM {done + em_iter + 1}/{args.n_em_iters}: mse {rec['mse']:.5f} "
              f"kl {rec['kl_bits']:.1f} bits beta {rec['kl_beta']:.2e}{rate}", flush=True)

    def ckpt(em_iter, state, priors, kl_beta, controller):
        train_state.save_train_state(ts_path, state, priors, kl_beta, done + em_iter + 1,
                                     controller=controller, schedule_total=args.n_em_iters)

    res = trainer.em_train(
        torch.Generator(device=dev).manual_seed(args.seed + done), cfg, Xtr, Ytr,
        em_stop=trainer.resolve_em_schedule(
            args.em_schedule, tuple(args.em_stop) if args.em_stop else None, args.n_em_iters),
        max_bitrate=max_bitrate, n_em_iters=args.n_em_iters - done,
        first_epochs=args.first_epochs if done == 0 else args.later_epochs,
        later_epochs=args.later_epochs, lr=args.lr, log_fn=log,
        checkpoint_fn=ckpt if ts_path is not None else None,
        state=state0, priors=priors0, kl_beta=kl_beta0, rate_control=args.rate_control,
        checkpoint_every=args.em_chunk, probe_every=args.probe_every,
        controller=controller0, em_iter_offset=done, schedule_total=args.n_em_iters, part=part,
    )
    stp = (res.controller or {}).get("em_stop")
    if stp:
        print(f"  em_stop: plateau+rate-settled at EM {stp['stopped_at']}/{stp['schedule']} "
              f"(last realized {stp['last_realized']})", flush=True)
    sel = (res.controller or {}).get("selected")
    if sel:
        print(f"  rate_select: EM {sel['em_iter']} state selected (realized "
              f"{sel['realized']:.3f} vs final {sel['final_realized']:.3f})", flush=True)
    return build_prior_artifact(res.state, res.priors, res.kl_beta, cfg, codebook_seed=args.seed)


def encode_point(args, art, cfg, Xte, Yte, max_bitrate: float, remat: bool, dev,
                 coding_precision, part: Partition) -> dict:
    """Encode the test set with ``art`` (resumable through ``--state_dir``),
    its finetunes at ``coding_precision``, and return the RD point. Xte and
    Yte are this rank's rows of ``part``; the state is laid out alike."""
    n_rows = part.global_rows(Xte.shape[0])
    codec, state = init_codec(art, n_rows=n_rows, device=dev)
    state_path, resume = None, {}
    if args.state_dir is not None:
        os.makedirs(args.state_dir, exist_ok=True)
        state_path = os.path.join(args.state_dir, f"encode_state_{cfg.name}_{max_bitrate:g}")
        resume, restored = compress_cli.resume_from(state_path, art, dev)
        state = state if restored is None else restored
    state = shard_rows(state, part)
    (n_epochs, p1_lr, p1_samples, p1_stop, ft_stop, fused_steps, ft_lr,
     ft_lr_schedule) = resolve_schedule_args(args)
    enc = compress(
        codec, state, Xte, Yte, cfg, torch.Generator(device=dev).manual_seed(args.seed + 1),
        n_optimize_epochs=n_epochs, lr=args.lr, sample_size=args.sample_size,
        phase1_stop=tuple(p1_stop) if p1_stop is not None else None,
        finetune_stop=tuple(ft_stop) if ft_stop is not None else None,
        phase1_monitor=args.p1_monitor,
        phase1_lr=tuple(p1_lr) if p1_lr else None,
        phase1_sample_size=p1_samples, fused_steps=fused_steps, finetune_lr=ft_lr,
        finetune_lr_schedule=ft_lr_schedule,
        finetune_overrides=(None if args.finetune_epochs is None
                            else {k: args.finetune_epochs for k in codec.level_names}),
        verbose=True, remat=remat, state_path=state_path,
        state_extra={"prior_fingerprint": prior_fingerprint(art)},
        finetune_crn=args.finetune_crn, coding_precision=coding_precision, **resume,
    )
    point = {
        "target_bitrate": max_bitrate,
        "actual_bitrate": enc.bitrate,
        "distortion_mean": float(np.mean(enc.distortion)),
        "n_rows": int(n_rows),
        "n_groups": {n: int(codec.meta(n).n_groups) for n in codec.level_names},
        "timings": enc.timings,
    }
    if args.export_dir is not None and launch.is_primary():
        from recombiner_tpu_torch.data.export import export_reconstructions

        point["exported"] = export_reconstructions(
            enc.reconstruction, cfg, args.export_dir,
            stem=f"decoded_{cfg.name}_{max_bitrate:g}")
    return point


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if launch.spawn_if_needed("recombiner_tpu_torch.cli.rd_sweep", argv, args.n_devices, dev):
        return None  # the spawned ranks ran it
    mesh = make_mesh(args.n_devices)
    dev = launch.rank_device(dev)
    primary = launch.is_primary()
    # before training: --precision highest makes the training exact too
    coding_precision = apply_precision_mode(args.precision)
    cfg = get_config(args.dataset)
    if args.em_chunk is None:
        args.em_chunk = 1 if cfg.name == "audio" else 10

    if args.synthetic:
        Xtr, Ytr = synthetic_dataset(cfg, args.synthetic, seed=args.seed,
                                     kind=args.synthetic_kind)
        n_te = args.n_test if args.n_test is not None else max(args.synthetic // 2, 1)
        Xte, Yte = synthetic_dataset(cfg, n_te, seed=args.seed + 1, kind=args.synthetic_kind)
    else:
        n = args.train_size // cfg.patches_per_datapoint if cfg.patch else args.train_size
        Xtr, Ytr = load_training_set(args.train_dir, cfg, args.seed, n)
        Xte, Yte = load_test_set(args.test_dir, args.test_idx, cfg)
    if args.test_wav is not None:
        from recombiner_tpu_torch.data.audio import load_wav_clip

        Xte, Yte = load_wav_clip(args.test_wav, cfg)
    # training rows and test rows are sharded separately
    ppd = cfg.patches_per_datapoint
    part_tr = partition(mesh, Xtr.shape[0] // ppd)
    part_te = partition(mesh, Xte.shape[0] // ppd, cfg)
    Xtr, Ytr = (shard_rows(torch.from_numpy(np.ascontiguousarray(a)), part_tr).to(dev)
                for a in (Xtr, Ytr))
    Xte, Yte = shard_rows(Xte, part_te), shard_rows(Yte, part_te)
    if mesh.world > 1 and primary:
        layout = "rows sharded" if part_te.sharded else "replicated"
        print(f"Encoding on {mesh.world} ranks ({layout}: {part_te.reason})", flush=True)
    remat = resolve_remat(args.remat, cfg, Xte.shape[0], args.sample_size)  # this rank's rows

    points = []
    for max_bitrate in args.bitrates:
        print(f"=== bitrate target {max_bitrate} ===", flush=True)
        prior_name = f"PRIOR_rd_{cfg.name}_bitrate={max_bitrate:g}.npz"
        if args.load_prior_dir is not None:
            art = load_prior_artifact(os.path.join(args.load_prior_dir, prior_name))
        else:
            art = train_prior(args, cfg, Xtr, Ytr, max_bitrate, dev, part_tr)
            if args.save_prior_dir is not None and primary:
                os.makedirs(args.save_prior_dir, exist_ok=True)
                save_prior_artifact(os.path.join(args.save_prior_dir, prior_name), art)
        if args.skip_encode:
            if not primary:
                continue
            if args.load_prior_dir is not None:
                print(f"(--skip_encode) prior loaded for bitrate {max_bitrate}; nothing to do",
                      flush=True)
            elif args.save_prior_dir is not None:
                print(f"(--skip_encode) prior saved for bitrate {max_bitrate}", flush=True)
            else:
                print(f"(--skip_encode) WARNING: trained prior for bitrate {max_bitrate} "
                      "DISCARDED — pass --save_prior_dir to keep it", flush=True)
            continue
        point = encode_point(args, art, cfg, Xte, Yte, max_bitrate, remat, dev,
                             coding_precision, part_te)
        points.append(point)
        if primary:
            print(json.dumps(point), flush=True)

    if not primary:
        return points
    with open(args.out, "w") as f:
        json.dump({"dataset": args.dataset, "points": points}, f, indent=2)
    print(f"RD curve -> {args.out}", flush=True)
    return points


if __name__ == "__main__":
    main()
