"""Data-parallel scale-out of the port over the cards of one machine.

    python3 scripts/torch_scaleout.py [--worlds 1 2 4] [--parts cifar kodak] [--seed 0]

For each world size W (W cards, one rank a card on NCCL, started by
``parallel/launch.py::spawn``), part ``cifar``: each rank runs
``chip_smoke.scaleout_rank`` once under the ambient TF32 and once under
``--precision highest``:
``em_train`` at CIFAR R = 2,000 (2 EM iterations of 3 epochs, the rows
split over the ranks) and ``progressive.compress`` at R = 500, S = 5 (cut
as chip_smoke.py's encode slice), then ``train_epoch_s`` and ``epoch_s``
(10 warm epochs each on the host clock) with the time in collectives (the
rank-ordered gradient sums) of each. Part ``kodak``: each rank runs
``chip_smoke.patch_rank``, one Kodak image's 96 patch rows split over the
ranks (48 a rank at W = 2, 24 at W = 4) with the conv canvas's halo
exchanged: the halo-split ``lpe_to_pe`` and its gradient, the encode at the
smoke's Kodak cut in both modes, and ``epoch_s``, then the epochs again
with the time in each kind of collective (halo, sums, gathers).

Against the first world size given: every rank's A and conv weights
bitwise equal, the gathered training state within the tests'
trained-state bound (exact), the encode's indices and reconstruction
(bitwise, or their agreement); for Kodak every rank's encode equal, its
indices' agreement and PSNR gap, and the halo-split PEs and gradient
within ``chip_smoke.HALO_OF_MAX`` of the largest entry. The rows are fixed (strong scaling): W
ranks hold R / W rows each. The card's name and power limit are printed
beside the numbers; the last line is one JSON object of them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from recombiner_tpu_torch.ops import _build  # noqa: E402
from recombiner_tpu_torch.parallel import launch  # noqa: E402
from recombiner_tpu_torch.priors import trainer  # noqa: E402

MODES = {"ambient": None, "highest": "highest"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--parts", nargs="+", default=["cifar", "kodak"], choices=("cifar", "kodak"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_scaleout: no CUDA device", file=sys.stderr)
        return 1
    if max(args.worlds) > torch.cuda.device_count():
        print(f"torch_scaleout: {torch.cuda.device_count()} cards for worlds {args.worlds}",
              file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"cards: {torch.cuda.device_count()} x {card}")
    _build.build_all(["siren_fwd", "siren_bwd"])
    tmp = tempfile.mkdtemp(prefix="scaleout_")
    try:
        summary = {part: {"cifar": cifar, "kodak": kodak}[part](args, tmp, card)
                   for part in args.parts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": card, "scale_out": summary}))
    return 0


def kodak(args, tmp: str, card: str) -> dict:
    """``chip_smoke.patch_rank`` at each world size, against the first."""
    inp = os.path.join(tmp, "kodak_in.pt")
    torch.save({"seed": args.seed}, inp)
    runs = {}
    for w in args.worlds:
        t0 = time.perf_counter()
        out_dir = os.path.join(tmp, f"kodak_w{w}")
        os.makedirs(out_dir)
        launch.spawn(cs.patch_rank, w, (inp, out_dir, MODES), backend="nccl", cuda="own",
                     timeout_s=1200)
        runs[w] = [torch.load(os.path.join(out_dir, f"patch_{r}.pt"), weights_only=False)
                   for r in range(w)]
        print(f"Kodak, world size {w} ({runs[w][0]['reason']}): spawn and run "
              f"{time.perf_counter() - t0:.3f} s")
    base = runs[args.worlds[0]][0]
    summary = {}
    for w, ranks in runs.items():
        halo = {what: ((ranks[0][what] - base[what]).abs().max()
                       / base[what].abs().max()).item() for what in ("pe", "grad")}
        for mode in MODES:
            r0 = ranks[0][mode]
            same = all(all(np.array_equal(r[mode]["indices"][n], r0["indices"][n])
                           for n in r0["indices"])
                       and np.array_equal(r[mode]["reconstruction"], r0["reconstruction"])
                       for r in ranks)
            agree = cs.index_agreement(r0["indices"], base[mode]["indices"])
            gap = r0["psnr"] - base[mode]["psnr"]
            per_rank = [{"epoch_s": r[mode]["epoch_s"], "epoch_s_timed": r[mode]["epoch_s_timed"],
                         "device_ms": r[mode]["device_ms"], "nccl_ms": r[mode]["nccl_ms"],
                         "idle": r[mode]["idle"],
                         "epoch_collective_ms": r[mode]["epoch_collective_ms"],
                         "encode_s": r[mode]["wall_s"], "launches": r[mode]["launches"],
                         "peak_mib": r["peak_mib"]} for r in ranks]
            summary[f"{w}/{mode}"] = {"ranks_equal": same, "index_agreement_w1": agree,
                                      "psnr_gap_db": gap, "halo_of_max": halo, "ranks": per_rank}
            print(f"Kodak world {w}, {mode}: every rank's encode equal {same}; vs world "
                  f"{args.worlds[0]}: indices equal {agree:.5f}, PSNR {r0['psnr']:.4f} dB "
                  f"({gap:+.5f}); halo-split PEs / gradient within {halo['pe']:.3e} / "
                  f"{halo['grad']:.3e} of the largest entry [{card}]")
            for i, p in enumerate(per_rank):
                print(f"  rank {i}: epoch_s {p['epoch_s']:.6f} (device {p['device_ms']:.3f} ms, "
                      f"NCCL's kernels {p['nccl_ms']:.3f} ms, idle share {p['idle']:.4f}); with "
                      "each collective timed "
                      f"{p['epoch_s_timed']:.6f}, of which collectives an epoch: "
                      + ", ".join(f"{k} {v:.3f} ms" for k, v in p["epoch_collective_ms"].items())
                      + f"; compress (collectives timed) {p['encode_s']:.3f} s, launches "
                      f"{p['launches']}, peak {p['peak_mib']:.1f} MiB")
            if not same or max(halo.values()) > cs.HALO_OF_MAX:
                raise AssertionError(f"Kodak world {w}, {mode}: the ranks differ, or the "
                                     "halo-split canvas is off the whole one")
    return summary


def cifar(args, tmp: str, card: str) -> dict:
    """``chip_smoke.scaleout_rank`` at each world size, against the first."""
    cfg = cs.CIFAR
    inp = os.path.join(tmp, "in.pt")
    torch.save({"seed": args.seed,
                "Y_train": cs.smooth_images(cs.TRAIN_ROWS, args.seed + 7).reshape(
                    cs.TRAIN_ROWS, cfg.n_pixels, cfg.output_dim),
                "Y_encode": cs.smooth_images(cs.N_ROWS, args.seed).reshape(
                    cs.N_ROWS, cfg.n_pixels, cfg.output_dim)}, inp)
    runs = {}
    for w in args.worlds:
        t0 = time.perf_counter()
        out_dir = os.path.join(tmp, f"w{w}")
        os.makedirs(out_dir)
        launch.spawn(cs.scaleout_rank, w, (inp, out_dir, MODES, 1), backend="nccl", cuda="own",
                     timeout_s=1200)
        runs[w] = [torch.load(os.path.join(out_dir, f"rank_{r}.pt"), weights_only=False)
                   for r in range(w)]
        print(f"world size {w}: spawn and run {time.perf_counter() - t0:.3f} s")
    base = runs[args.worlds[0]][0]
    start = trainer.init_prior_state(cfg, cs.TRAIN_ROWS,
                                     torch.Generator(device="cuda").manual_seed(args.seed))
    want = start.with_leaves([t.cuda() for t in base["highest"]["state"]])
    summary = {}
    for w, ranks in runs.items():
        for mode in MODES:
            r0 = ranks[0][mode]
            shared_equal = all(torch.equal(a, b) for r in ranks[1:]
                               for a, b in zip(r[mode]["shared"], r0["shared"]))
            enc_bitwise = all(np.array_equal(r[mode]["indices"], base[mode]["indices"])
                              and np.array_equal(r[mode]["reconstruction"],
                                                 base[mode]["reconstruction"]) for r in ranks)
            agree = float(np.mean(r0["indices"] == base[mode]["indices"]))
            worst = None
            if mode == "highest":
                got = start.with_leaves([t.cuda() for t in r0["state"]])
                worst = cs.states_close(got, want, start, cs.SCALE_EPOCHS)
            per_rank = [{"train_epoch_s": r[mode]["train_epoch_s"],
                         "train_collective_s": r[mode]["train_collective_s"],
                         "epoch_s": r[mode]["epoch_s"],
                         "encode_s": r[mode]["encode"][0]["wall_s"],
                         "launches": r[mode]["train"][0]["launches"]} for r in ranks]
            summary[f"{w}/{mode}"] = {"shared_equal": shared_equal,
                                      "encode_bitwise_w1": enc_bitwise,
                                      "index_agreement_w1": agree, "psnr": r0["psnr"],
                                      "train_of_bound_w1": worst, "ranks": per_rank}
            print(f"world {w}, {mode}: A and conv weights equal on every rank {shared_equal}; "
                  f"training vs world {args.worlds[0]} "
                  f"{'within %.3f of its bound' % worst if worst is not None else '(exact only)'}"
                  f"; encode vs world {args.worlds[0]}: bitwise {enc_bitwise}, indices equal "
                  f"{agree:.5f}, PSNR {r0['psnr']:.4f} dB [{card}]")
            for i, p in enumerate(per_rank):
                print(f"  rank {i}: train_epoch_s {p['train_epoch_s']:.6f} (collectives "
                      f"{1e3 * p['train_collective_s']:.3f} ms), epoch_s {p['epoch_s']:.6f}, "
                      f"compress {p['encode_s']:.3f} s, training launches {p['launches']}")
    return summary


if __name__ == "__main__":
    sys.exit(main())
