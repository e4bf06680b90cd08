#!/usr/bin/env python3
"""The SIREN kernels of another checkout against this tree's, on one card.

    python3 scripts/torch_siren_ab.py --other DIR [--seed 0]

DIR is the other checkout's kernel sources (its recombiner_tpu_torch/ops/csrc,
for example a parent commit unpacked with ``git archive``). Both are built
by ops/_build.py, and each kernel is timed with CUDA events at the shapes
the main paths launch, in the order other, this, this, other:

  CIFAR  siren_fwd B = 500 (decode) and 2,500, siren_bwd B = 2,500 (encode)
  audio  siren_fwd B = 60 (decode) and 300, siren_bwd B = 300
  video  siren_fwd B = 64 (decode) and 320, siren_bwd B = 320

Each launch is held against the plain version (max abs diff printed).
Sources from before the kernels took an instance argument (no
SIREN_FIXED_INSTANCES in their siren_mma.cuh) are called without it. The
card's name and power limit are printed beside the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, cuda_ms, kernel_inputs, make_artifact  # noqa: E402
from recombiner_tpu_torch.config import AUDIO, CIFAR, VIDEO  # noqa: E402
from recombiner_tpu_torch.device import exact_f32  # noqa: E402
from recombiner_tpu_torch.ops import _build, fused_inr  # noqa: E402

# (config, siren_fwd row counts, siren_bwd row count)
SHAPES = ((CIFAR, (500, 2500), 2500), (AUDIO, (60, 300), 300), (VIDEO, (64, 320), 320))
ORDER = ("other", "this", "this", "other")


def bind(csrc: str):
    """(siren_fwd, siren_bwd, takes_instance) from the library built from
    ``csrc``."""
    with open(os.path.join(csrc, "siren_mma.cuh")) as f:
        takes_instance = "SIREN_FIXED_INSTANCES" in f.read()
    inst = [ctypes.c_int] if takes_instance else []
    fwd = fused_inr.kernel_lib("siren_fwd", csrc).siren_fwd
    bwd = fused_inr.kernel_lib("siren_bwd", csrc).siren_bwd
    fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int] + inst
                    + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float] + inst + [ctypes.c_void_p])
    return fwd, bwd, takes_instance


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other checkout's ops/csrc directory")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_siren_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    dirs = {"other": os.path.abspath(args.other), "this": _build.CSRC_DIR}
    _build.build_sources([_build.source(k, d) for d in dirs.values()
                          for k in ("siren_fwd", "siren_bwd")])
    libs = {tag: bind(d) for tag, d in dirs.items()}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for cfg, fwd_rows, bwd_rows in SHAPES:
        art = make_artifact(cfg, args.seed)
        P = cfg.n_pixels
        xb, tb = kernel_inputs(art, bwd_rows, P, gen)
        dy = torch.randn(bwd_rows, P, cfg.output_dim, generator=gen, device="cuda")
        cases.append((cfg, [kernel_inputs(art, B, P, gen) for B in fwd_rows], (xb, tb, dy)))
    times = {}
    with exact_f32():
        for tag in ORDER:
            fwd, bwd, takes_instance = libs[tag]
            for cfg, fwd_in, (xb, tb, dy) in cases:
                dims = list(cfg.net_dims)
                dims_c = ctypes.cast((ctypes.c_int * len(dims))(*dims), ctypes.c_void_p)
                inst = [fused_inr.instance(dims)] if takes_instance else []
                for x, t in fwd_in:
                    y = torch.empty(x.shape[0], x.shape[1], dims[-1], device="cuda")

                    def run_fwd():
                        rc = fwd(x.data_ptr(), t.data_ptr(), y.data_ptr(), x.shape[0],
                                 x.shape[1], len(dims) - 1, dims_c, t.shape[1], cfg.w0, 1,
                                 *inst, stream)
                        if rc:
                            raise RuntimeError(f"{tag} siren_fwd: cudaError {rc}")

                    ms = cuda_ms(run_fwd, 30)
                    err = (y - fused_inr.siren_forward_reference(x, t, dims, cfg.w0)).abs().max()
                    times.setdefault((cfg.name, "siren_fwd", x.shape[0]), {}).setdefault(
                        tag, []).append(ms)
                    print(f"{tag} {cfg.name} siren_fwd B={x.shape[0]}: {ms:.4f} ms (max abs "
                          f"diff {err.item():.2e})", flush=True)
                dx, dt = torch.empty_like(xb), torch.empty_like(tb)

                def run_bwd():
                    rc = bwd(xb.data_ptr(), tb.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                             dt.data_ptr(), xb.shape[0], xb.shape[1], len(dims) - 1, dims_c,
                             tb.shape[1], cfg.w0, *inst, stream)
                    if rc:
                        raise RuntimeError(f"{tag} siren_bwd: cudaError {rc}")

                ms = cuda_ms(run_bwd, 10)
                times.setdefault((cfg.name, "siren_bwd", xb.shape[0]), {}).setdefault(
                    tag, []).append(ms)
                print(f"{tag} {cfg.name} siren_bwd B={xb.shape[0]}: {ms:.4f} ms", flush=True)
    print(f"summary in ms, order {', '.join(ORDER)} [{card}]")
    for (name, kernel, B), t in times.items():
        print(f"  {name} {kernel} B={B}: other {t['other'][0]:.4f} / {t['other'][1]:.4f}, this "
              f"{t['this'][0]:.4f} / {t['this'][1]:.4f}; other / this "
              f"{min(t['other']) / min(t['this']):.3f} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
