#!/usr/bin/env python3
"""Where the time of the port's SIREN kernels goes, on one CUDA card.

    python3 scripts/torch_siren_variants.py [--seed 0]

Builds the committed kernel sources (recombiner_tpu_torch/ops/csrc) once as
they are and once per variant below, each variant a copy with one textual
edit built by ops/_build.py and bound by ops/fused_inr.py, and times, with
CUDA events, siren_fwd and siren_bwd at two shapes of the main path, each
held against its plain version:

  CIFAR  siren_fwd B = 500 (decode) and 2,500, siren_bwd B = 2,500 (encode),
         P = 1,024, widths 32-32-32-32-3;
  video  siren_fwd B = 64 (decode), siren_bwd B = 320 (encode), P = 6,144,
         widths 34-32-32-32-3.

A variant that cuts a phase out computes wrong numbers on purpose: its time
says what the phase costs, its error is only printed. Every edit must
apply, or the script stops.

  no_dw       siren_bwd without its dW/db phase
  no_sin      the branch-free sincos replaced by sin x = x, cos x = 1
  one_pass    one TF32 product (hi x hi) in place of three
  cvt_rna     the TF32 rounding by cvt.rna.tf32.f32 instead of integer ops
  generic     every width set served by the run-time-width instance (up to
              64 wide, 8 layers), none by its fixed-width one

The card's name and power limit are printed beside the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, cuda_ms, kernel_inputs, make_artifact  # noqa: E402
from recombiner_tpu_torch.config import CIFAR, VIDEO  # noqa: E402
from recombiner_tpu_torch.device import exact_f32  # noqa: E402
from recombiner_tpu_torch.ops import _build, fused_inr  # noqa: E402

VARIANTS = {
    "base": [],
    "no_dw": [("siren_bwd.cu", "for (int nt = warp; nt < nts; nt += warps) {",
               "for (int nt = warp; nt < 0; nt += warps) {")],
    "no_sin": [("siren_mma.cuh", "  const float j = rintf(x * 0.636619772f);",
                "  s = x;\n  c = 1.f;\n  return;\n  const float j = rintf(x * 0.636619772f);")],
    "one_pass": [("siren_mma.cuh", "  mma_tf32(small, alo, bhi);\n  mma_tf32(small, ahi, blo);\n",
                  "")],
    "cvt_rna": [("siren_mma.cuh", "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
                 '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));\n'
                 "  return r;")],
    "generic": [("siren_mma.cuh", "if (widths_are(dims, L, IN0, HID, OUT)) return id;",
                 "if (widths_are(dims, L, IN0, HID, OUT)) return 0;")],
}
# (config, siren_fwd row counts, siren_bwd row count)
SHAPES = ((CIFAR, (500, 2500), 2500), (VIDEO, (64,), 320))


def write_variants(root: str):
    """{variant: source directory}: a copy of the committed sources per
    variant with its edits applied, all built together through _build."""
    dirs = {}
    for name, edits in VARIANTS.items():
        d = dirs[name] = os.path.join(root, name)
        os.makedirs(d)
        for f in os.listdir(_build.CSRC_DIR):
            with open(os.path.join(_build.CSRC_DIR, f)) as src:
                text = src.read()
            for target, old, new in edits:
                if target == f:
                    if text.count(old) != 1:
                        raise SystemExit(f"variant {name}: edit does not apply to {f}")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as dst:
                dst.write(text)
    _build.build_sources([_build.source(k, d) for d in dirs.values()
                          for k in ("siren_fwd", "siren_bwd")])
    return dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_siren_variants: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as root, exact_f32():
        dirs = write_variants(root)
        cases = []
        for cfg, fwd_rows, bwd_rows in SHAPES:
            art = make_artifact(cfg, args.seed)
            dims, P = list(cfg.net_dims), cfg.n_pixels
            fwd_in = [kernel_inputs(art, B, P, gen) for B in fwd_rows]
            xb, thb = kernel_inputs(art, bwd_rows, P, gen)
            dyb = torch.randn(bwd_rows, P, cfg.output_dim, generator=gen, device="cuda")
            cases.append((cfg, dims, fwd_in,
                          [fused_inr.siren_forward_reference(x, t, dims, cfg.w0)
                           for x, t in fwd_in],
                          (xb, thb, dyb),
                          fused_inr.siren_backward_reference(xb, thb, dyb, dims, cfg.w0)))
        print(f"card: {card}; times in ms (CUDA events); errors: forward max abs diff, "
              "backward max abs diff over the largest entry")
        for rep in range(2):
            for name, d in dirs.items():
                fwd = fused_inr.kernel_lib("siren_fwd", d).siren_fwd
                bwd = fused_inr.kernel_lib("siren_bwd", d).siren_bwd
                for cfg, dims, fwd_in, fwd_ref, (xb, thb, dyb), (rdx, rdt) in cases:
                    dims_c = ctypes.cast((ctypes.c_int * len(dims))(*dims), ctypes.c_void_p)
                    inst = {k: fused_inr.launch_plan(k, dims, csrc_dir=d)["instance"]
                            for k in ("siren_fwd", "siren_bwd")}

                    def run_fwd(xx, tt, yy):
                        rc = fwd(xx.data_ptr(), tt.data_ptr(), yy.data_ptr(), xx.shape[0],
                                 xx.shape[1], len(dims) - 1, dims_c, tt.shape[1], cfg.w0, 1,
                                 inst["siren_fwd"], stream)
                        if rc:
                            raise RuntimeError(f"{name} siren_fwd: cudaError {rc}")

                    def run_bwd():
                        rc = bwd(xb.data_ptr(), thb.data_ptr(), dyb.data_ptr(), dx.data_ptr(),
                                 dt.data_ptr(), xb.shape[0], xb.shape[1], len(dims) - 1,
                                 dims_c, thb.shape[1], cfg.w0, inst["siren_bwd"], stream)
                        if rc:
                            raise RuntimeError(f"{name} siren_bwd: cudaError {rc}")

                    fwd_txt = []
                    for (x, t), ref in zip(fwd_in, fwd_ref):
                        y = torch.empty_like(ref)
                        ms = cuda_ms(lambda: run_fwd(x, t, y), 20)
                        torch.cuda.synchronize()
                        fwd_txt.append(f"B={x.shape[0]} {ms:.4f} (err "
                                       f"{(y - ref).abs().max().item():.2e})")
                    dx, dt = torch.empty_like(xb), torch.empty_like(thb)
                    bms = cuda_ms(run_bwd, 10)
                    torch.cuda.synchronize()
                    edx = ((dx - rdx).abs().max() / rdx.abs().max()).item()
                    edt = ((dt - rdt).abs().max() / rdt.abs().max()).item()
                    print(f"round {rep} {name:9s} {cfg.name:5s} (instances fwd "
                          f"{inst['siren_fwd']}, bwd {inst['siren_bwd']}) siren_fwd "
                          + ", ".join(fwd_txt)
                          + f" | siren_bwd B={xb.shape[0]} {bms:.4f} (dx {edx:.2e}, dtheta "
                          f"{edt:.2e}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
