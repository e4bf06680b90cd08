#!/usr/bin/env python3
"""Where the time of the port's SIREN kernels goes, on one CUDA card.

    python3 scripts/torch_siren_variants.py [--seed 0]

Builds the committed kernel sources (recombiner_tpu_torch/ops/csrc) once as
they are and once per variant below, each variant a copy with one textual
edit built by ops/_build.py and bound by ops/fused_inr.py, and times siren_fwd (CIFAR decode, B = 500; and B = 2,500) and
siren_bwd (CIFAR encode, B = 2,500, P = 1,024) with CUDA events, each held
against its plain version. A variant that cuts a phase out computes wrong
numbers on purpose: its time says what the phase costs, its error is only
printed. Every edit must apply, or the script stops.

  no_dw       siren_bwd without its dW/db phase
  no_sin      the branch-free sincos replaced by sin x = x, cos x = 1
  one_pass    one TF32 product (hi x hi) in place of three
  cvt_rna     the TF32 rounding by cvt.rna.tf32.f32 instead of integer ops
  generic     CIFAR served by the run-time-width instance (up to 64 wide,
              8 layers), not the one with CIFAR's widths fixed

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

from chip_smoke import card_line, cuda_ms, kernel_inputs, make_cifar_artifact  # noqa: E402
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
    "generic": [("siren_mma.cuh", "  return fixed;\n", "  return false;\n")],
}


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
    art = make_cifar_artifact(args.seed)
    cfg = art.config
    dims = list(cfg.net_dims)
    dims_c = ctypes.cast((ctypes.c_int * len(dims))(*dims), ctypes.c_void_p)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as root, exact_f32():
        dirs = write_variants(root)
        x, th = kernel_inputs(art, 500, cfg.n_pixels, gen)
        x5, th5 = kernel_inputs(art, 2500, cfg.n_pixels, gen)
        dy5 = torch.randn(2500, cfg.n_pixels, cfg.output_dim, generator=gen, device="cuda")
        ref = fused_inr.siren_forward_reference(x, th, dims, cfg.w0)
        rdx, rdt = fused_inr.siren_backward_reference(x5, th5, dy5, dims, cfg.w0)
        print(f"card: {card}; CIFAR widths {dims}; times in ms (CUDA events); errors: forward "
              "max abs diff, backward max abs diff over the largest entry")
        for rep in range(2):
            for name, d in dirs.items():
                fwd = fused_inr.kernel_lib("siren_fwd", d).siren_fwd
                bwd = fused_inr.kernel_lib("siren_bwd", d).siren_bwd
                y, y5 = torch.empty_like(ref), torch.empty(2500, cfg.n_pixels, cfg.output_dim,
                                                           device="cuda")
                dx, dt = torch.empty_like(x5), torch.empty_like(th5)

                def run_fwd(xx, tt, yy):
                    rc = fwd(xx.data_ptr(), tt.data_ptr(), yy.data_ptr(), xx.shape[0],
                             xx.shape[1], len(dims) - 1, dims_c, tt.shape[1], cfg.w0, 1, stream)
                    if rc:
                        raise RuntimeError(f"{name} siren_fwd: cudaError {rc}")

                def run_bwd():
                    rc = bwd(x5.data_ptr(), th5.data_ptr(), dy5.data_ptr(), dx.data_ptr(),
                             dt.data_ptr(), 2500, cfg.n_pixels, len(dims) - 1, dims_c,
                             th5.shape[1], cfg.w0, stream)
                    if rc:
                        raise RuntimeError(f"{name} siren_bwd: cudaError {rc}")

                ms = cuda_ms(lambda: run_fwd(x, th, y), 50)
                ms5 = cuda_ms(lambda: run_fwd(x5, th5, y5), 20)
                bms = cuda_ms(run_bwd, 10)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                edx = ((dx - rdx).abs().max() / rdx.abs().max()).item()
                edt = ((dt - rdt).abs().max() / rdt.abs().max()).item()
                print(f"round {rep} {name:9s} siren_fwd B=500 {ms:.4f}, B=2500 {ms5:.4f} "
                      f"(err {err:.2e}) | siren_bwd B=2500 {bms:.4f} (dx {edx:.2e}, dtheta "
                      f"{edt:.2e}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
