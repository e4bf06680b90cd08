"""Convert prior checkpoints between the reference's pickle format and the
artifact format, both directions; the port's copy of
``recombiner_tpu/cli/convert.py`` with the same flags. Host code: no device
is involved.

    # reference pickle -> artifact
    python -m recombiner_tpu_torch.cli.convert --pickle PRIOR_....pkl --dataset cifar \\
        --reference_path /path/to/RECOMBINER --out prior.npz

    # artifact -> reference pickle (read by the reference's main_compression.py)
    python -m recombiner_tpu_torch.cli.convert --to_reference --artifact prior.npz \\
        --reference_path /path/to/RECOMBINER --out PRIOR_exported.pkl
"""

from __future__ import annotations

import argparse

from recombiner_tpu_torch.io.checkpoint import load_prior_artifact, save_prior_artifact
from recombiner_tpu_torch.io.convert_reference import convert_reference_checkpoint
from recombiner_tpu_torch.io.export_reference import export_reference_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert prior checkpoints reference<->artifact "
                                            "(PyTorch port)")
    p.add_argument("--pickle", default=None, help="reference PRIOR_*.pkl path (import direction)")
    p.add_argument("--artifact", default=None, help="prior .npz path (export direction)")
    p.add_argument("--to_reference", action="store_true",
                   help="export the artifact to the reference pickle format")
    p.add_argument("--dataset", default=None, help="required for the import direction")
    p.add_argument("--reference_path", default=None,
                   help="path to the reference repo (needed for its nn.Module classes)")
    p.add_argument("--out", required=True)
    p.add_argument("--codebook_seed", type=int, default=42)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.to_reference:
        if not args.artifact:
            raise SystemExit("--to_reference requires --artifact")
        art = load_prior_artifact(args.artifact)
        export_reference_checkpoint(art, args.out, reference_path=args.reference_path)
        print(f"Exported {args.artifact} -> {args.out} (reference pickle format)", flush=True)
        return art
    if not args.pickle or not args.dataset:
        raise SystemExit("import direction requires --pickle and --dataset")
    art = convert_reference_checkpoint(args.pickle, args.dataset,
                                       reference_path=args.reference_path,
                                       codebook_seed=args.codebook_seed)
    save_prior_artifact(args.out, art)
    print(f"Converted {args.pickle} -> {args.out} "
          f"(n_groups={art.w.grouping.n_groups}, kl_beta={art.kl_beta:.3g})", flush=True)
    return art


if __name__ == "__main__":
    main()
