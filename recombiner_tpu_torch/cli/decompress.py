"""Decompression CLI of the port: decode a ``.rctb`` bitstream against its
prior artifact on the CUDA card (or, with ``--device cpu``, on the CPU),
and save the reconstruction as ``(rows, P, out)``: one row per datapoint,
or per patch of a patch config, as the JAX package's CLI saves it. With
``--export_media`` each datapoint is also written as a PNG (2-D), WAV
(audio), PDB (protein) or NPZ (video) file (``data/export.py``).

    python -m recombiner_tpu_torch.cli.decompress --bitstream out/bitstream_test_id_0.rctb \\
        --prior_path out/PRIOR_....npz --save_dir out/ [--export_media]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from recombiner_tpu_torch.coding.decoder import decode, init_codec
from recombiner_tpu_torch.coords import grid_fourier_features
from recombiner_tpu_torch.io.bitstream import read_bitstream
from recombiner_tpu_torch.io.checkpoint import load_prior_artifact


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Decode a RECOMBINER bitstream with the PyTorch port")
    p.add_argument("--bitstream", required=True)
    p.add_argument("--prior_path", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--export_media", action="store_true",
                   help="also write reassembled PNG/WAV/PDB/NPZ files per datapoint")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card ('cpu' to run without one)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    art = load_prior_artifact(args.prior_path)
    cfg = art.config
    header, indices = read_bitstream(args.bitstream)
    if header["config"] != cfg.name:
        raise SystemExit(
            f"bitstream was encoded for config {header['config']}, prior is {cfg.name}"
        )
    if header["codebook_seed"] != art.codebook_seed:
        raise SystemExit("bitstream/prior codebook seed mismatch")
    kind = header.get("codebook_kind", "threefry")

    n_rows = indices["w"].shape[0]
    codec, _ = init_codec(art, n_rows, codebook_kind=kind, device=args.device)
    feats = grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)
    X = torch.from_numpy(feats).expand(n_rows, *feats.shape)
    y = decode(codec, indices, X, cfg).cpu().numpy()

    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(
        args.save_dir,
        os.path.basename(args.bitstream).replace(".rctb", "_decoded.npy"),
    )
    np.save(out, y)
    print(f"Decoded {n_rows} rows -> {out} shape={y.shape}", flush=True)
    if args.export_media:
        from recombiner_tpu_torch.data.export import export_reconstructions

        stem = os.path.basename(args.bitstream).replace(".rctb", "")
        paths = export_reconstructions(y, cfg, args.save_dir, stem=stem)
        print(f"Exported {len(paths)} media files ({paths[0]} ...)", flush=True)
    return y


if __name__ == "__main__":
    main()
