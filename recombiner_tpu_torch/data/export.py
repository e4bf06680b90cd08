"""Decoded reconstructions to media files, a copy of
``recombiner_tpu/data/export.py``: decoded rows (R, P, C) (patch rows for a
patch config) are reassembled into datapoints and written as PNG (2-D),
WAV (1-D single-channel), PDB (protein) or NPZ (anything else, such as
video). The PNG writer is the standard library's zlib and struct, so no
imaging package is needed; its pixels are the JAX package's PIL-written
ones."""

from __future__ import annotations

import os
import struct
import wave
import zlib
from typing import List

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.coords import unpatchify
from recombiner_tpu_torch.data.protein import SCALE as PROTEIN_SCALE

_PNG_COLOR_TYPE = {1: 0, 3: 2}  # channels -> grey, RGB


def reassemble(y: np.ndarray, cfg: ModalityConfig) -> np.ndarray:
    """(R, P, C) decoded rows -> (n_data, *full_spatial, C)."""
    R = y.shape[0]
    per = cfg.patches_per_datapoint
    y = y.reshape(R, *cfg.pixel_sizes, cfg.output_dim)
    if not cfg.patch:
        return y
    return np.stack([unpatchify(y[d * per : (d + 1) * per], cfg.patch_nums)
                     for d in range(R // per)])


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """img (H, W, C) in [0, 1], C = 1 or 3 -> 8-bit grey or RGB PNG, rounded
    as the codec's PSNR rounds (round(clip(x, 0, 1) * 255))."""
    arr = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_png_chunk(b"IEND", b""))


def write_wav(path: str, clip: np.ndarray, sample_rate: int = 16000) -> None:
    """clip (L,) or (L, 1) in [0, 1] (the loader's normalisation) -> 16-bit
    PCM of 2 * clip - 1."""
    x = np.asarray(clip).reshape(-1)
    pcm = np.clip(x * 2.0 - 1.0, -1.0, 1.0)
    pcm16 = np.round(pcm * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())


def read_wav(path: str) -> np.ndarray:
    """A 16-bit PCM WAV -> (L,) in [0, 1]."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        pcm16 = np.frombuffer(w.readframes(n), "<i2").astype(np.float32) / 32767.0
    return (pcm16 + 1.0) / 2.0


def write_pdb(path: str, xyz_normalized: np.ndarray) -> None:
    """(L, 3) normalised backbone -> PDB ATOM/CA records, de-normalised by
    the loader's scale (x 25)."""
    xyz = np.asarray(xyz_normalized) * PROTEIN_SCALE
    lines = [f"ATOM  {i + 1:5d}  CA  ALA A{i + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
             "           C" for i, (x, y, z) in enumerate(xyz)]
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_reconstructions(y: np.ndarray, cfg: ModalityConfig, out_dir: str,
                           stem: str = "decoded") -> List[str]:
    """One media file per decoded datapoint, ``{stem}_{i}.{ext}``; returns
    the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, datum in enumerate(reassemble(y, cfg)):
        if cfg.name == "audio" or (cfg.data_dim == 1 and cfg.output_dim == 1):
            p = os.path.join(out_dir, f"{stem}_{i}.wav")
            write_wav(p, datum)
        elif cfg.name == "protein":
            p = os.path.join(out_dir, f"{stem}_{i}.pdb")
            write_pdb(p, datum)
        elif cfg.data_dim == 2:
            p = os.path.join(out_dir, f"{stem}_{i}.png")
            write_png(p, datum)
        else:
            p = os.path.join(out_dir, f"{stem}_{i}.npz")
            np.savez_compressed(p, data=datum)
        paths.append(p)
    return paths
