"""Versioned prior artifact, a copy of ``recombiner_tpu/io/checkpoint.py``:
the same ``.npz`` of named arrays plus a JSON header (FORMAT_VERSION 1), so
an artifact written by either package loads in the other, and the same
fingerprint of it."""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig, config_from_dict, config_to_dict
from recombiner_tpu_torch.priors.grouping import Grouping

FORMAT_VERSION = 1

_GROUPING_FIELDS = (
    "group_start",
    "group_end",
    "group_idx",
    "param2group",
    "group2param",
    "group_kls",
    "weights",
)


@dataclasses.dataclass
class LevelArtifact:
    """Prior + grouping for one latent level, in PARAM order."""

    p_loc: np.ndarray  # (D,)
    p_scale: np.ndarray  # (D,) natural scale (post-softplus)
    avg_log_scale: np.ndarray  # (D,) training-average raw log_scale
    grouping: Grouping


@dataclasses.dataclass
class PriorArtifact:
    config: ModalityConfig
    kl_beta: float
    w: LevelArtifact  # level 1: concat(INR latents, flattened LPE)
    h: Optional[LevelArtifact]  # level 2 (patch mode only)
    hh: Optional[LevelArtifact]  # level 3
    A: list  # per-layer linear transform matrices
    up: Dict  # upsampler conv params {conv{i}: {w (*k, I, O), b}}
    codebook_seed: int = 42
    codebook_kind: str = "threefry"  # part of the bitstream format

    @property
    def levels(self):
        out = {"w": self.w}
        if self.h is not None:
            out["h"] = self.h
            out["hh"] = self.hh
        return out


def _pack_level(prefix: str, lv: LevelArtifact, arrays: dict):
    arrays[f"{prefix}/p_loc"] = np.asarray(lv.p_loc, np.float32)
    arrays[f"{prefix}/p_scale"] = np.asarray(lv.p_scale, np.float32)
    arrays[f"{prefix}/avg_log_scale"] = np.asarray(lv.avg_log_scale, np.float32)
    for f in _GROUPING_FIELDS:
        arrays[f"{prefix}/grouping/{f}"] = np.asarray(getattr(lv.grouping, f))


def _unpack_level(prefix: str, z) -> LevelArtifact:
    gkw = {f: z[f"{prefix}/grouping/{f}"] for f in _GROUPING_FIELDS}
    grouping = Grouping(n_groups=int(gkw["group_start"].shape[0]), **gkw)
    return LevelArtifact(
        p_loc=z[f"{prefix}/p_loc"],
        p_scale=z[f"{prefix}/p_scale"],
        avg_log_scale=z[f"{prefix}/avg_log_scale"],
        grouping=grouping,
    )


def prior_fingerprint(art: PriorArtifact, *, _legacy: bool = False) -> str:
    """Short content hash of a prior artifact, equal byte for byte to the JAX
    package's (``recombiner_tpu/io/checkpoint.py:84-120``). Encode snapshots
    carry it, so that a resume against another prior (other codebooks and
    priors than the snapshot's frozen samples were drawn from) is refused.
    ``_legacy`` is the earlier formula, without avg_log_scale and the
    up-net weights, which older snapshots carry."""
    import hashlib

    hsh = hashlib.sha256()
    hsh.update(
        f"{art.config.name}|{art.codebook_seed}|{art.codebook_kind}|{art.kl_beta:.9e}".encode()
    )
    for name, lv in sorted(art.levels.items()):
        hsh.update(name.encode())
        hsh.update(np.ascontiguousarray(lv.p_loc, np.float32).tobytes())
        hsh.update(np.ascontiguousarray(lv.p_scale, np.float32).tobytes())
        hsh.update(np.ascontiguousarray(lv.grouping.param2group, np.int32).tobytes())
        if not _legacy:
            hsh.update(np.ascontiguousarray(lv.avg_log_scale, np.float32).tobytes())
    for a in art.A:
        hsh.update(np.ascontiguousarray(a, np.float32).tobytes())
    if not _legacy:
        for name in sorted(art.up):
            hsh.update(name.encode())
            hsh.update(np.ascontiguousarray(art.up[name]["w"], np.float32).tobytes())
            hsh.update(np.ascontiguousarray(art.up[name]["b"], np.float32).tobytes())
    return hsh.hexdigest()[:16]


def accepted_fingerprints(art: PriorArtifact) -> tuple:
    """(current, legacy) fingerprints of ``art``: a resume accepts either."""
    return (prior_fingerprint(art), prior_fingerprint(art, _legacy=True))


def save_prior_artifact(path: str, art: PriorArtifact) -> None:
    header = {
        "format_version": FORMAT_VERSION,
        "config": config_to_dict(art.config),
        "kl_beta": float(art.kl_beta),
        "codebook_seed": int(art.codebook_seed),
        "codebook_kind": art.codebook_kind,
        "has_hierarchy": art.h is not None,
        "n_layers": len(art.A),
    }
    arrays: dict = {"__header__": np.frombuffer(json.dumps(header).encode(), np.uint8)}
    _pack_level("w", art.w, arrays)
    if art.h is not None:
        _pack_level("h", art.h, arrays)
        _pack_level("hh", art.hh, arrays)
    for i, a in enumerate(art.A):
        arrays[f"A/{i}"] = np.asarray(a, np.float32)
    for name, conv in art.up.items():
        arrays[f"up/{name}/w"] = np.asarray(conv["w"], np.float32)
        arrays[f"up/{name}/b"] = np.asarray(conv["b"], np.float32)
    np.savez(path, **arrays)


def load_prior_artifact(path: str) -> PriorArtifact:
    with np.load(path if str(path).endswith(".npz") else path + ".npz") as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {header['format_version']} is newer than supported "
                f"{FORMAT_VERSION}"
            )
        cfg = config_from_dict(header["config"])
        w = _unpack_level("w", z)
        h = hh = None
        if header["has_hierarchy"]:
            h = _unpack_level("h", z)
            hh = _unpack_level("hh", z)
        A = [z[f"A/{i}"] for i in range(header["n_layers"])]
        up = {}
        for key in z.files:
            if key.startswith("up/"):
                _, name, leaf = key.split("/")
                up.setdefault(name, {})[leaf] = z[key]
    return PriorArtifact(
        config=cfg,
        kl_beta=float(header["kl_beta"]),
        w=w,
        h=h,
        hh=hh,
        A=A,
        up=up,
        codebook_seed=int(header.get("codebook_seed", 42)),
        codebook_kind=str(header.get("codebook_kind", "threefry")),
    )
