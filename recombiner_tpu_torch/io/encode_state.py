"""Encode snapshots that a crashed encode resumes from, in the format of
``recombiner_tpu/io/encode_state.py`` (STATE_VERSION 2), so that a snapshot
written by either package loads in the other.

One ``.npz``: per level (w, and h and hh for a patch config)
``{level}/loc``, ``{level}/log_scale`` and the five ``_FIELDS``; the
phase-1 Adam state as ``__opt__/{i}`` in optax's leaf order
(``encoder.AdamState.leaves``); and a JSON ``__header__``. The JAX
package stores its threefry key as ``resume_key``; the port stores its
``torch.Generator`` state under a field of its own (``GENERATOR_FIELD``),
which the JAX package does not read.

Data-parallel: every rank calls ``save_encode_state``; a sharded state is
gathered into the single-device layout (the caller passes the Adam leaves
gathered, ``AdamState.leaves(scheduled, part, levels)``) and rank 0
writes, so a snapshot resumes at any world size: load on every rank, then
``shard_rows``.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from recombiner_tpu_torch.coding.decoder import LEVELS, CodecState, LevelState
from recombiner_tpu_torch.device import DeviceLike, resolve_device
from recombiner_tpu_torch.io.atomic import SnapshotRejected, atomic_savez
from recombiner_tpu_torch.io.convert import level_arrays
from recombiner_tpu_torch.parallel.launch import is_primary
from recombiner_tpu_torch.models.gaussian import Gaussian

STATE_VERSION = 2
GENERATOR_FIELD = "torch_generator"

_FIELDS = ("frozen_mask", "frozen_val", "kl_beta", "compressed", "indices")


class FingerprintMismatch(SnapshotRejected):
    """The snapshot belongs to another prior artifact; never quarantined by
    ``io.atomic.load_snapshot_or_none`` (it is not corruption)."""


def generator_record(generator: torch.Generator) -> dict:
    """A generator's state for a snapshot header: its device type and state
    bytes as hex."""
    return {"device": generator.device.type,
            "state": generator.get_state().numpy().tobytes().hex()}


def generator_state(header: dict, device: DeviceLike) -> Optional[torch.Tensor]:
    """The generator state a snapshot header holds for a generator on
    ``device``; None when it holds none (a JAX-package snapshot) or one of
    another device type."""
    rec = header.get(GENERATOR_FIELD)
    if rec is None or rec["device"] != torch.device(device).type:
        return None
    return torch.frombuffer(bytearray.fromhex(rec["state"]), dtype=torch.uint8)


def save_encode_state(path: str, state: CodecState, *, extra: Optional[dict] = None,
                      opt_leaves: Optional[list] = None) -> None:
    """Write ``state`` (and ``opt_leaves``, the phase-1 Adam state's leaves)
    atomically, with ``extra`` merged into the header; every rank's rows,
    written by rank 0."""
    state = state.gathered()
    if not is_primary():
        return
    arrays = {}
    levels = [name for name in LEVELS if state.level(name) is not None]
    for name in levels:
        for f, a in level_arrays(state.level(name)).items():
            arrays[f"{name}/{f}"] = a
    for i, leaf in enumerate(opt_leaves or ()):
        arrays[f"__opt__/{i}"] = np.asarray(leaf)
    header = {
        "version": STATE_VERSION,
        "levels": levels,
        "n_opt_leaves": 0 if opt_leaves is None else len(opt_leaves),
        **(extra or {}),
    }
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    atomic_savez(path, arrays)


def load_encode_state_full(path: str, expect_fingerprint=None, device: DeviceLike = None):
    """-> (CodecState on ``device``, header dict, optimizer leaves as numpy or
    None).

    ``expect_fingerprint``: the current prior's ``prior_fingerprint``, or a
    collection of accepted ones (``accepted_fingerprints``). A snapshot
    written under another prior is refused with ``FingerprintMismatch``:
    its frozen samples and indices index the other prior's codebooks."""
    dev = resolve_device(device)
    with np.load(path if str(path).endswith(".npz") else path + ".npz") as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["version"] > STATE_VERSION:
            raise SnapshotRejected(f"encode state version {header['version']} unsupported")
        snap_fp = header.get("prior_fingerprint")
        accepted = (None if expect_fingerprint is None
                    else (expect_fingerprint,) if isinstance(expect_fingerprint, str)
                    else tuple(expect_fingerprint))
        if accepted is not None and snap_fp is not None and snap_fp not in accepted:
            raise FingerprintMismatch(
                f"encode snapshot {path} was written under prior {snap_fp}, current prior "
                f"accepts {list(accepted)}; refusing to resume (delete the snapshot or load "
                "the matching prior)")
        def t(key, dtype=torch.float32):
            return torch.as_tensor(np.asarray(z[key]), device=dev).to(dtype)

        def level(name: str) -> LevelState:
            return LevelState(
                q=Gaussian(loc=t(f"{name}/loc"), log_scale=t(f"{name}/log_scale")),
                frozen_mask=t(f"{name}/frozen_mask"),
                frozen_val=t(f"{name}/frozen_val"),
                kl_beta=t(f"{name}/kl_beta"),
                compressed=t(f"{name}/compressed", torch.bool),
                indices=t(f"{name}/indices", torch.int64),
            )

        state = CodecState(**{name: level(name) for name in header["levels"]})
        n_opt = int(header.get("n_opt_leaves", 0))
        opt_leaves = [np.asarray(z[f"__opt__/{i}"]) for i in range(n_opt)] if n_opt else None
    return state, header, opt_leaves
