"""Crash-safe snapshot IO, a copy of ``recombiner_tpu/io/atomic.py``.

A snapshot writer can be killed mid-write, and a truncated npz would then
fail every later resume. Writes go to a temporary file in the same
directory and ``os.replace`` into place, so readers see the old snapshot or
the new one, never a torn one.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


class SnapshotRejected(ValueError):
    """A snapshot that is valid on disk but must not be used (a newer format
    version, another prior's fingerprint). Never quarantined by
    ``load_snapshot_or_none``: quarantining would silently restart hours of
    work over a condition the caller needs to see."""


def _npz_path(path: str) -> str:
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def atomic_savez(path: str, arrays: dict) -> None:
    """np.savez to ``path`` (npz suffix added as np.savez adds it), atomically."""
    final = _npz_path(path)
    parent = os.path.dirname(final)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def load_snapshot_or_none(
    path: str, loader: Callable[[str], T]
) -> Tuple[Optional[T], Optional[str]]:
    """Run ``loader(path)`` if the snapshot exists; (None, reason) when absent
    or unreadable. A corrupt snapshot (torn or truncated) is reported,
    renamed out of the way so that the next snapshot can land, and treated
    as absent: losing a few groups of rework beats a crash loop."""
    import json
    import zipfile
    import zlib

    final = _npz_path(path)
    if not os.path.exists(final):
        return None, None
    try:
        return loader(path), None
    except (
        zipfile.BadZipFile,
        EOFError,
        KeyError,
        json.JSONDecodeError,  # torn __header__ json
        zlib.error,  # truncated deflate stream inside the zip
        ValueError,  # numpy "cannot reshape"/"truncated" on a torn member
    ) as e:
        # corruption-shaped errors only. SnapshotRejected (valid files the
        # caller must see) and anything else re-raise.
        if isinstance(e, SnapshotRejected):
            raise
        if type(e) is ValueError and _npz_intact(final):
            # a bare ValueError over a structurally sound npz is a bug in
            # the loader or the geometry, not a torn file: keep the evidence
            raise
        quarantine = final + ".corrupt"
        try:
            os.replace(final, quarantine)
        except OSError:
            pass
        return None, f"snapshot {final} unreadable ({e!r}); moved to {quarantine}"


def _npz_intact(final: str) -> bool:
    """True when the npz's zip structure and every member's deflate stream
    and npy payload read back cleanly, i.e. a loader error over this file
    is the loader's fault, not a torn file."""
    import zipfile

    try:
        with zipfile.ZipFile(final) as zf:
            if zf.testzip() is not None:
                return False
        with np.load(final, allow_pickle=False) as z:
            for k in z.files:
                z[k]
        return True
    except Exception:
        return False
