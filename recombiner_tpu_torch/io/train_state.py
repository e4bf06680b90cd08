"""Resumable prior-training state, a copy of ``recombiner_tpu/io/train_state.py``:
the whole ``PriorState`` (posteriors and mappings), the M-step's ``Priors``,
kl_beta, the EM iteration count and the rate controller in one flat npz,
written atomically (``io/atomic.py``). The leaves are stored as the JAX
package stores them, ``state/i`` and ``priors/i`` in ``jax.tree_util``
order with conv weights (*k, I, O) (``io/convert.py::prior_state_leaves``),
so that a file written by either package loads in the other. Version 2
adds the controller dict and ``schedule_total``; version 1 files load with
both None.

Data-parallel: every rank calls ``save_train_state``; the sharded rows are
gathered into the single-device layout and rank 0 writes, so a snapshot
resumes at any world size (load on every rank, then ``shard_rows``).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.device import DeviceLike
from recombiner_tpu_torch.io.atomic import SnapshotRejected, atomic_savez
from recombiner_tpu_torch.io.convert import prior_state_from, prior_state_leaves
from recombiner_tpu_torch.parallel.launch import is_primary
from recombiner_tpu_torch.priors.trainer import Priors, PriorState

STATE_VERSION = 2


def save_train_state(path: str, state: PriorState, priors: Priors, kl_beta: float,
                     em_iter: int, controller: Optional[dict] = None,
                     schedule_total: Optional[int] = None) -> None:
    """``controller`` is ``em_train``'s rate-controller dict (aim, in_window,
    seen_above) and ``schedule_total`` the whole planned schedule: a resume
    continues the controller where it stood and keeps its schedule
    fractions anchored to the whole run."""
    st, pr = prior_state_leaves(state.gathered(), priors)
    if not is_primary():
        return
    arrays = {f"state/{i}": a for i, a in enumerate(st)}
    arrays.update({f"priors/{i}": a for i, a in enumerate(pr)})
    header = {"version": STATE_VERSION, "kl_beta": float(kl_beta), "em_iter": int(em_iter),
              "train_size": int(st[0].shape[0])}
    if controller is not None:
        header["controller"] = {
            "aim": float(controller.get("aim", 1.0)),
            "in_window": bool(controller.get("in_window", False)),
            "seen_above": bool(controller.get("seen_above", False)),
        }
    if schedule_total is not None:
        header["schedule_total"] = int(schedule_total)
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    atomic_savez(path, arrays)


def load_train_state(path: str, cfg: ModalityConfig, device: DeviceLike = None
                     ) -> Tuple[PriorState, Priors, float, int, dict]:
    """(state, priors, kl_beta, EM iterations done, extra) on ``device``,
    extra = {"controller": dict or None, "schedule_total": int or None}."""
    with np.load(path if str(path).endswith(".npz") else path + ".npz") as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["version"] > STATE_VERSION:
            raise SnapshotRejected(f"train state version {header['version']} unsupported")
        st = [z[f"state/{i}"] for i in range(sum(k.startswith("state/") for k in z.files))]
        pr = [z[f"priors/{i}"] for i in range(sum(k.startswith("priors/") for k in z.files))]
    if st[0].shape[0] != header["train_size"]:
        raise ValueError(f"train state of {st[0].shape[0]} rows, header says "
                         f"{header['train_size']}")
    state, priors = prior_state_from(st, pr, cfg, device)
    return (state, priors, float(header["kl_beta"]), int(header["em_iter"]),
            {"controller": header.get("controller"),
             "schedule_total": header.get("schedule_total")})
