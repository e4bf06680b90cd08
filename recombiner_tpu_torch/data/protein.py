"""Protein backbone loading and preprocessing (PDB C-alpha chains), a copy of
``recombiner_tpu/data/protein.py`` with its pure-Python parser (the JAX
package's g++ helper is bit-identical to it and is not carried over):
chains of at least 96 residues, truncated to 96, centred, scaled by 1/25."""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.data.pipeline import points_from_data

MAX_LENGTH = 96
SCALE = 25.0


def parse_pdb_ca(path: str) -> Optional[np.ndarray]:
    """The first MAX_LENGTH C-alpha coordinates (MAX_LENGTH, 3) of a PDB
    file, or None if it has fewer or a malformed record; a file that cannot
    be opened raises."""
    coords = []
    count = 0
    try:
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts and parts[0] == "ATOM" and len(parts) > 8 and parts[2] == "CA":
                    count += 1
                    if len(coords) < MAX_LENGTH:
                        coords.append([float(v) for v in parts[6:9]])
    except (ValueError, IndexError):
        pass
    if count < MAX_LENGTH:
        return None
    return np.asarray(coords[:MAX_LENGTH], np.float32)


def normalize_backbone(xyz: np.ndarray) -> np.ndarray:
    """Centre and scale by 1/25 (RMSD scales back by 25)."""
    return (xyz - xyz.mean(0)) / SCALE


def process_protein_datasets(train_pdb_paths, test_pdb_paths, save_dir: str) -> None:
    """Parse, keep and normalise chains; write ``test_dataset.npz`` and
    ``train_dataset.npz`` of (96, 3) chains under ``save_dir``."""
    def process(paths):
        out = []
        for p in paths:
            xyz = parse_pdb_ca(p)
            if xyz is not None:
                out.append(normalize_backbone(xyz))
        return out

    np.savez(save_dir + "/test_dataset.npz", *process(test_pdb_paths))
    np.savez(save_dir + "/train_dataset.npz", *process(train_pdb_paths))


def load_chain_list(path: str) -> List[np.ndarray]:
    """Chains (96, 3) from an ``.npz`` dump, or from a ``.pkl`` of the
    reference's (3, 96) torch tensors."""
    if path.endswith(".npz"):
        z = np.load(path)
        return [z[k] for k in z.files]
    with open(path, "rb") as f:
        tensors = pickle.load(f)
    out = []
    for t in tensors:
        arr = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
        if arr.shape[0] == 3 and arr.shape[1] != 3:
            arr = arr.T
        out.append(arr.astype(np.float32))
    return out


def load_protein(chains: Sequence[np.ndarray],
                 cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    return points_from_data([np.asarray(c, np.float32) for c in chains], cfg)
