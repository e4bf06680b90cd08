"""Stored-activation estimate and the ``--remat`` tri-state, a copy of
``recombiner_tpu/utils/memory.py`` with the same formula and the same 8 GB
threshold, so that the port's CLI turns rematerialisation on where the JAX
package's does.

The formula and its constants were fitted on the TPU the JAX package ran
on; what remat saves and costs on the H100 is measured by
``chip_smoke.py`` (phase "Kodak remat", PERF.md).
"""

from __future__ import annotations

from typing import Optional

from recombiner_tpu_torch.config import ModalityConfig

_CHAIN_ARRAYS = 7  # live (rows * S, pixels, 32) f32 arrays through the INR/PE chain
_REMAT_THRESHOLD_GB = 8.0


def stored_activation_gb(cfg: ModalityConfig, n_rows: int, sample_size: int,
                         n_devices: int = 1) -> float:
    """Estimated stored activations per device for one ELBO backward, in GB:
    the INR chain, plus for a patch config about 4 live arrays of the
    stitched canvas's positional encodings (n_data * S, canvas pixels, 16).
    ``n_rows`` counts the rows of ``n_devices`` ranks that split them (the
    CLIs pass the rows one rank holds, and 1)."""
    rows_per_device = n_rows * sample_size / max(n_devices, 1)
    gb = _CHAIN_ARRAYS * rows_per_device * cfg.n_pixels * 32 * 4 / 1e9
    if cfg.patch:
        canvas_px = cfg.n_pixels * cfg.patches_per_datapoint
        data_per_device = rows_per_device / cfg.patches_per_datapoint
        gb += 4 * data_per_device * canvas_px * 16 * 4 / 1e9
    return gb


def resolve_remat(remat: Optional[bool], cfg: ModalityConfig, n_rows: int, sample_size: int,
                  n_devices: int = 1) -> bool:
    """Tri-state ``--remat``: None = on when the estimate exceeds the
    threshold; an explicit value stands, with a warning when it is off
    above the threshold."""
    est = stored_activation_gb(cfg, n_rows, sample_size, n_devices)
    if remat is None:
        on = est > _REMAT_THRESHOLD_GB
        if on:
            print(f"~{est:.1f} GB of stored activations per device: enabling --remat "
                  "(override with --no-remat)", flush=True)
        return on
    if est > _REMAT_THRESHOLD_GB and not remat:
        print(f"WARNING: ~{est:.1f} GB of stored activations per device with --no-remat; "
              "expect a device out-of-memory error", flush=True)
    return remat
