"""The matmul-precision half of ``recombiner_tpu/utils/platform.py``: the
``--precision`` flag of ``cli/compress`` and ``cli/rd_sweep``.

The JAX package sets ``jax_default_matmul_precision``. On an NVIDIA card
XLA runs ``DEFAULT`` and ``HIGH`` f32 products as TF32 and ``HIGHEST`` as
exact f32, so the port has two levels: TF32 (``allow_tf32`` on in cuBLAS
and cuDNN) and exact (both off). Which one the process runs where no scope
says otherwise, its ambient, is ``AMBIENT`` below: TF32 unless
``apply_matmul_precision("highest")`` made it exact.
``device.precision`` sets the flags from it.

What each mode runs at: phase 1, prior training / the coding finetunes /
A* scoring and decode (``tests/test_torch_precision.py`` pins it):

- none: TF32 / TF32, exact for the unrounded-PSNR configs (the audio
  family) / exact;
- ``default``: TF32 / TF32 / exact;
- ``scoped``: TF32 / exact / exact;
- ``scoped_high``: TF32 / TF32 / exact;
- ``high``: TF32 / as none / exact;
- ``highest``: exact / exact / exact.

On the card ``high`` therefore computes what none computes, and
``scoped_high`` what ``default`` computes.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

#: CLI choices for --precision, as the JAX package's. The default (None)
#: is the JAX package's measured RD-parity point: optimisation at the
#: ambient precision, A* scoring and decode exact in every mode.
PRECISION_CHOICES = ("scoped", "scoped_high", "default", "high", "highest")

#: The precisions a scope may name: None (the ambient), the two TF32 names
#: and the exact one.
LEVELS = (None, "default", "high", "highest")

#: The process's ambient precision: "high" (TF32) or "highest" (exact).
AMBIENT = "high"


def _check(precision: Optional[str]) -> None:
    if precision not in LEVELS:
        raise ValueError(f"precision must be one of {LEVELS}, not {precision!r}")


def is_exact(precision: Optional[str]) -> bool:
    """Whether ``precision`` (None: the ambient) means exact f32 products."""
    _check(precision)
    return (AMBIENT if precision is None else precision) == "highest"


def apply_matmul_precision(precision: Optional[str]) -> None:
    """Set the process's ambient precision (a no-op for None): 'highest'
    makes it exact, 'high' or 'default' TF32."""
    global AMBIENT
    _check(precision)
    if precision:
        AMBIENT = "highest" if precision == "highest" else "high"


@contextlib.contextmanager
def ambient(precision: Optional[str]) -> Iterator[None]:
    """``apply_matmul_precision(precision)`` for the duration."""
    saved = AMBIENT
    apply_matmul_precision(precision)
    try:
        yield
    finally:
        apply_matmul_precision(saved)


def apply_precision_mode(precision: Optional[str]) -> Optional[str]:
    """Apply a --precision flag; returns the coding-phase precision to pass
    to ``compress(coding_precision=...)``.

    - None: nothing changes; compress() applies its per-modality auto
      (the unrounded-PSNR configs' finetunes exact, so that the exact
      decode renders the function they optimised);
    - 'default': the sentinel that skips the auto (finetunes at the
      ambient);
    - 'scoped': finetunes exact ('highest');
    - 'scoped_high': finetunes at 'high' (TF32 on the card, which is what
      'default' computes);
    - 'high' / 'highest': the ambient for the whole process (TF32, which
      it already is, or exact); returns None, so the auto applies.
    """
    if precision is None:
        return None
    if precision == "default":
        return "default"
    if precision == "scoped":
        return "highest"
    if precision == "scoped_high":
        return "high"
    if precision not in PRECISION_CHOICES:
        raise ValueError(f"--precision must be one of {PRECISION_CHOICES}, not {precision!r}")
    apply_matmul_precision(precision)
    return None
