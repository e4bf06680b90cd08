"""Device choice and precision policy for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

from recombiner_tpu_torch.utils import platform

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card. Raises when a CUDA device is asked for
    and there is none: the port never drops to the CPU by itself, only when
    the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    return dev


@contextlib.contextmanager
def precision(mode: Optional[str] = None) -> Iterator[None]:
    """TF32 on or off in cuBLAS and cuDNN for the duration, restored after:
    off for 'highest', on for 'high' and 'default', and for None as the
    process's ambient says (``utils/platform.py``: TF32 unless
    ``apply_matmul_precision('highest')``). Torch's own defaults (cuDNN
    TF32 on, cuBLAS off) never decide a product of the port's."""
    tf32 = not platform.is_exact(mode)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def exact_f32() -> contextlib.AbstractContextManager:
    """Exact f32 products in cuBLAS and cuDNN (TF32 off) for the duration,
    whatever the mode: the exact surfaces, as the JAX package evaluates
    A* scoring and decode at precision='highest'
    (recombiner_tpu/coding/encoder.py:738-752, 980-1004)."""
    return precision("highest")


@contextlib.contextmanager
def deterministic_convs() -> Iterator[None]:
    """cuDNN restricted to deterministic algorithms for the duration.

    With its own choice, cuDNN runs the encode's data gradient through the
    phase conv stack on an algorithm whose sums are not ordered
    (``dgrad_engine``; two epochs from one state differ), so a crashed and
    resumed encode would not repeat the uninterrupted one. Restricted, the
    epoch repeats bit for bit and is faster on the H100 (PERF.md section 5)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
