"""Device choice and precision policy for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

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
def exact_f32() -> Iterator[None]:
    """Exact f32 products in cuBLAS and cuDNN (TF32 off) for the duration.

    The JAX package evaluates decode at precision='highest'
    (recombiner_tpu/coding/encoder.py:980-1004); torch's default
    ``cudnn.allow_tf32=True`` would put the conv stack on TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


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
