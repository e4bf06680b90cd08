"""Per-sample SIREN forward and backward through hand-written CUDA kernels.

The forward replaces the TPU kernels ``recombiner_tpu/ops/fused_inr.py::_fwd_kernel``
(sample groups x pixel tiles) and ``recombiner_tpu/ops/pallas_inr.py::_kernel``
(one sample per program): both become launches of one CUDA kernel,
``ops/csrc/siren_fwd.cu``, with ``samples_per_block`` samples per block. The
backward replaces ``recombiner_tpu/ops/fused_inr.py::_bwd_kernel`` with
``ops/csrc/siren_bwd.cu`` (one block per sample, the forward recomputed on
chip, dW/db summed over pixel tiles in a fixed order), wired into autograd by
``SirenMLP`` as the JAX package's ``custom_vjp`` wires its pair. Both run
every layer product on the tensor cores as a 3xTF32 split, close to f32
accuracy (``ops/csrc/siren_mma.cuh``).

Each kernel is compiled once per width set that a modality config runs
(``FIXED_WIDTHS``: CIFAR's, audio's and video's), every width a constant,
and once for widths read at run time (up to 64 in up to 8 layers: the TINY
configs and any other widths). ``instance`` picks one; the wrappers pass it
to the C entry points, which refuse a launch that names another than their
own table's.

Bound on the H100 at f32 accuracy: at CIFAR decode (B = 500, P = 1024) the
forward moves 78 MB (0.023 ms at 3.35 TB/s) for 3.24 GFLOP (0.020 ms as
3xTF32 at 495 TFLOP/s): bytes. The backward at CIFAR encode (B = 2,500) does
48.2 GFLOP (0.29 ms as 3xTF32) for 751 MB (0.22 ms): operations. The kernels
keep every intermediate activation on chip and each sample's weights in
shared memory, so only x, the weights, y (and dy, dx, dtheta) touch device
memory.

The learned A-transform stays a dense ``torch.matmul`` (cuBLAS), as the JAX
package left it to XLA, and autograd carries dtheta back through it.
``siren_forward`` and ``siren_backward`` launch their kernels for CUDA
tensors and run ``siren_forward_reference`` / ``siren_backward_reference``,
the plain PyTorch versions of the same functions, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.models.inr import latent_to_weights, slice_layer
from recombiner_tpu_torch.ops import _build

MAX_WIDTH = 64  # SIREN_MAX_WIDTH in csrc/siren_mma.cuh
MAX_LAYERS = 8  # SIREN_MAX_LAYERS
# The fixed-width instances of both kernels, in the order of
# csrc/siren_mma.cuh's SIREN_FIXED_INSTANCES: FIXED_WIDTHS[i] is instance i + 1.
FIXED_WIDTHS = (
    (32, 32, 32, 32, 3),  # CIFAR, Kodak, kodak_mini, protein
    (32, 32, 32, 32, 1),  # audio, audio_mini
    (34, 32, 32, 32, 3),  # video
)
RUNTIME_INSTANCE = 0

# Launches of each CUDA kernel, counted where it is launched and nowhere else.
launches = {"siren_fwd": 0, "siren_bwd": 0}


def theta_size(dims: Sequence[int]) -> int:
    return sum(dims[i + 1] * (dims[i] + 1) for i in range(len(dims) - 1))


def instance(dims: Sequence[int]) -> int:
    """The kernel instance these widths take: 1 + their index in
    ``FIXED_WIDTHS``, or ``RUNTIME_INSTANCE``."""
    dims = tuple(int(d) for d in dims)
    return FIXED_WIDTHS.index(dims) + 1 if dims in FIXED_WIDTHS else RUNTIME_INSTANCE


def instance_name(inst: int) -> str:
    return ("run-time <=64 x 8" if inst == RUNTIME_INSTANCE
            else "-".join(map(str, FIXED_WIDTHS[inst - 1])))


def siren_forward_reference(x: torch.Tensor, theta: torch.Tensor, dims: Sequence[int],
                            w0: float) -> torch.Tensor:
    """Plain PyTorch version: x (B, P, dims[0]), theta (B, theta_size) packed
    per layer as [b (out), W (in x out)] -> (B, P, dims[-1])."""
    B = x.shape[0]
    off = 0
    n_layers = len(dims) - 1
    for li in range(n_layers):
        i, o = dims[li], dims[li + 1]
        w, b = latent_to_weights(theta[:, off : off + o * (i + 1)], i, o)
        off += o * (i + 1)
        x = torch.baddbmm(b.reshape(B, 1, o), x, w)
        if li != n_layers - 1:
            x = torch.sin(w0 * x)
    return x


def siren_backward_reference(x: torch.Tensor, theta: torch.Tensor, dy: torch.Tensor,
                             dims: Sequence[int], w0: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, the chain written out with
    ``torch.bmm``: (x, theta, dy) -> (dx (B, P, dims[0]), dtheta (B, theta_size))
    in theta's packed layout."""
    B = x.shape[0]
    n_layers = len(dims) - 1
    ws, acts, dsin = [], [x], []
    a, off = x, 0
    for li in range(n_layers):
        i, o = dims[li], dims[li + 1]
        w, b = latent_to_weights(theta[:, off : off + o * (i + 1)], i, o)
        off += o * (i + 1)
        ws.append(w)
        z = torch.baddbmm(b.reshape(B, 1, o), a, w)
        if li != n_layers - 1:
            a = torch.sin(w0 * z)
            acts.append(a)
            dsin.append(w0 * torch.cos(w0 * z))
    dz, grads = dy, []
    for li in range(n_layers - 1, -1, -1):
        dw = torch.bmm(acts[li].transpose(1, 2), dz)
        grads.append(torch.cat([dz.sum(1), dw.reshape(B, -1)], dim=1))
        da = torch.bmm(dz, ws[li].transpose(1, 2))
        if li > 0:
            dz = da * dsin[li - 1]
    return da, torch.cat(grads[::-1], dim=1)


def kernel_lib(name: str, csrc_dir: Optional[str] = None) -> ctypes.CDLL:
    """The kernel library ``name`` (built from ``csrc_dir``, by default the
    package's sources) with its entry point's C signature declared."""
    lib = _build.load(name, csrc_dir)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    if name == "siren_fwd":
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, theta, y
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, P, n_layers
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float,  # dims (host), theta_stride, w0
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # samples_per_block, instance, stream
        ]
    else:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, theta, dy
            ctypes.c_void_p, ctypes.c_void_p,  # dx, dtheta
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, P, n_layers
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float,  # dims (host), theta_stride, w0
            ctypes.c_int, ctypes.c_void_p,  # instance, stream
        ]
    return lib


def launch_plan(name: str, dims: Sequence[int], B: int = 1, P: int = 1,
                samples_per_block: int = 1, csrc_dir: Optional[str] = None) -> dict:
    """What the C side of kernel ``name`` (built from ``csrc_dir``, by default
    the package's sources) plans for these widths on this card: warps and
    dynamic shared memory per block, resident blocks per SM and the
    instance; for siren_fwd also the pixels per block and the blocks of a
    launch of B samples of P pixels; for siren_bwd whether the dW
    accumulator is in shared memory."""
    fn = getattr(_build.load(name, csrc_dir), f"{name}_plan")
    fn.restype = ctypes.c_int
    dims_c = ctypes.cast((ctypes.c_int * len(dims))(*[int(d) for d in dims]), ctypes.c_void_p)
    out = (ctypes.c_int * 6)()
    if name == "siren_fwd":
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        rc = fn(len(dims) - 1, dims_c, B, P, samples_per_block, ctypes.cast(out, ctypes.c_void_p))
    else:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        rc = fn(len(dims) - 1, dims_c, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{name}_plan failed: cudaError {rc}")
    plan = {"warps_per_block": out[0], "smem_bytes_per_block": out[1], "blocks_per_sm": out[2]}
    if name == "siren_fwd":
        plan.update(instance=out[3], pixels_per_block=out[4], blocks=out[5])
    else:
        plan.update(instance=out[4], dw_acc_in_smem=bool(out[3]))
    return plan


def _check(x: torch.Tensor, theta: torch.Tensor, dims: List[int]) -> None:
    """Shape, type and device checks shared by both wrappers; raises on what
    the kernels do not take."""
    if x.dim() != 3 or theta.dim() != 2:
        raise ValueError(f"x must be (B, P, in) and theta (B, n), got {tuple(x.shape)}, "
                         f"{tuple(theta.shape)}")
    B, P, fin = x.shape
    if fin != dims[0] or theta.shape != (B, theta_size(dims)):
        raise ValueError(f"shapes x {tuple(x.shape)}, theta {tuple(theta.shape)} do not "
                         f"match widths {dims}")
    if x.dtype != torch.float32 or theta.dtype != torch.float32:
        raise TypeError(f"float32 only, got {x.dtype}, {theta.dtype}")
    if x.device != theta.device:
        raise ValueError(f"x on {x.device}, theta on {theta.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        if not (x.is_contiguous() and theta.is_contiguous()):
            raise ValueError("x and theta must be contiguous")
        if len(dims) - 1 > MAX_LAYERS or max(dims) > MAX_WIDTH:
            raise ValueError(f"widths {dims} exceed the kernels' {MAX_LAYERS} layers of "
                             f"at most {MAX_WIDTH}")


def siren_forward(x: torch.Tensor, theta: torch.Tensor, dims: Sequence[int], w0: float,
                  samples_per_block: int = 1) -> torch.Tensor:
    """(B, P, dims[0]) features x per-sample packed weights (B, theta_size)
    -> (B, P, dims[-1]). CUDA tensors go through the kernel; CPU tensors
    through the plain version."""
    dims = [int(d) for d in dims]
    _check(x, theta, dims)
    if x.device.type == "cpu":
        return siren_forward_reference(x, theta, dims, w0)
    B, P, _ = x.shape
    if samples_per_block < 1:
        raise ValueError(f"samples_per_block must be >= 1, got {samples_per_block}")
    y = torch.empty(B, P, dims[-1], device=x.device, dtype=torch.float32)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = kernel_lib("siren_fwd").siren_fwd(
            x.data_ptr(), theta.data_ptr(), y.data_ptr(), B, P, len(dims) - 1,
            ctypes.cast(dims_c, ctypes.c_void_p), theta.shape[1], float(w0),
            int(samples_per_block), instance(dims), stream,
        )
    if rc != 0:
        raise RuntimeError(f"siren_fwd launch failed: cudaError {rc}")
    launches["siren_fwd"] += 1
    return y


def siren_backward(x: torch.Tensor, theta: torch.Tensor, dy: torch.Tensor,
                   dims: Sequence[int], w0: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``siren_forward`` given dy (B, P, dims[-1]): (dx (B, P,
    dims[0]), dtheta (B, theta_size)). CUDA tensors go through the kernel,
    whose dW/db sums run in a fixed order (no atomics), so repeated launches
    on the same inputs are bitwise equal; CPU tensors through the plain
    version."""
    dims = [int(d) for d in dims]
    _check(x, theta, dims)
    B, P, _ = x.shape
    if dy.shape != (B, P, dims[-1]) or dy.dtype != torch.float32 or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} does not match "
                         f"x {tuple(x.shape)} on {x.device} and widths {dims}")
    if x.device.type == "cpu":
        return siren_backward_reference(x, theta, dy, dims, w0)
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous")
    dx = torch.empty_like(x)
    # with no pixels the kernel writes nothing, and dtheta is zero
    dtheta = (torch.zeros_like if P == 0 else torch.empty_like)(theta)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = kernel_lib("siren_bwd").siren_bwd(
            x.data_ptr(), theta.data_ptr(), dy.data_ptr(), dx.data_ptr(), dtheta.data_ptr(),
            B, P, len(dims) - 1, ctypes.cast(dims_c, ctypes.c_void_p), theta.shape[1],
            float(w0), instance(dims), stream,
        )
    if rc != 0:
        raise RuntimeError(f"siren_bwd launch failed: cudaError {rc}")
    launches["siren_bwd"] += 1
    return dx, dtheta


class SirenMLP(torch.autograd.Function):
    """``siren_forward`` with ``siren_backward`` as its gradient: the port's
    counterpart of the JAX package's ``custom_vjp`` pair (``_make_fused``)."""

    @staticmethod
    def forward(ctx, x, theta, dims, w0, samples_per_block=1):
        ctx.save_for_backward(x, theta)
        ctx.dims, ctx.w0 = dims, w0
        return siren_forward(x, theta, dims, w0, samples_per_block)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, theta = ctx.saved_tensors
        dx, dtheta = siren_backward(x, theta, dy.contiguous(), ctx.dims, ctx.w0)
        return dx, dtheta, None, None, None


class ATransform(torch.autograd.Function):
    """``lat @ A_l`` whose latent gradient is one product for every row count:
    ``grad @ A_l^T`` through a contiguous copy of A_l^T, a row-major product
    as the forward is. For ``grad @ A_l.t()`` (a transposed operand) cuBLAS
    picks its kernel by the row count, and on the H100 that kernel's sums at
    1,250 rows differ from those at 2,500 (1,056-wide CIFAR layers); the
    row-major product's do not (PERF.md, scale-out), so a row's gradient does not
    depend on how many rows a data-parallel rank holds. A's gradient is
    autograd's, ``lat^T @ grad``."""

    @staticmethod
    def forward(ctx, lat: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(lat, A)
        return lat @ A

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        lat, A = ctx.saved_tensors
        d_lat = grad @ A.t().contiguous() if ctx.needs_input_grad[0] else None
        d_A = lat.t() @ grad if ctx.needs_input_grad[1] else None
        return d_lat, d_A


def materialize_theta(h_w: torch.Tensor, A: Sequence[torch.Tensor],
                      cfg: ModalityConfig) -> torch.Tensor:
    """A-transform: (B, n_inr_params) latents -> (B, n_inr_params) packed
    per-layer [b, W], the kernel's parameter layout."""
    return torch.cat(
        [ATransform.apply(slice_layer(h_w, li, cfg.cum_param_sizes), A[li])
         for li in range(cfg.n_layers)],
        dim=-1,
    )


def materialize_weights(h_w: torch.Tensor, A: Sequence[torch.Tensor],
                        cfg: ModalityConfig) -> List[torch.Tensor]:
    """A-transform + unpack, as the JAX package's ``materialize_weights``:
    (B, D) latents -> [W_0 (B,in,out), b_0 (B,1,out), ...]."""
    dims = cfg.net_dims
    out = []
    for li in range(cfg.n_layers):
        lat = slice_layer(h_w, li, cfg.cum_param_sizes) @ A[li]
        w, b = latent_to_weights(lat, dims[li], dims[li + 1])
        out += [w, b[:, None, :]]
    return out


def fused_mlp(x: torch.Tensor, wbs: Sequence[torch.Tensor], w0: float,
              samples_per_block: int = 1) -> torch.Tensor:
    """(B, P, in) x per-sample weights [(B,in,out), (B,1,out)] * L -> (B, P, out),
    the forward of the JAX package's ``fused_mlp``."""
    B = x.shape[0]
    dims = [x.shape[-1]] + [w.shape[-1] for w in wbs[::2]]
    theta = torch.cat(
        [t for w, b in zip(wbs[::2], wbs[1::2]) for t in (b.reshape(B, -1), w.reshape(B, -1))],
        dim=-1,
    )
    return SirenMLP.apply(x.contiguous(), theta, dims, w0, samples_per_block)


def inr_forward_fused(x: torch.Tensor, h_w: torch.Tensor, A: Sequence[torch.Tensor],
                      cfg: ModalityConfig, samples_per_block: int = 1) -> torch.Tensor:
    """Counterpart of ``models.inr.inr_forward`` through the kernels:
    x (R, S, P, in), h_w (R, S, D) -> (R, S, P, out), differentiable in x,
    h_w and A (the SIREN chain's gradient through ``siren_backward``)."""
    R, S, P, fin = x.shape
    B = R * S
    theta = materialize_theta(h_w.reshape(B, -1), A, cfg)
    y = SirenMLP.apply(x.reshape(B, P, fin).contiguous(), theta, tuple(cfg.net_dims), cfg.w0,
                       samples_per_block)
    return y.reshape(R, S, P, cfg.output_dim)
