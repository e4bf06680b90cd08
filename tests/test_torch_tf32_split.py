"""The kernels' precision scheme, emulated in numpy on the CPU.

``ops/csrc/siren_mma.cuh`` runs every product of the SIREN chain on the
tensor cores as 3xTF32: each f32 operand v is split as hi = rna(v),
lo = rna(v - hi) (rna: round to TF32, 10 explicit mantissa bits, to nearest,
ties away from zero, as ``cvt.rna.tf32.f32`` does), and a product is summed
as hi*hi into one f32 accumulator and hi*lo + lo*hi into another, added at
the end. Its sines come from a branch-free sincos (Cody-Waite reduction by
pi/2, Cephes' polynomials). The CUDA kernels cannot run here, so this file
runs the CIFAR chain (32-32-32-32-3, w0 = 30, P = 256, inputs at
chip_smoke.py's magnitudes) through the same arithmetic in numpy and holds it
to the plain versions at the card's tolerances: forward atol = rtol = 1e-4,
backward 2e-4 of the largest entry. One TF32 pass misses them, which is why
the kernels take three.
"""

import numpy as np
import pytest
import torch

from recombiner_tpu_torch.config import CIFAR
from recombiner_tpu_torch.ops import fused_inr

ATOL = RTOL = 1e-4  # chip_smoke.py, siren_fwd
BWD_OF_MAX = 2e-4  # chip_smoke.py, siren_bwd
f32 = np.float32


def rna(v):
    """Round f32 to TF32 (10 explicit mantissa bits), ties away from zero."""
    b = np.ascontiguousarray(v, dtype=f32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(f32)


def matmul_tf32(a, b, passes):
    """a @ b (f32, batched) as the kernels compute it: passes = 3 for
    3xTF32 (large and small terms in two f32 sums), 1 for one TF32 pass.
    Each term's products are exact in f32 (11 x 11 bits)."""
    ah, bh = rna(a), rna(b)
    big = np.matmul(ah, bh)
    if passes == 1:
        return big
    al, bl = rna(a - ah), rna(b - bh)
    return big + (np.matmul(al, bh) + np.matmul(ah, bl))


def fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def sincos(x):
    """siren_mma.cuh::sincos_fast in numpy (fma emulated through f64)."""
    x = np.asarray(x, f32)
    j = np.rint(x * f32(0.636619772)).astype(f32)
    r = fma(j, f32(-1.57079637e+00), x)
    r = fma(j, f32(4.37113883e-08), r)
    r = fma(j, f32(1.77635684e-15), r)
    z = (r * r).astype(f32)
    ps = fma(z, f32(-1.9515295891e-4), f32(8.3321608736e-3))
    ps = fma(z, ps, f32(-1.6666654611e-1))
    s = fma(r, (ps * z).astype(f32), r)
    pc = fma(z, f32(2.443315711809948e-5), f32(-1.388731625493765e-3))
    pc = fma(z, pc, f32(4.166664568298827e-2))
    pc = fma(z, pc, f32(-0.5))
    c = fma(z, pc, f32(1.0))
    q = j.astype(np.int64)
    sv, cv = np.where(q & 1, c, s), np.where(q & 1, s, c)
    return np.where(q & 2, -sv, sv), np.where((q + 1) & 2, -cv, cv)


def unpack(theta, dims):
    out, off = [], 0
    for i, o in zip(dims[:-1], dims[1:]):
        b = theta[:, off:off + o]
        w = theta[:, off + o:off + o * (i + 1)].reshape(-1, i, o)
        out.append((w, b[:, None, :]))
        off += o * (i + 1)
    return out


def forward(x, theta, dims, w0, passes):
    """The forward as siren_fwd.cu computes it: (y, [a_l], [w0 cos])."""
    layers = unpack(theta, dims)
    a, acts, coss = x, [x], []
    for li, (w, b) in enumerate(layers):
        z = (matmul_tf32(a, w, passes) + b).astype(f32)
        if li == len(layers) - 1:
            return z, acts, coss
        s, c = sincos((f32(w0) * z).astype(f32))
        a = s
        acts.append(s)
        coss.append((f32(w0) * c).astype(f32))


def backward(x, theta, dy, dims, w0, passes):
    """The backward as siren_bwd.cu computes it: (dx, dtheta)."""
    layers = unpack(theta, dims)
    _, acts, coss = forward(x, theta, dims, w0, passes)
    dz, grads = dy, []
    for li in range(len(layers) - 1, -1, -1):
        w, _ = layers[li]
        dw = matmul_tf32(acts[li].transpose(0, 2, 1), dz, passes)
        grads.append(np.concatenate([dz.sum(1), dw.reshape(len(x), -1)], axis=1))
        da = matmul_tf32(dz, w.transpose(0, 2, 1), passes)
        if li > 0:
            dz = (da * coss[li - 1]).astype(f32)
    return da, np.concatenate(grads[::-1], axis=1).astype(f32)


@pytest.fixture(scope="module")
def cifar():
    """x, theta, dy at chip_smoke.py's magnitudes: x ~ N(0, 1); theta from a
    prior-like h_w (loc ~ N(0, 0.01), scale log-uniform in [0.0025, 0.05])
    through uniform(-0.1, 0.1) A-transforms; dy ~ N(0, 1)."""
    cfg = CIFAR
    rng = np.random.default_rng(0)
    B, P = 2, 256
    n = cfg.n_inr_params
    loc = rng.normal(0.0, 0.01, n)
    scale = np.exp(rng.uniform(np.log(0.0025), np.log(0.05), n))
    h_w = (loc + scale * rng.standard_normal((B, n))).astype(f32)
    A = [rng.uniform(-0.1, 0.1, (d, d)).astype(f32) for d in cfg.layer_param_counts]
    theta = fused_inr.materialize_theta(torch.from_numpy(h_w), [torch.from_numpy(a) for a in A],
                                        cfg).numpy()
    x = rng.standard_normal((B, P, cfg.input_dim)).astype(f32)
    dy = rng.standard_normal((B, P, cfg.output_dim)).astype(f32)
    return x, theta, dy, list(cfg.net_dims), cfg.w0


def test_rna_rounds_to_nearest_ties_away():
    one = f32(1.0)
    ulp = f32(2.0 ** -10)  # TF32 spacing at 1
    v = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23, 1 + 3 * 2.0 ** -11,
                  -(1 + 2.0 ** -11), 1.0], f32)
    np.testing.assert_array_equal(rna(v), np.array([one + ulp, one, one + 2 * ulp,
                                                    -(one + ulp), one], f32))
    x = np.random.default_rng(1).standard_normal(10_000).astype(f32)
    np.testing.assert_array_equal(rna(x).view(np.uint32) & 0x1FFF, 0)
    assert np.abs(rna(x) - x).max() <= np.abs(x).max() * 2.0 ** -11


@pytest.mark.parametrize("limit", [1.0, 100.0, 1e5])
def test_sincos_is_as_accurate_as_f32_sin(limit):
    """Within 7.5e-8 of sin and cos over the kernels' fast range: as the f32
    library sine (numpy's reaches 7.0e-8 on the same points)."""
    x = np.random.default_rng(2).uniform(-limit, limit, 200_000).astype(f32)
    s, c = sincos(x)
    assert np.abs(s - np.sin(np.float64(x))).max() < 7.5e-8
    assert np.abs(c - np.cos(np.float64(x))).max() < 7.5e-8


@pytest.mark.parametrize("passes,holds", [(3, True), (1, False)])
def test_forward_at_the_cards_tolerance(cifar, passes, holds):
    x, theta, _, dims, w0 = cifar
    y = forward(x, theta, dims, w0, passes)[0]
    ref = fused_inr.siren_forward_reference(torch.from_numpy(x), torch.from_numpy(theta), dims,
                                            w0).numpy()
    within = np.all(np.abs(y - ref) <= ATOL + RTOL * np.abs(ref))
    assert within == holds, f"max abs diff {np.abs(y - ref).max():.3e}"


@pytest.mark.parametrize("passes,holds", [(3, True), (1, False)])
def test_backward_at_the_cards_tolerance(cifar, passes, holds):
    x, theta, dy, dims, w0 = cifar
    dx, dtheta = backward(x, theta, dy, dims, w0, passes)
    rdx, rdtheta = fused_inr.siren_backward_reference(
        torch.from_numpy(x), torch.from_numpy(theta), torch.from_numpy(dy), dims, w0)
    rel = [np.abs(got - want.numpy()).max() / np.abs(want.numpy()).max()
           for got, want in ((dx, rdx), (dtheta, rdtheta))]
    assert (max(rel) <= BWD_OF_MAX) == holds, f"dx, dtheta: {rel} of the largest entry"
