"""The port's SIREN forward against the JAX package's.

The port's plain ``inr_forward`` and its kernel module (``fused_mlp`` /
``inr_forward_fused``, which on CPU tensors run the kernel's plain version)
are held to JAX's einsum ``inr_forward`` and to both Pallas kernels,
``ops/fused_inr.py`` and ``ops/pallas_inr.py``, run in interpret mode.
Tolerance atol 3e-5, rtol 1e-5, as tests/test_pallas_inr.py: f32 sums in a
different order, amplified by w0 = 30 through the sin layers. The cases
cover the widths of every kernel instance: CIFAR's, audio's (32-32-32-32-1)
and video's (34-32-32-32-3) fixed ones, TINY's on the run-time one; and
which instance each config takes is pinned against the C sources' table.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.config import AUDIO, CIFAR, TINY, VIDEO
from recombiner_tpu.models.inr import inr_forward as jax_inr_forward
from recombiner_tpu.ops import fused_inr as jax_fused
from recombiner_tpu.ops import pallas_inr as jax_pallas
from recombiner_tpu_torch.config import CONFIGS, get_config
from recombiner_tpu_torch.models.inr import inr_forward
from recombiner_tpu_torch.ops import fused_inr

TOL = dict(atol=3e-5, rtol=1e-5)


def _inputs(cfg, R, S, P, seed):
    rng = np.random.default_rng(seed)
    A = [rng.uniform(-1.0 / d, 1.0 / d, (d, d)).astype(np.float32)
         for d in cfg.layer_param_counts]
    x = rng.standard_normal((R, S, P, cfg.input_dim)).astype(np.float32)
    h_w = (0.02 * rng.standard_normal((R, S, cfg.n_inr_params))).astype(np.float32)
    return x, h_w, A


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = {
    "tiny": (TINY, 4, 1, 256, 128),
    "cifar": (CIFAR, 2, 2, 1024, 256),
    "odd_p_b3": (TINY, 3, 1, 250, 250),
    "audio": (AUDIO, 2, 2, 160, 80),
    "video": (VIDEO, 2, 1, 192, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_forward_matches_jax_paths(case):
    jcfg, R, S, P, tile_p = CASES[case]
    cfg = get_config(jcfg.name)
    x, h_w, A = _inputs(jcfg, R, S, P, seed=len(case))
    jA = [jnp.asarray(a) for a in A]
    ref = np.asarray(jax_inr_forward(jnp.asarray(x), jnp.asarray(h_w), jA, jcfg))
    fused = np.asarray(jax_fused.inr_forward_fused(
        jnp.asarray(x), jnp.asarray(h_w), jA, jcfg, interpret=True))
    pallas = np.asarray(jax_pallas.inr_forward_fused(
        jnp.asarray(x), jnp.asarray(h_w), jA, jcfg, tile_p=tile_p, interpret=True))

    tx, tA = _t(x, h_w), _t(*A)
    plain = inr_forward(tx[0], tx[1], tA, cfg).numpy()
    kernel_path = fused_inr.inr_forward_fused(tx[0], tx[1], tA, cfg).numpy()
    wbs = fused_inr.materialize_weights(tx[1].reshape(R * S, -1), tA, cfg)
    mlp = fused_inr.fused_mlp(tx[0].reshape(R * S, P, -1), wbs, cfg.w0).numpy()

    for got in (plain, kernel_path, mlp.reshape(plain.shape)):
        for want in (ref, fused, pallas):
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["tiny", "cifar"])
def test_materialize_weights_matches_jax(name):
    jcfg = TINY if name == "tiny" else CIFAR
    cfg = get_config(name)
    _, h_w, A = _inputs(jcfg, 5, 1, 1, seed=3)
    want = jax_fused.materialize_weights(jnp.asarray(h_w[:, 0]), [jnp.asarray(a) for a in A], jcfg)
    got = fused_inr.materialize_weights(torch.from_numpy(h_w[:, 0]), _t(*A), cfg)
    assert len(got) == len(want) == 2 * cfg.n_layers
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-5)
    # the kernel's packed layout is the A-transformed latents, layer after layer
    theta = fused_inr.materialize_theta(torch.from_numpy(h_w[:, 0]), _t(*A), cfg)
    assert theta.shape == (5, fused_inr.theta_size(cfg.net_dims)) == (5, cfg.n_inr_params)


def test_cpu_wrapper_runs_plain_version_without_launching():
    cfg = get_config("tiny")
    x, h_w, A = _inputs(TINY, 2, 1, 64, seed=9)
    before = dict(fused_inr.launches)
    theta = fused_inr.materialize_theta(torch.from_numpy(h_w[:, 0]), _t(*A), cfg)
    y = fused_inr.siren_forward(torch.from_numpy(x[:, 0]), theta, cfg.net_dims, cfg.w0)
    ref = fused_inr.siren_forward_reference(torch.from_numpy(x[:, 0]), theta, cfg.net_dims, cfg.w0)
    torch.testing.assert_close(y, ref, atol=0, rtol=0)
    assert fused_inr.launches == before


@pytest.mark.parametrize("bad", ["width", "theta", "dtype", "rank", "device_mix"])
def test_wrapper_rejects_bad_inputs(bad):
    cfg = get_config("tiny")
    dims = list(cfg.net_dims)
    x = torch.zeros(2, 16, dims[0])
    theta = torch.zeros(2, fused_inr.theta_size(dims))
    err = ValueError
    if bad == "width":
        dims[0] += 1
    elif bad == "theta":
        theta = theta[:, :-1]
    elif bad == "dtype":
        x, err = x.double(), TypeError
    elif bad == "rank":
        x = x[0]
    elif bad == "device_mix":
        theta = theta.to("meta")
    with pytest.raises(err):
        fused_inr.siren_forward(x, theta, dims, cfg.w0)


def _c_instance_table():
    """SIREN_FIXED_INSTANCES of csrc/siren_mma.cuh as width tuples, by id."""
    path = os.path.join(os.path.dirname(fused_inr.__file__), "csrc", "siren_mma.cuh")
    with open(path) as f:
        rows = re.findall(r"^  X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", f.read(), re.M)
    return {int(i): (int(a),) + (int(h),) * (int(L) - 1) + (int(o),) for i, L, a, h, o in rows}


def test_instance_table_is_the_c_sources_table():
    """The wrappers name an instance that the C entry points check against
    their own table; both tables list the same widths under the same ids."""
    c_table = _c_instance_table()
    assert c_table == {i + 1: w for i, w in enumerate(fused_inr.FIXED_WIDTHS)}
    assert fused_inr.RUNTIME_INSTANCE not in c_table


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_each_config_takes_its_kernel_instance(name):
    """Every full-size modality runs on a fixed-width instance of both
    kernels (CIFAR, Kodak, kodak_mini and protein on CIFAR's; audio and
    audio_mini on audio's; video on video's); the TINY configs on the
    run-time one."""
    dims = tuple(get_config(name).net_dims)
    inst = fused_inr.instance(dims)
    if name.startswith("tiny"):
        assert inst == fused_inr.RUNTIME_INSTANCE
    else:
        assert inst != fused_inr.RUNTIME_INSTANCE and _c_instance_table()[inst] == dims
        want = {"audio": 2, "audio_mini": 2, "video": 3}.get(name, 1)
        assert inst == want
