"""The port's decode slice against the JAX package's, end to end on the CPU.

Decode is deterministic given the indices (every cell frozen, zero scale),
so the two packages agree up to f32 rounding. Tolerance atol 3e-5, rtol
1e-5, that of the kernel tests: the same SIREN chain, plus the codebook's
<= 3 ulp (tests/test_torch_codebook.py) on about 1% of entries.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recombiner_tpu.coding.encoder import decode as jax_decode
from recombiner_tpu.coding.encoder import decode_level_values as jax_decode_level_values
from recombiner_tpu.coding.encoder import init_codec as jax_init_codec
from recombiner_tpu.config import TINY
from recombiner_tpu.coords import grid_fourier_features as jax_grid_fourier_features
from recombiner_tpu.io import bitstream as jax_bitstream
from recombiner_tpu.io import checkpoint as jax_ckpt
from recombiner_tpu.priors.grouping import compute_grouping as jax_compute_grouping
from recombiner_tpu_torch.cli import decompress
from recombiner_tpu_torch.coding import decoder
from recombiner_tpu_torch.config import TINY_PATCH
from recombiner_tpu_torch.coords import grid_fourier_features
from recombiner_tpu_torch.device import resolve_device
from recombiner_tpu_torch.io import bitstream, checkpoint

CIFAR_PRIOR = "docs/schedule_priors/PRIOR_rd_cifar_bitrate=2.npz"
TINY_PATCH_PRIOR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                                "tiny_patch_prior.npz")
TOL = dict(atol=3e-5, rtol=1e-5)


def _features(cfg, R):
    feats = grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)
    np.testing.assert_array_equal(feats, jax_grid_fourier_features(cfg.pixel_sizes,
                                                                   cfg.fourier_dim))
    return np.ascontiguousarray(np.broadcast_to(feats, (R, *feats.shape)))


@pytest.fixture(scope="module")
def cifar():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), CIFAR_PRIOR)
    jart = jax_ckpt.load_prior_artifact(path)
    art = checkpoint.load_prior_artifact(path)
    R = 8
    rng = np.random.default_rng(0)
    idx = {"w": rng.integers(0, 2**16, (R, art.w.grouping.n_groups)).astype(np.int32)}
    jcodec, _ = jax_init_codec(jart, R)
    codec, state = decoder.init_codec(art, R, device="cpu")
    return jart, art, idx, jcodec, codec, state


def test_cifar_prior_loads_alike(cifar):
    jart, art, *_ = cifar
    assert art.config.name == jart.config.name == "cifar"
    assert art.codebook_seed == jart.codebook_seed and art.codebook_kind == jart.codebook_kind
    np.testing.assert_array_equal(art.w.p_loc, jart.w.p_loc)
    np.testing.assert_array_equal(art.w.grouping.param2group, jart.w.grouping.param2group)
    for a, b in zip(art.A, jart.A):
        np.testing.assert_array_equal(a, b)


def test_cifar_init_codec_matches_jax(cifar):
    _, _, _, jcodec, codec, state = cifar
    for f in ("D", "Dpad", "Gmax", "n_groups"):
        assert getattr(codec.w, f) == getattr(jcodec.w, f)
    for f in ("p_loc", "p_scale", "group_start", "group_size", "group_idx", "group2param"):
        np.testing.assert_array_equal(getattr(codec.w, f).numpy(), np.asarray(getattr(jcodec.w, f)))
    assert state.w.q.loc.shape == (8, codec.w.D)
    assert not state.w.compressed.any()


def test_cifar_decode_level_values_match_jax(cifar):
    _, _, idx, jcodec, codec, _ = cifar
    want = np.asarray(jax_decode_level_values(jcodec.w, jnp.asarray(idx["w"])))
    got = decoder.decode_level_values(codec.w, torch.from_numpy(idx["w"]).long()).numpy()
    # p_loc + p_scale * eps with eps within 3 ulp; |values| < 1
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cifar_decode_matches_jax(cifar):
    jart, art, idx, jcodec, codec, _ = cifar
    cfg = art.config
    X = _features(cfg, 8)
    want = np.asarray(jax_decode(jcodec, idx, jnp.asarray(X), jart.config))
    got = decoder.decode(codec, idx, X, cfg).numpy()
    assert got.shape == (8, cfg.n_pixels, cfg.output_dim) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_out_of_range_indices_raise(cifar):
    art, codec = cifar[1], cifar[4]
    bad = {"w": np.full((1, codec.w.n_groups), 2**16)}
    with pytest.raises(ValueError):
        decoder.decode(codec, bad, _features(art.config, 1), art.config)


def _tiny_artifact(kind: str, seed: int = 5):
    """A TINY prior built with the JAX package's classes from numpy values."""
    cfg = TINY
    rng = np.random.default_rng(seed)
    D = cfg.n_coded_params
    level = jax_ckpt.LevelArtifact(
        p_loc=rng.normal(0, 0.02, D).astype(np.float32),
        p_scale=rng.uniform(0.005, 0.05, D).astype(np.float32),
        avg_log_scale=rng.normal(-4, 0.1, D).astype(np.float32),
        grouping=jax_compute_grouping(rng.exponential(0.5, D), max_bits=cfg.bits_per_group),
    )
    A = [rng.uniform(-0.1, 0.1, (d, d)).astype(np.float32) for d in cfg.layer_param_counts]
    up = {}
    for i, (cin, cout, k) in enumerate([(128, 64, 5), (64, 64, 3), (64, 16, 3)]):
        b = 1 / np.sqrt(cin * k * k)
        up[f"conv{i}"] = {"w": rng.uniform(-b, b, (k, k, cin, cout)).astype(np.float32),
                          "b": rng.uniform(-b, b, cout).astype(np.float32)}
    return jax_ckpt.PriorArtifact(config=cfg, kl_beta=1e-3, w=level, h=None, hh=None, A=A,
                                  up=up, codebook_seed=42, codebook_kind=kind)


@pytest.mark.parametrize("kind", ["threefry", "sobol"])
def test_cli_decompress_decodes_jax_bitstream(kind, tmp_path):
    """A prior and a bitstream written by the JAX package, decoded by the
    port's CLI with --device cpu, against the JAX package's decode."""
    jart = _tiny_artifact(kind)
    prior = str(tmp_path / "prior.npz")
    jax_ckpt.save_prior_artifact(prior, jart)
    R = 3
    idx = {"w": np.random.default_rng(1).integers(0, 2**TINY.bits_per_group,
                                                   (R, jart.w.grouping.n_groups))}
    stream = str(tmp_path / "bitstream_test_id_0.rctb")
    jax_bitstream.write_bitstream(stream, idx, config_name="tiny", codebook_seed=42,
                                  bits_per_group=TINY.bits_per_group, codebook_kind=kind)
    y = decompress.main(["--bitstream", stream, "--prior_path", prior,
                         "--save_dir", str(tmp_path / "out"), "--device", "cpu"])
    saved = np.load(tmp_path / "out" / "bitstream_test_id_0_decoded.npy")
    np.testing.assert_array_equal(saved, y)

    jcodec, _ = jax_init_codec(jart, R, codebook_kind=kind)
    want = np.asarray(jax_decode(jcodec, idx, jnp.asarray(_features(TINY, R)), TINY))
    np.testing.assert_allclose(y, want, **TOL)


def test_bitstream_bytes_equal_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    idx = {"w": rng.integers(0, 2**16, (5, 7)).astype(np.int32)}
    kw = dict(config_name="cifar", codebook_seed=42, bits_per_group=16, codebook_kind="threefry")
    blob_j = jax_bitstream.pack_bitstream(idx, **kw)
    blob_t = bitstream.pack_bitstream(idx, **kw)
    assert blob_j == blob_t
    pj, pt = tmp_path / "j.rctb", tmp_path / "t.rctb"
    jax_bitstream.write_bitstream(str(pj), idx, **kw)
    bitstream.write_bitstream(str(pt), idx, **kw)
    assert pj.read_bytes() == pt.read_bytes()
    for reader, path in ((bitstream.read_bitstream, pj), (jax_bitstream.read_bitstream, pt)):
        header, out = reader(str(path))
        assert header["config"] == "cifar"
        np.testing.assert_array_equal(out["w"], idx["w"])
    with pytest.raises(ValueError):
        bitstream.pack_bitstream({"w": np.array([[2**16]])}, **kw)
    with pytest.raises(ValueError):
        bitstream.unpack_bitstream(blob_t[:-1] + bytes([blob_t[-1] ^ 1]))


def test_artifact_round_trips_between_packages(tmp_path):
    jart = _tiny_artifact("threefry")
    p1, p2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    jax_ckpt.save_prior_artifact(p1, jart)
    art = checkpoint.load_prior_artifact(p1)
    checkpoint.save_prior_artifact(p2, art)
    back = jax_ckpt.load_prior_artifact(p2)
    assert back.config == jart.config
    assert jax_ckpt.prior_fingerprint(back) == jax_ckpt.prior_fingerprint(jart)


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    """A patch prior (it raised here before the patch slice) builds its three
    levels on the CPU when asked for, and needs a card otherwise, as a
    non-patch prior does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = checkpoint.load_prior_artifact(TINY_PATCH_PRIOR)
    assert art.config == TINY_PATCH
    codec, state = decoder.init_codec(art, 4, device="cpu")
    assert codec.level_names == ("w", "h", "hh") and codec.device == torch.device("cpu")
    assert [state.level(n).q.loc.shape[0] for n in codec.level_names] == [4, 2, 1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decoder.init_codec(art, 4)
    jart = _tiny_artifact("threefry")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decoder.init_codec(jart, 2)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
