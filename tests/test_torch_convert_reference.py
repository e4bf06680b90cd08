"""The port's reference-pickle converters (``io/convert_reference.py``,
``io/export_reference.py``, ``cli/convert.py``) held to the JAX package's on
the CPU.

Unpickling the reference's checkpoint needs its ``prior_model`` module. The
tests write a stand-in ``prior_model.py`` into a temporary directory: the two
classes the converters use, with the reference's constructor signatures and
attributes (``LinearTransform(dims)`` with ``A`` a ``ParameterList``;
``Upsample(data_dim, paddings, factors)`` with ``conv1..conv3``). So these
tests hold the two packages' converters to each other on the same pickles,
not to the real reference. The cases that need the real reference skip
without it, as ``tests/test_convert_reference.py`` does.

Every comparison is bit for bit: the converters only move and transpose
arrays.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.io.convert_reference import (
    convert_reference_checkpoint as jax_convert_reference_checkpoint,
)
from recombiner_tpu.io.export_reference import (
    export_reference_checkpoint as jax_export_reference_checkpoint,
)
from recombiner_tpu_torch.cli import convert as convert_cli
from recombiner_tpu_torch.coding import decoder
from recombiner_tpu_torch.io import checkpoint
from recombiner_tpu_torch.io.convert_reference import convert_reference_checkpoint
from recombiner_tpu_torch.io.export_reference import export_reference_checkpoint
from recombiner_tpu_torch.models.upsample import apply_upsample

from test_convert_reference import REF  # the reference checkout the JAX package's tests use
from test_torch_encode import _artifacts
from test_torch_patch import FIXTURE

STAND_IN = '''"""A stand-in for the reference's prior_model: the two classes the
checkpoint converters pickle and unpickle, with its constructor signatures
and attributes."""
import torch
from torch import nn

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


class LinearTransform(nn.Module):
    def __init__(self, dims):
        super().__init__()
        counts = [dims[i + 1] * (dims[i] + 1) for i in range(len(dims) - 1)]
        self.A = nn.ParameterList([nn.Parameter(torch.eye(c)) for c in counts])


class Upsample(nn.Module):
    def __init__(self, data_dim, paddings, layerwise_scale_factors):
        super().__init__()
        conv = _CONV[data_dim]
        self.conv1 = conv(128, 64, 5, padding=paddings[0])
        self.conv2 = conv(64, 64, 3, padding=paddings[1])
        self.conv3 = conv(64, 16, 3, padding=paddings[2])
        self.scale_factors = layerwise_scale_factors
'''


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    """A directory holding the stand-in ``prior_model.py``, passed to the
    converters as ``reference_path``."""
    root = tmp_path_factory.mktemp("stand_in_reference")
    (root / "prior_model.py").write_text(STAND_IN)
    yield str(root)
    sys.modules.pop("prior_model", None)


def _jax_artifact(name):
    """A TINY (random) or TINY_PATCH (the fixture prior) artifact of the JAX
    package, and the same as the port's."""
    if name == "tiny":
        return _artifacts()
    return jck.load_prior_artifact(FIXTURE), checkpoint.load_prior_artifact(FIXTURE)


def _assert_artifacts_equal(got, want):
    """Every field of two artifacts of either package, bit for bit (arrays
    as float32 / int32, as the artifact file stores them)."""
    assert got.config.name == want.config.name and got.kl_beta == want.kl_beta
    assert got.codebook_seed == want.codebook_seed
    for name in ("w", "h", "hh"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        for f in ("p_loc", "p_scale", "avg_log_scale"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f), np.float32),
                                          np.asarray(getattr(b, f), np.float32), f"{name}.{f}")
        assert a.grouping.n_groups == b.grouping.n_groups
        for f in ("group_start", "group_end", "group_idx", "param2group", "group2param",
                  "group_kls", "weights"):
            x, y = np.asarray(getattr(a.grouping, f)), np.asarray(getattr(b.grouping, f))
            np.testing.assert_array_equal(x, y, f"{name}.grouping.{f}")
    assert len(got.A) == len(want.A)
    for x, y in zip(got.A, want.A):
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))
    for k in ("conv0", "conv1", "conv2"):
        for f in ("w", "b"):
            x, y = np.asarray(got.up[k][f], np.float32), np.asarray(want.up[k][f], np.float32)
            assert x.shape == y.shape, (k, f)
            np.testing.assert_array_equal(x, y, f"{k}.{f}")


@pytest.mark.parametrize("name", ["tiny", "tiny_patch"])
def test_both_packages_read_one_pickle_to_equal_artifacts(stand_in, name, tmp_path):
    """A pickle the JAX package exported, read by both packages' converters:
    equal artifacts, and equal to the one exported."""
    jart, art = _jax_artifact(name)
    path = str(tmp_path / "PRIOR_ref.pkl")
    jax_export_reference_checkpoint(jart, path, reference_path=stand_in)
    got = convert_reference_checkpoint(path, name, reference_path=stand_in)
    want = jax_convert_reference_checkpoint(path, name, reference_path=stand_in)
    _assert_artifacts_equal(got, want)
    _assert_artifacts_equal(got, art)
    assert stand_in not in sys.path


@pytest.mark.parametrize("name", ["tiny", "tiny_patch"])
@pytest.mark.parametrize("exporter", ["port", "jax"])
def test_export_then_import_across_packages_gives_the_artifact_back(stand_in, name, exporter,
                                                                      tmp_path):
    """The port exports and the JAX package imports, and the reverse: the
    original artifact comes back; both packages write the same pickle's
    contents (the module dumps' tensors equal)."""
    jart, art = _jax_artifact(name)
    path = str(tmp_path / "PRIOR_exported.pkl")
    if exporter == "port":
        export_reference_checkpoint(art, path, reference_path=stand_in)
        back = jax_convert_reference_checkpoint(path, name, reference_path=stand_in)
    else:
        jax_export_reference_checkpoint(jart, path, reference_path=stand_in)
        back = convert_reference_checkpoint(path, name, reference_path=stand_in)
    _assert_artifacts_equal(back, art)
    other = str(tmp_path / "other.pkl")
    if exporter == "port":
        jax_export_reference_checkpoint(jart, other, reference_path=stand_in)
    else:
        export_reference_checkpoint(art, other, reference_path=stand_in)
    sys.path.insert(0, stand_in)
    try:
        dumps = []
        for p in (path, other):
            with open(p, "rb") as f:
                dumps.append([pickle.load(f) for _ in range(8)])
    finally:
        sys.path.remove(stand_in)
    a, b = dumps
    for i in (0, 2, 4):  # the groupings
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for sa, sb in zip(a[6].state_dict().values(), b[6].state_dict().values()):
        assert torch.equal(sa, sb)
    for sa, sb in zip(a[7].state_dict().values(), b[7].state_dict().values()):
        assert torch.equal(sa, sb)


def test_cli_convert_round_trips(stand_in, tmp_path):
    """``cli.convert`` both ways: artifact -> pickle -> artifact -> pickle
    -> artifact keeps the artifact; the JAX package reads the CLI's
    pickle to it too."""
    _, art = _jax_artifact("tiny_patch")
    npz0 = str(tmp_path / "a.npz")
    checkpoint.save_prior_artifact(npz0, art)
    pkl1, npz2, pkl3, npz4 = (str(tmp_path / n) for n in ("b.pkl", "c.npz", "d.pkl", "e.npz"))
    ref = ["--reference_path", stand_in]
    convert_cli.main(["--to_reference", "--artifact", npz0, *ref, "--out", pkl1])
    convert_cli.main(["--pickle", pkl1, "--dataset", "tiny_patch", *ref, "--out", npz2])
    convert_cli.main(["--to_reference", "--artifact", npz2, *ref, "--out", pkl3])
    convert_cli.main(["--pickle", pkl3, "--dataset", "tiny_patch", *ref, "--out", npz4])
    _assert_artifacts_equal(checkpoint.load_prior_artifact(npz4), art)
    _assert_artifacts_equal(jck.load_prior_artifact(npz2), art)
    _assert_artifacts_equal(jax_convert_reference_checkpoint(pkl3, "tiny_patch",
                                                             reference_path=stand_in), art)
    with pytest.raises(SystemExit, match="requires --artifact"):
        convert_cli.main(["--to_reference", "--out", pkl1])
    with pytest.raises(SystemExit, match="requires --pickle and --dataset"):
        convert_cli.main(["--pickle", pkl1, "--out", npz2])


def test_a_converted_artifact_drives_a_tiny_decode(stand_in, tmp_path):
    """The artifact read back from an exported pickle decodes the same
    indices to the same reconstruction as the original, on the CPU."""
    _, art = _jax_artifact("tiny")
    path = str(tmp_path / "PRIOR.pkl")
    export_reference_checkpoint(art, path, reference_path=stand_in)
    back = convert_reference_checkpoint(path, "tiny", reference_path=stand_in)
    cfg = art.config
    rows = 3
    codec = decoder.init_codec(art, rows, device="cpu")[0]
    codec_back = decoder.init_codec(back, rows, device="cpu")[0]
    rng = np.random.default_rng(0)
    idx = {"w": rng.integers(0, 2**cfg.bits_per_group, (rows, codec.w.n_groups))}
    X = rng.normal(0, 1, (rows, cfg.n_pixels, cfg.fourier_dim)).astype(np.float32)
    want = decoder.decode(codec, idx, X, cfg)
    got = decoder.decode(codec_back, idx, X, cfg)
    assert got.shape == (rows, cfg.n_pixels, cfg.output_dim) and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference checkout not available")
def test_the_real_reference_upsample_computes_the_ports_mapping(tmp_path):
    """With the real reference: its own ``Upsample`` module, unpickled from
    the port's export, computes the port's plain conv stack."""
    _, art = _jax_artifact("tiny")
    cfg = art.config
    path = str(tmp_path / "PRIOR.pkl")
    export_reference_checkpoint(art, path, reference_path=REF)
    sys.path.insert(0, REF)
    try:
        with open(path, "rb") as f:
            up_ref = [pickle.load(f) for _ in range(8)][7]
    finally:
        sys.path.remove(REF)
    back = convert_reference_checkpoint(path, "tiny", reference_path=REF)
    _assert_artifacts_equal(back, art)
    up = decoder.init_codec(art, 1, device="cpu")[0].up
    lpe = np.random.default_rng(1).normal(size=(1, 1, 1, 128)).astype(np.float32)
    ours = apply_upsample(up, torch.from_numpy(lpe), cfg.data_dim, cfg.layerwise_scale_factors,
                          cfg.paddings)
    with torch.no_grad():
        theirs = up_ref(torch.from_numpy(lpe).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-5)
