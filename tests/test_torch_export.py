"""The port's data modules for audio, video and protein (loaders,
preprocessors, synthetic generators), its media export and the CLIs on
those datasets, against the JAX package's, on the CPU.

Tolerances: loaded and preprocessed data, synthetic draws and exported
files equal (PNG pixels equal as PIL reads them; WAV, PDB bytes equal; NPZ
arrays equal); a WAV read back within 1/32767 of the clip it was written
from; PDB coordinates within 5e-4 A (they are printed to 1e-3 A); the
distortion a CLI encode reports equal to the JAX package's metric of its
reconstruction.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from recombiner_tpu.config import get_config as jax_get_config
from recombiner_tpu.data import audio as jaudio
from recombiner_tpu.data import export as jexport
from recombiner_tpu.data import load_data as jload
from recombiner_tpu.data import protein as jprotein
from recombiner_tpu.data import synthetic as jsynth
from recombiner_tpu.data import video as jvideo
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.metrics import metric as jax_metric
from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.cli import decompress as decompress_cli
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.data import audio, export, load_data, protein, synthetic, video
from recombiner_tpu_torch.coding.decoder import init_codec
from recombiner_tpu_torch.io import bitstream, checkpoint
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_modalities import PRIORS, _random_prior

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PATCH_PRIOR = os.path.join(ROOT, "tests", "fixtures", "tiny_patch_prior.npz")


def _assert_lists_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- loaders

# per modality: the port's and the JAX package's modules, a channel-last
# item, and the reference's pickled (channel-first) layout of it
MODULES = {"audio": (audio, jaudio), "video": (video, jvideo), "protein": (protein, jprotein)}


def _items(kind, rng, n=2):
    if kind == "audio":
        return [rng.uniform(0, 1, 48000).astype(np.float32) for _ in range(n)]
    if kind == "video":
        return [rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32) for _ in range(n)]
    return [synthetic.protein_backbone(rng, 96) for _ in range(n)]


def _reference_layout(kind, item):
    if kind == "audio":
        return torch.from_numpy(item[None])  # (1, 48000)
    if kind == "video":
        return torch.from_numpy(np.moveaxis(item, -1, 1).copy())  # (T, C, H, W)
    return torch.from_numpy(item.T.copy())  # (3, 96)


@pytest.mark.parametrize("fmt", ["npz", "pkl"])
@pytest.mark.parametrize("kind", list(MODULES))
def test_clip_and_chain_lists_load_alike(kind, fmt, tmp_path):
    port, jax_mod = MODULES[kind]
    items = _items(kind, np.random.default_rng(0))
    path = str(tmp_path / f"test_dataset.{fmt}")
    if fmt == "npz":
        np.savez(path, *items)
    else:
        with open(path, "wb") as f:
            pickle.dump([_reference_layout(kind, it) for it in items], f)
    load = {"protein": "load_chain_list"}.get(kind, "load_clip_list")
    got, want = getattr(port, load)(path), getattr(jax_mod, load)(path)
    _assert_lists_equal(got, want)
    _assert_lists_equal(got, items)


@pytest.mark.parametrize("fmt", ["npz", "pkl"])
@pytest.mark.parametrize("name", ["audio", "video", "protein"])
def test_load_test_set_matches_jax(name, fmt, tmp_path):
    """``load_test_set``'s branches: the ``test_dataset`` file (``.npz``,
    else ``.pkl``) sliced by the reference's test batches (one clip, 1,000
    chains), as points."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    rng = np.random.default_rng(1)
    if name == "video":
        items = [rng.uniform(0, 1, (24, 128, 128, 3)).astype(np.float32) for _ in range(2)]
    else:
        items = _items(name, rng, 3)
    if fmt == "npz":
        np.savez(str(tmp_path / "test_dataset.npz"), *items)
    else:
        with open(tmp_path / "test_dataset.pkl", "wb") as f:
            pickle.dump([_reference_layout(name, it) for it in items], f)
    test_idx = 0 if name == "protein" else 1
    X, Y = load_data.load_test_set(str(tmp_path), test_idx, cfg)
    jX, jY = jload.load_test_set(str(tmp_path), test_idx, jcfg)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(Y, jY)
    rows = {"audio": 60, "video": 64, "protein": 3}[name]
    assert X.shape == (rows, cfg.n_pixels, cfg.fourier_dim) and Y.shape[0] == rows


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32"])
def test_load_wav_clip_matches_jax(dtype, tmp_path):
    """An 8-bit (unsigned), a 16-bit and a float WAV, full scale included,
    as TINY_AUDIO and AUDIO encode targets."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, 48000 + 7)
    x[:2] = (-1.0, 1.0)
    data = {"uint8": np.round(128 + 127.5 * x).clip(0, 255).astype(np.uint8),
            "int16": np.round(32767 * x).astype(np.int16),
            "float32": x.astype(np.float32)}[dtype]
    path = str(tmp_path / "clip.wav")
    wavfile.write(path, 16000, data)
    for name in ("tiny_audio", "audio"):
        X, Y = audio.load_wav_clip(path, get_config(name))
        jX, jY = jaudio.load_wav_clip(path, jax_get_config(name))
        np.testing.assert_array_equal(X, jX)
        np.testing.assert_array_equal(Y, jY)
    wavfile.write(path, 8000, data)
    with pytest.raises(ValueError, match="sample rate"):
        audio.load_wav_clip(path, get_config("audio"))


def test_parse_pdb_ca_matches_jax(tmp_path):
    """A written backbone with other atoms and records between its CA lines;
    a short chain gives None and a missing file raises in both packages."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "chain.pdb")
    export.write_pdb(path, synthetic.protein_backbone(rng, 120))
    lines = open(path).read().splitlines()
    noisy = []
    for i, line in enumerate(lines):
        noisy.append(line)
        if i % 7 == 0:
            noisy.append(line.replace(" CA ", " CB "))
            noisy.append("HETATM    1  O   HOH A   1       1.000   2.000   3.000  1.00  0.00")
    with open(path, "w") as f:
        f.write("\n".join(noisy) + "\n")
    got = protein.parse_pdb_ca(path)
    assert got.shape == (96, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jprotein.parse_pdb_ca(path))
    np.testing.assert_array_equal(got, jprotein._parse_pdb_ca_py(path))
    short = str(tmp_path / "short.pdb")
    export.write_pdb(short, synthetic.protein_backbone(rng, 50))
    assert protein.parse_pdb_ca(short) is None and jprotein.parse_pdb_ca(short) is None
    for parse in (protein.parse_pdb_ca, jprotein._parse_pdb_ca_py):
        with pytest.raises(FileNotFoundError):
            parse(str(tmp_path / "missing.pdb"))
    np.testing.assert_array_equal(protein.normalize_backbone(got),
                                  jprotein.normalize_backbone(got))


def test_preprocessors_match_jax():
    rng = np.random.default_rng(4)
    wav = rng.uniform(-1, 1, 48100).astype(np.float32)
    np.testing.assert_array_equal(audio.preprocess_clip(wav), jaudio.preprocess_clip(wav))
    assert audio.preprocess_clip(wav[:47999]) is None
    frames = rng.integers(0, 256, (26, 250, 262, 3), dtype=np.uint8)
    got = video.preprocess_clip(frames)
    assert got.shape == (24, 128, 128, 3)
    np.testing.assert_array_equal(got, jvideo.preprocess_clip(frames))
    assert video.preprocess_clip(frames[:, :200]) is None


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_offline_preprocessors_write_what_jax_writes(tmp_path):
    """The injected-corpus paths: the audio selection and dump, the video
    crop/resize/dump with a decoder stand-in, the protein parse/dump; each
    package's dumps load to equal arrays."""
    def corpus_fn(url):
        rng = np.random.default_rng(5 if url == "test-clean" else 6)
        clips = [rng.uniform(-1, 1, 48000 + 100).astype(np.float32)
                 for _ in range(3 if url == "test-clean" else 5)]
        if url == "test-clean":
            clips[1] = clips[1][:24000]
        return clips

    rng = np.random.default_rng(7)
    fake = {"a.avi": rng.integers(0, 256, (30, 250, 320, 3), dtype=np.uint8),
            "b.avi": rng.integers(0, 256, (24, 240, 240, 3), dtype=np.uint8),
            "small.avi": rng.integers(0, 256, (24, 100, 100, 3), dtype=np.uint8)}
    pdbs = []
    for i, n in enumerate((100, 60, 96)):
        pdbs.append(str(tmp_path / f"{i}.pdb"))
        export.write_pdb(pdbs[-1], synthetic.protein_backbone(rng, n))
    dirs = {}
    for who, (a, v, p) in (("port", (audio, video, protein)),
                           ("jax", (jaudio, jvideo, jprotein))):
        for kind in ("audio", "video", "protein"):
            d = tmp_path / who / kind
            d.mkdir(parents=True)
            dirs[who, kind] = str(d)
        a.process_audio_datasets(dirs[who, "audio"], corpus_fn=corpus_fn)
        v.process_video_datasets(["a.avi", "small.avi"], ["b.avi"], dirs[who, "video"],
                                 decode_fn=lambda path: fake[path])
        p.process_protein_datasets(pdbs[:2], pdbs[1:], dirs[who, "protein"])
    for kind, n_test, n_train in (("audio", 2, 5), ("video", 1, 1), ("protein", 1, 1)):
        port, _ = MODULES[kind]
        load = {"protein": "load_chain_list"}.get(kind, "load_clip_list")
        for split, n in (("test", n_test), ("train", n_train)):
            got = getattr(port, load)(os.path.join(dirs["port", kind], f"{split}_dataset.npz"))
            want = getattr(port, load)(os.path.join(dirs["jax", kind], f"{split}_dataset.npz"))
            assert len(got) == n, (kind, split)
            _assert_lists_equal(got, want)


def test_synthetic_generators_equal_for_a_seed():
    for seed in (0, 3):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for spatial, c in (((32, 32), 3), ((4, 8, 8), 3), ((3200,), 1)):
            np.testing.assert_array_equal(synthetic.smooth_signal(rng, spatial, c),
                                          jsynth.smooth_signal(jrng, spatial, c))
        for n in (48000, 256):
            np.testing.assert_array_equal(synthetic.speech_like_clip(rng, n),
                                          jsynth.speech_like_clip(jrng, n))
        np.testing.assert_array_equal(synthetic.protein_backbone(rng, 96),
                                      jsynth.protein_backbone(jrng, 96))
    for name, kind in (("tiny_audio", "speech"), ("audio_mini", "speech"), ("protein", "backbone"),
                       ("tiny_video", "smooth"), ("tiny_patch", "smooth")):
        got = synthetic.synthetic_dataset(get_config(name), 2, seed=9, kind=kind)
        want = jsynth.synthetic_dataset(jax_get_config(name), 2, seed=9, kind=kind)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="backbone"):
        synthetic.synthetic_dataset(get_config("tiny"), 1, kind="backbone")


# -------------------------------------------------------------- export


@pytest.mark.parametrize("name,ext", [("tiny", "png"), ("tiny_patch", "png"),
                                      ("tiny_audio", "wav"), ("audio", "wav"),
                                      ("tiny_video", "npz"), ("protein", "pdb")])
def test_export_reconstructions_matches_jax(name, ext, tmp_path):
    """Both packages' ``export_reconstructions`` of one decoded batch (values
    a little outside [0, 1] too), file for file: the same names, WAV and PDB
    bytes equal, NPZ arrays equal, PNG pixels equal as PIL reads them."""
    from PIL import Image

    cfg = get_config(name)
    rows = 2 * cfg.patches_per_datapoint
    y = np.random.default_rng(10).uniform(-0.05, 1.05, (rows, cfg.n_pixels, cfg.output_dim))
    y = y.astype(np.float32)
    got = export.export_reconstructions(y, cfg, str(tmp_path / "port"), stem="s")
    want = jexport.export_reconstructions(y, jax_get_config(name), str(tmp_path / "jax"),
                                          stem="s")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        f"s_{i}.{ext}" for i in range(2)]
    for a, b in zip(got, want):
        if ext == "png":
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        elif ext == "npz":
            with np.load(a) as za, np.load(b) as zb:
                np.testing.assert_array_equal(za["data"], zb["data"])
        else:
            assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(export.reassemble(y, cfg), jexport.reassemble(
        y, jax_get_config(name)))


@pytest.mark.parametrize("channels", [1, 3])
def test_png_writer_needs_no_pil(channels, tmp_path, monkeypatch):
    """Written with PIL blocked, read back with it: the codec's 8-bit
    rounding of the clipped image, pixel for pixel."""
    from PIL import Image

    img = np.random.default_rng(11).uniform(-0.1, 1.1, (5, 7, channels)).astype(np.float32)
    path = str(tmp_path / "a.png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    export.write_png(path, img)
    monkeypatch.undo()
    back = np.asarray(Image.open(path))
    want = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(back, want[..., 0] if channels == 1 else want)


def test_wav_round_trip(tmp_path):
    clip = np.random.default_rng(12).uniform(0, 1, 48000).astype(np.float32)
    path = str(tmp_path / "a.wav")
    export.write_wav(path, clip)
    back = export.read_wav(path)
    np.testing.assert_allclose(back, clip, atol=1 / 32767)
    np.testing.assert_array_equal(back, jexport.read_wav(path))


# ----------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """A test batch per modality, each with its prior: one AUDIO clip on a
    random AUDIO prior (its KLs drawn small, so that its levels have 57 /
    21 / 21 groups); three protein chains on the committed protein prior;
    one 4 x 16 x 16 clip on a random prior of TINY_VIDEO's geometry named
    'video', which takes the CLI's video branches on a small clip (full
    VIDEO geometry is decoded against the JAX package in
    ``test_torch_modalities.py`` and encoded on the card by
    ``chip_smoke.py``)."""
    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(13)
    out = {}
    for name in ("audio", "video", "protein"):
        d = root / name
        d.mkdir()
        if name == "audio":
            prior = _random_prior(str(root / "audio.npz"), "audio", 14, kl_mean=0.1)
            items = [synthetic.speech_like_clip(rng, 48000)[:, 0]]
        elif name == "video":
            jcfg = dataclasses.replace(jax_get_config("tiny_video"), name="video")
            prior = _random_prior(str(root / "video.npz"), "tiny_video", 15, jcfg=jcfg)
            items = [synthetic.smooth_signal(rng, (4, 16, 16), 3)]
        else:
            prior = PRIORS["protein"]
            items = [synthetic.protein_backbone(rng, 96) for _ in range(3)]
        np.savez(str(d / "test_dataset.npz"), *items)
        out[name] = (str(d), prior)
    return out


@pytest.mark.parametrize("name,ext,rows", [("audio", "wav", 60), ("video", "npz", 4),
                                          ("protein", "pdb", 3)])
def test_cli_encodes_a_test_batch_and_exports_it_without_pil(cli_data, name, ext, rows,
                                                             tmp_path, monkeypatch):
    """``cli.compress`` on the batch (cut depth), then ``cli.decompress
    --export_media``, PIL blocked throughout: the distortion it reports is
    the JAX package's metric of its reconstruction (unrounded PSNR for
    audio, RMSD x 25 per chain for protein); the decoded rows equal the
    encode's; each exported file reads back (WAV within 1/32767 of the
    decode clipped to [0, 1], the video NPZ exactly, PDB coordinates within
    5e-4 A)."""
    test_dir, prior = cli_data[name]
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = tmp_path / "out"
    res = compress_cli.main(["--test_dir", test_dir, "--test_idx", "0", "--prior_path", prior,
                             "--save_dir", str(out), "--device", "cpu", "--sample_size", "1",
                             "--n_epochs", "2", "--finetune_epochs",
                             "0" if name == "audio" else "1"])
    cfg = checkpoint.load_prior_artifact(prior).config
    _, Y = load_data.load_test_set(test_dir, 0, cfg)
    assert res.reconstruction.shape == (rows, *Y.shape[1:])
    want = jax_metric(Y, res.reconstruction, name)
    np.testing.assert_array_equal(np.asarray(res.distortion), np.asarray(want))
    np.testing.assert_allclose(np.loadtxt(out / "Distortion_test_id_0.csv", delimiter=","),
                               np.asarray(want), rtol=1e-7)
    path = str(out / "bitstream_test_id_0.rctb")
    assert bitstream.read_bitstream(path)[0]["config"] == name
    y = decompress_cli.main(["--bitstream", path, "--prior_path", prior, "--save_dir", str(out),
                             "--device", "cpu", "--export_media"])
    np.testing.assert_array_equal(y, res.reconstruction)
    data = export.reassemble(y, cfg)
    files = sorted(f for f in os.listdir(out) if f.endswith("." + ext))
    assert files == [f"bitstream_test_id_0_{i}.{ext}" for i in range(len(data))]
    for f, datum in zip(files, data):
        p = str(out / f)
        if ext == "wav":
            np.testing.assert_allclose(export.read_wav(p), np.clip(datum[:, 0], 0, 1),
                                       atol=1 / 32767)
        elif ext == "npz":
            with np.load(p) as z:
                np.testing.assert_array_equal(z["data"], datum)
        else:
            np.testing.assert_allclose(protein.parse_pdb_ca(p), datum * protein.SCALE, atol=5e-4)


def test_decompress_writes_pngs_without_pil(tmp_path, monkeypatch):
    """A TINY_PATCH bitstream of random indices (two images of 2 x 2
    patches) decoded with ``--export_media`` while PIL is blocked: two
    PNGs, pixel for pixel the JAX package's export of the same decode."""
    from PIL import Image

    art = jck.load_prior_artifact(TINY_PATCH_PRIOR)
    codec = init_codec(checkpoint.load_prior_artifact(TINY_PATCH_PRIOR), 8, device="cpu")[0]
    rng = np.random.default_rng(16)
    idx = {n: rng.integers(0, 256, (r, codec.meta(n).n_groups)).astype(np.int32)
           for n, r in (("w", 8), ("h", 4), ("hh", 2))}
    path = str(tmp_path / "bitstream_test_id_0.rctb")
    bitstream.write_bitstream(path, idx, config_name="tiny_patch",
                              codebook_seed=art.codebook_seed, bits_per_group=8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    y = decompress_cli.main(["--bitstream", path, "--prior_path", TINY_PATCH_PRIOR,
                             "--save_dir", str(tmp_path / "out"), "--device", "cpu",
                             "--export_media"])
    monkeypatch.undo()
    want = jexport.export_reconstructions(y, art.config, str(tmp_path / "jax"),
                                          stem="bitstream_test_id_0")
    for p in want:
        got = tmp_path / "out" / os.path.basename(p)
        np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(p)))
    assert len(want) == 2

