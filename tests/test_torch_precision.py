"""The port's precision modes (``--precision``) against the JAX package's,
on the CPU.

On an NVIDIA card the port's two levels are TF32 (``allow_tf32`` on in
cuBLAS and cuDNN) and exact f32 (both off); its ambient is TF32 unless
``--precision highest``. The flags are readable on a CPU build, so these
tests record both flags at every product (matmul, bmm, einsum, conv) of
phase 1, the coding finetunes, the A* scoring, ``decode`` and a training
epoch, with the recorder ``chip_smoke.py`` uses on the card
(``FlagRecorder``), and hold them to the table of ``utils/platform.py``. The CPU
computes exact f32 whatever the flags, so every mode's encode must give
the JAX package's indices bit for bit (JAX's noise replayed, its
codebooks carried across; the JAX package's own tests pin that its modes
agree bit for bit on the CPU, so one JAX encode per config stands for
all).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FlagRecorder, recording_flags
from recombiner_tpu.cli.compress import parse_args as jax_compress_args
from recombiner_tpu.coding import encoder as jenc
from recombiner_tpu.coding import progressive as jprog
from recombiner_tpu.config import get_config as jax_get_config
from recombiner_tpu.io import checkpoint as jck
from recombiner_tpu.utils import platform as jax_platform
from recombiner_tpu_torch import device
from recombiner_tpu_torch.cli import compress as compress_cli
from recombiner_tpu_torch.cli import rd_sweep
from recombiner_tpu_torch.coding import decoder, encoder, progressive
from recombiner_tpu_torch.config import get_config
from recombiner_tpu_torch.data.synthetic import synthetic_dataset
from recombiner_tpu_torch.io import checkpoint, convert
from recombiner_tpu_torch.metrics import UNROUNDED_PSNR
from recombiner_tpu_torch.priors import trainer
from recombiner_tpu_torch.utils import platform
from test_torch_encode import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encode import png_dir  # noqa: F401 (fixture)
from test_torch_modalities import _random_prior

EXACT, TF32 = (False, False), (True, True)
MODES = [None, "default", "scoped", "scoped_high", "high", "highest"]
# --precision -> what apply_precision_mode returns
RETURNS = {None: None, "default": "default", "scoped": "highest", "scoped_high": "high",
           "high": None, "highest": None}
# --precision -> the flags of (phase 1 and training, the finetunes of the
# other configs, the finetunes of the unrounded-PSNR configs); A* scoring
# and decode are EXACT in every mode
TABLE = {
    None: (TF32, TF32, EXACT),
    "default": (TF32, TF32, TF32),
    "scoped": (TF32, EXACT, EXACT),
    "scoped_high": (TF32, TF32, TF32),
    "high": (TF32, TF32, EXACT),
    "highest": (EXACT, EXACT, EXACT),
}
S, PHASE1, FINETUNE = 2, 4, 1


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture(autouse=True)
def torch_defaults(monkeypatch):
    """Each test starts from the ambient TF32 and torch's own flag defaults
    (cuBLAS TF32 off, cuDNN on), and leaves all three as it found them."""
    monkeypatch.setattr(platform, "AMBIENT", "high")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


# ------------------------------------------------------------ the modes


def test_apply_matmul_precision_plumbing():
    """--precision parses in both CLIs as in the JAX package's; the ambient
    moves only when asked, and ``device.precision(None)`` follows it."""
    argv = ["--test_dir", "x", "--test_idx", "0", "--prior_path", "p", "--save_dir", "s",
            "--precision", "highest"]
    assert compress_cli.parse_args(argv).precision == jax_compress_args(argv).precision
    assert rd_sweep.parse_args(["--dataset", "tiny", "--bitrates", "2.0"]).precision is None
    platform.apply_matmul_precision(None)
    assert platform.AMBIENT == "high" and not platform.is_exact(None)
    with device.precision():
        assert _flags() == TF32
    platform.apply_matmul_precision("highest")
    assert platform.AMBIENT == "highest" and platform.is_exact(None)
    with device.precision():
        assert _flags() == EXACT
    with device.precision("high"):
        assert _flags() == TF32
    platform.apply_matmul_precision("default")
    assert platform.AMBIENT == "high"
    assert _flags() == (False, True)
    with pytest.raises(ValueError, match="precision"):
        platform.apply_matmul_precision("bfloat16")


def test_apply_precision_mode_mapping():
    """None and 'default' change nothing globally and differ (None lets
    compress apply the per-modality auto, 'default' skips it); 'scoped' and
    'scoped_high' scope the finetunes; 'high' and 'highest' set the ambient,
    as the JAX package's ``jax_default_matmul_precision``."""
    assert platform.apply_precision_mode(None) is None
    assert platform.apply_precision_mode("default") == "default"
    assert platform.AMBIENT == "high"
    assert platform.apply_precision_mode("scoped") == "highest"
    assert platform.apply_precision_mode("scoped_high") == "high"
    assert platform.AMBIENT == "high"
    assert platform.apply_precision_mode("high") is None
    assert platform.AMBIENT == "high"
    assert platform.apply_precision_mode("highest") is None
    assert platform.AMBIENT == "highest"
    assert _flags() == (False, True)  # torch's flags move only inside a scope
    assert platform.PRECISION_CHOICES == jax_platform.PRECISION_CHOICES


def test_apply_precision_mode_sentinel():
    """--precision default reaches compress as the sentinel, not as None,
    and each scoped value returns what the JAX package's returns."""
    for mode in (None, "default", "scoped", "scoped_high"):
        assert platform.apply_precision_mode(mode) == jax_platform.apply_precision_mode(mode)
    assert platform.apply_precision_mode("default") == "default"


def test_resolve_coding_precision_auto():
    """The unrounded-PSNR configs' finetunes default to exact; 'default'
    forces the ambient; any other value is kept. Equal to the JAX
    package's for every value and config."""
    tiny, audio = get_config("tiny"), get_config("tiny_audio")
    assert progressive.resolve_coding_precision(None, audio) == "highest"
    assert progressive.resolve_coding_precision(None, tiny) is None
    assert progressive.resolve_coding_precision("default", audio) is None
    assert progressive.resolve_coding_precision("default", tiny) is None
    assert progressive.resolve_coding_precision("high", audio) == "high"
    assert progressive.resolve_coding_precision("highest", tiny) == "highest"
    for name in ("tiny", "tiny_audio", "audio", "audio_mini", "cifar", "kodak", "video"):
        for p in (None, "default", "high", "highest"):
            assert (progressive.resolve_coding_precision(p, get_config(name))
                    == jprog.resolve_coding_precision(p, jax_get_config(name)))


def test_device_precision_scopes_and_restores():
    """``device.precision`` sets both flags for its duration and restores
    them; ``exact_f32`` is 'highest' whatever the ambient; an unknown
    precision raises before any flag moves."""
    with device.precision("highest"):
        assert _flags() == EXACT
        with device.precision("default"):
            assert _flags() == TF32
        assert _flags() == EXACT
    assert _flags() == (False, True)
    platform.apply_matmul_precision("highest")
    with device.precision("high"), device.exact_f32():
        assert _flags() == EXACT
    with pytest.raises(ValueError, match="precision"):
        with device.precision("tensorfloat32"):
            pass
    assert _flags() == (False, True)


def test_encode_scoring_precision_is_unconditionally_exact(priors):
    """The A* scoring products run with TF32 off whatever the mode and the
    caller's flags: structurally (the scoring block of encode_step_level
    sits in ``exact_f32()``, as the JAX package's carries HIGHEST) and at
    run time."""
    src = inspect.getsource(encoder.encode_step_level)
    assert src.count("with exact_f32():") == 1
    block = src.split("with exact_f32():")[1].split("idx = ")[0]
    assert block.count("@") == 2 and "meta.eps" in block
    art = checkpoint.load_prior_artifact(priors["tiny"])
    codec, state = decoder.init_codec(art, 2, device="cpu")
    rec = FlagRecorder()
    torch.backends.cuda.matmul.allow_tf32 = True
    with rec, device.precision("high"):
        encoder.encode_step(codec, state)
    assert rec.seen == {None: {EXACT}}
    assert _flags() == (True, True)


# ------------------------------------------- every mode, two configs


@pytest.fixture(scope="module")
def priors(tmp_path_factory):
    """A TINY and a TINY_AUDIO prior from fixed seeds, written by the JAX
    package's artifact writer."""
    root = tmp_path_factory.mktemp("torch_precision")
    return {name: _random_prior(str(root / f"{name}.npz"), name, seed)
            for name, seed in (("tiny", 10), ("tiny_audio", 11))}


def _noise(key, codec, rows, cfg):
    """The noise JAX's ``predict`` draws from ``key``: LPE, then w from the
    first of three keys split from the second (``mappings.py:147``), and h
    and hh from the others for a patch config."""
    k_lpe, k_w = jax.random.split(key)
    ks = jax.random.split(k_w, 3)
    shapes = [(rows, S, *cfg.lpe_spatial, cfg.latent_dim), (rows, S, cfg.n_inr_params)]
    if cfg.patch:
        shapes += [(cfg.rows_level2(rows), S, codec.h.D), (cfg.rows_level3(rows), S, codec.hh.D)]
    return [np.array(jax.random.normal(k, sh)) for k, sh in zip((k_lpe, *ks), shapes)]


class Encode:
    """One config's codec, data and JAX encode (CRN finetunes, so that the
    finetune noise is one key chain in both packages), and the port's
    encode with JAX's noise replayed."""

    KEY = 14

    def __init__(self, path):
        jart, art = jck.load_prior_artifact(path), checkpoint.load_prior_artifact(path)
        self.cfg = cfg = art.config
        self.X, self.Y = synthetic_dataset(cfg, 2, seed=13,
                                           kind="speech" if cfg.name in UNROUNDED_PSNR
                                           else "smooth")
        self.rows = rows = self.X.shape[0]
        self.levels = ("w", "h", "hh") if cfg.patch else ("w",)
        jcodec, jstate = jenc.init_codec(jart, rows)
        self.codec, self.state = decoder.init_codec(art, rows, device="cpu")
        for lv in self.levels:
            self.codec = convert.with_codebook(self.codec, jcodec.meta(lv), lv)
        self.budgets = dict(n_optimize_epochs=PHASE1, sample_size=S, finetune_crn=True,
                            finetune_overrides={lv: FINETUNE for lv in self.levels})
        jres = jprog.compress(jcodec, jstate, jnp.asarray(self.X), jnp.asarray(self.Y),
                              jart.config, jax.random.key(self.KEY), **self.budgets)
        self.jax_indices = {lv: np.array(jres.indices[lv]) for lv in self.levels}

    def port(self, monkeypatch, **kw):
        key = jax.random.key(self.KEY)
        k, sub = jax.random.split(key)
        phase1 = iter(jax.random.split(sub, PHASE1))
        crn_keys = jax.random.split(jax.random.split(jax.random.fold_in(k, 0x0C12))[1],
                                    FINETUNE)

        def restart():
            keys = iter(crn_keys)
            return lambda: _noise(next(keys), self.codec, self.rows, self.cfg)

        monkeypatch.setattr(progressive, "finetune_noise", lambda gen, on: restart)
        return progressive.compress(
            self.codec, self.state, self.X, self.Y, self.cfg,
            lambda: _noise(next(phase1), self.codec, self.rows, self.cfg), **self.budgets, **kw)


@pytest.fixture(scope="module")
def encodes(priors):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = Encode(priors[name])
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["tiny", "tiny_audio"])
@pytest.mark.parametrize("mode", MODES)
def test_each_mode_runs_where_the_table_says(encodes, monkeypatch, mode, name):
    """``apply_precision_mode(mode)``, then a whole encode (phase 1, every
    group of every level coded with its finetune, decode) and one training
    epoch: both TF32 flags at every product of each part are the table's;
    no flag is left changed; the indices equal the JAX package's bit for
    bit."""
    enc = encodes(name)
    before = _flags()
    coding = platform.apply_precision_mode(mode)
    assert coding == RETURNS[mode]
    rec = FlagRecorder()
    gen = torch.Generator().manual_seed(0)
    st = trainer.init_prior_state(enc.cfg, enc.rows, gen, "cpu")
    with recording_flags(rec):
        res = enc.port(monkeypatch, coding_precision=coding)
        rec.labelled("training", trainer.sgd_epochs)(
            st, torch.from_numpy(enc.X), torch.from_numpy(enc.Y),
            trainer.init_priors(enc.cfg, "cpu"), 1e-3, gen, cfg=enc.cfg, n_epochs=1)
    assert _flags() == before
    ambient, finetunes, audio_finetunes = TABLE[mode]
    want = {"phase 1": ambient, "training": ambient, "A* scoring": EXACT, "decode": EXACT,
            "finetunes": audio_finetunes if name in UNROUNDED_PSNR else finetunes}
    assert rec.seen == {k: {v} for k, v in want.items()}
    for lv in enc.levels:
        assert res.state.level(lv).compressed.all()
        np.testing.assert_array_equal(res.indices[lv], enc.jax_indices[lv], err_msg=lv)


def test_precision_plumbing_bit_identical_on_cpu(encodes):
    """On the CPU, where every product is exact f32 whatever the flags, an
    encode with phase 1 and the finetunes scoped to 'highest' equals a
    default one bit for bit, its posteriors and reconstruction included;
    the scoped one ran exact throughout."""
    enc = encodes("tiny")

    def run(**kw):
        return progressive.compress(enc.codec, enc.state, enc.X, enc.Y, enc.cfg,
                                    torch.Generator().manual_seed(3), **kw, **enc.budgets)

    a = run()
    rec = FlagRecorder()
    with recording_flags(rec):
        b = run(coding_precision="highest", phase1_precision="highest")
    assert rec.seen == {k: {EXACT} for k in ("phase 1", "finetunes", "A* scoring", "decode")}
    np.testing.assert_array_equal(a.indices["w"], b.indices["w"])
    np.testing.assert_array_equal(a.reconstruction, b.reconstruction)
    assert torch.equal(a.state.w.q.loc, b.state.w.q.loc)


# ----------------------------------------------------------------- CLIs


class _Stop(Exception):
    pass


@pytest.mark.parametrize("mode", MODES)
def test_clis_pass_the_mode_on(png_dir, tmp_path, monkeypatch, mode):  # noqa: F811
    """``cli.compress`` and ``cli.rd_sweep`` apply --precision before they
    build the codec (rd_sweep before it trains) and hand compress what
    ``apply_precision_mode`` returns; no value is refused."""
    seen = {}

    def compress(*a, **kw):
        seen["compress"] = (kw["coding_precision"], platform.AMBIENT)
        raise _Stop

    def train_prior(*a, **kw):
        seen["train"] = platform.AMBIENT
        return checkpoint.load_prior_artifact(str(png_dir / "prior.npz"))

    argv = [] if mode is None else ["--precision", mode]
    ambient = "highest" if mode == "highest" else "high"
    monkeypatch.setattr(compress_cli, "compress", compress)
    with pytest.raises(_Stop):
        compress_cli.main(["--test_dir", str(png_dir / "images"), "--test_idx", "0",
                           "--prior_path", str(png_dir / "prior.npz"), "--save_dir",
                           str(tmp_path), "--device", "cpu", *argv])
    assert seen.pop("compress") == (RETURNS[mode], ambient)
    platform.AMBIENT = "high"
    monkeypatch.setattr(rd_sweep, "compress", compress)
    monkeypatch.setattr(rd_sweep, "train_prior", train_prior)
    with pytest.raises(_Stop):
        rd_sweep.main(["--dataset", "tiny", "--synthetic", "2", "--bitrates", "2.0",
                       "--device", "cpu", "--out", str(tmp_path / "rd.json"), *argv])
    assert seen == {"train": ambient, "compress": (RETURNS[mode], ambient)}
