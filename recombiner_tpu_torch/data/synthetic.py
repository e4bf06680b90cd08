"""Synthetic datasets, a copy of ``recombiner_tpu/data/synthetic.py``: smooth
band-limited signals (random low-frequency Fourier mixtures) for any
geometry, speech-like clips shaped to a real clip's long-term average
spectrum, and protein C-alpha backbones; the same numbers for a seed as
the JAX package's. The port's smoke draws its audio, video and protein
inputs from them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.coords import grid_fourier_features, make_coord_grid, patchify


def smooth_signal(
    rng: np.random.Generator, spatial: Tuple[int, ...], channels: int, n_modes: int = 6
) -> np.ndarray:
    """Random smooth signal in [0, 1], shape (*spatial, channels)."""
    d = len(spatial)
    coords = make_coord_grid(spatial)  # (*spatial, d)
    out = np.zeros((*spatial, channels), np.float64)
    for _ in range(n_modes):
        freq = rng.uniform(0.3, 2.0, size=(d,))
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.normal(size=(channels,)) / n_modes
        wave = np.sin(np.pi * (coords * freq).sum(-1) + phase)
        out += wave[..., None] * amp
    out = (out - out.min()) / (out.max() - out.min() + 1e-9)
    return out.astype(np.float32)


# Long-term average spectrum of the reference's own LibriSpeech clip
# (examples/ground_truth.wav), measured with 1024-pt Hann frames at 50%
# overlap, averaged into 24 log-spaced bands 60 Hz - 8 kHz, dB re max band.
# An unshaped generator is 10-17 dB too bright above 1 kHz, so every clip is
# shaped to this envelope (with small per-clip jitter) before normalization.
_LTAS_CENTERS_HZ = np.array([
    66.4, 81.5, 99.9, 122.5, 150.2, 184.1, 225.8, 276.8, 339.4, 416.2,
    510.3, 625.7, 767.2, 940.7, 1153.4, 1414.2, 1734.0, 2126.1, 2606.9,
    3196.4, 3919.3, 4805.5, 5892.3, 7224.7,
])
_LTAS_DB = np.array([
    -17.51, -6.44, -0.05, -1.14, -8.28, -0.74, 0.0, -5.24, -5.51, -8.65,
    -8.76, -9.76, -14.22, -17.48, -17.86, -17.08, -22.04, -27.45, -32.33,
    -32.98, -29.35, -27.38, -33.8, -36.09,
])


def _shape_to_ltas(
    rng: np.random.Generator,
    wav: np.ndarray,
    sample_rate: int,
    jitter_db: float = 2.0,
) -> np.ndarray:
    """FFT-domain equalization of ``wav`` toward the real-speech LTAS above.

    Measures the clip's own band powers on the same log grid and applies the
    smooth (log-frequency interpolated) correction, leaving overall level to
    the caller's peak normalization. Clips too short to resolve the band
    grid (tiny test geometries) are returned unshaped."""
    n = wav.shape[0]
    spec = np.fft.rfft(wav)
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    power = np.abs(spec) ** 2
    edges = np.geomspace(60.0, min(8000.0, sample_rate / 2), 25)
    own_db, centers, target_db = [], [], []
    jitter = rng.uniform(-jitter_db, jitter_db, _LTAS_DB.shape[0])
    for b, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        m = (freqs >= lo) & (freqs < hi)
        if not m.any():
            continue
        p = power[m].mean()
        if p <= 0:
            continue
        own_db.append(10.0 * np.log10(p))
        centers.append(np.sqrt(lo * hi))
        target_db.append(_LTAS_DB[b] + jitter[b])
    if len(centers) < 4:
        return wav
    own_db = np.array(own_db)
    target_db = np.array(target_db)
    # mean-free correction: shape only, overall level unchanged
    corr = (target_db - own_db) - (target_db - own_db).mean()
    logf = np.log(np.maximum(freqs, centers[0]))
    gain_db = np.interp(logf, np.log(centers), corr)
    return np.fft.irfft(spec * 10.0 ** (gain_db / 20.0), n)


def speech_like_clip(
    rng: np.random.Generator, n_samples: int, sample_rate: int = 16000
) -> np.ndarray:
    """Speech-like 1-D signal in [0, 1], shape (n_samples, 1).

    A stand-in for LibriSpeech clips where none are at hand: smooth_signal()
    is nearly DC at the 800-sample patch scale, while this generator gives
    the spectral structure speech INR priors see: voiced segments
    (harmonic stack on a drifting 90-250 Hz pitch, formant-shaped envelope),
    unvoiced segments (band-passed noise bursts), and pauses, with smooth
    amplitude modulation. Mapped to [0, 1] exactly like the reference's
    (wav + 1) / 2 preprocessing (data/audio.py:96-99).
    """
    t = np.arange(n_samples) / sample_rate
    # drifting fundamental: smoothed random walk in 90-250 Hz
    n_ctrl = max(n_samples // 800, 4)
    f0_ctrl = rng.uniform(90.0, 250.0, n_ctrl)
    f0 = np.interp(np.linspace(0, 1, n_samples), np.linspace(0, 1, n_ctrl), f0_ctrl)
    # pitch jitter: ~1% cycle-to-cycle period noise at a ~100 Hz control
    # rate — real glottal cycles are never metronomic, and the INR prior
    # sees the difference at the 50 ms patch scale
    n_jit = max(n_samples // 160, 4)
    jit = 1.0 + 0.012 * rng.standard_normal(n_jit)
    f0 = f0 * np.interp(np.linspace(0, 1, n_samples), np.linspace(0, 1, n_jit), jit)
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate

    # formant envelope: 3 random resonances over 300-3500 Hz with 1/f rolloff
    n_harm = 40
    k = np.arange(1, n_harm + 1)[:, None]  # (H, 1)
    harm_freq = k * f0[None, :]  # (H, T)
    env = np.zeros_like(harm_freq)
    for _ in range(3):
        fc = rng.uniform(300.0, 3500.0)
        bw = rng.uniform(80.0, 400.0)
        env += np.exp(-0.5 * ((harm_freq - fc) / bw) ** 2)
    env = (env + 0.15) / (1.0 + 0.3 * harm_freq / 100.0)  # rolloff
    # glottal-pulse phase coherence: voiced speech is an impulse train
    # through resonances, so harmonic phases are nearly aligned (small
    # group-delay dispersion growing with frequency); uniform random phases
    # would smear each pitch pulse into a patch-scale waveform real speech
    # never produces, so keep a per-clip dispersion instead.
    disp = rng.uniform(0.1, 1.0)
    phi = rng.uniform(0, 2 * np.pi) + disp * np.sqrt(k) * rng.standard_normal(
        (n_harm, 1)
    )
    voiced = (env * np.sin(k * phase[None, :] + phi)).sum(0)
    # shimmer: slow multiplicative amplitude noise (~100 Hz control rate)
    shim = 1.0 + 0.06 * rng.standard_normal(n_jit)
    voiced = voiced * np.interp(
        np.linspace(0, 1, n_samples), np.linspace(0, 1, n_jit), shim
    )
    voiced /= max(np.abs(voiced).max(), 1e-9)

    # unvoiced: high-passed noise (FFT mask above ~2 kHz)
    noise = rng.normal(size=n_samples)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n_samples, 1.0 / sample_rate)
    spec *= 1.0 / (1.0 + np.exp(-(freqs - 2000.0) / 300.0))
    unvoiced = np.fft.irfft(spec, n_samples)
    unvoiced /= max(np.abs(unvoiced).max(), 1e-9)

    # segmentation: alternate voiced / unvoiced / silence, 60-300 ms pieces
    gate_v = np.zeros(n_samples)
    gate_u = np.zeros(n_samples)
    pos = 0
    while pos < n_samples:
        seg = int(rng.uniform(0.06, 0.3) * sample_rate)
        kind = rng.choice(3, p=[0.6, 0.25, 0.15])  # voiced / unvoiced / pause
        if kind == 0:
            gate_v[pos : pos + seg] = 1.0
        elif kind == 1:
            gate_u[pos : pos + seg] = 0.35
        pos += seg
    # smooth the gates (~8 ms ramps) so segment edges aren't step functions;
    # np.convolve('same') returns the LONGER operand's length, so clamp the
    # kernel below the clip length for tiny test geometries
    w = max(min(int(0.008 * sample_rate), (n_samples - 1) // 2 - 1), 1)
    kernel = np.hanning(2 * w + 1)
    kernel /= kernel.sum()
    gate_v = np.convolve(gate_v, kernel, mode="same")
    gate_u = np.convolve(gate_u, kernel, mode="same")
    # slow loudness modulation (syllabic, ~3-5 Hz)
    amp = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t + rng.uniform(0, 2 * np.pi))

    wav = amp * (gate_v * voiced + gate_u * unvoiced)
    # equalize toward the real clip's measured LTAS (see _shape_to_ltas)
    wav = _shape_to_ltas(rng, wav, sample_rate)
    wav *= rng.uniform(0.3, 0.6) / max(np.abs(wav).max(), 1e-9)  # peak like real speech
    return (((wav + 1.0) / 2.0).astype(np.float32))[:, None]


def protein_backbone(rng: np.random.Generator, n_residues: int) -> np.ndarray:
    """Synthetic CA backbone with the statistics the protein pipeline expects
    (data/protein.py:9-42 semantics): consecutive CA-CA distance 3.8 A,
    direction random walk with angular persistence (compact fold-like
    geometry, alternating straighter helix-like and kinked loop-like
    segments), centered and scaled by 1/25 exactly like the loader.
    Returns (n_residues, 3) in normalized units (roughly [-1, 1])."""
    u = rng.normal(size=3)
    u /= np.linalg.norm(u)
    # per-residue persistence: high (straight) in helix-like runs, low in loops
    persist = np.empty(n_residues)
    pos = 0
    while pos < n_residues:
        seg = int(rng.integers(4, 16))
        persist[pos : pos + seg] = rng.choice([0.85, 0.35], p=[0.55, 0.45])
        pos += seg
    steps = np.empty((n_residues, 3))
    steps[0] = u
    for i in range(1, n_residues):
        u = persist[i] * u + (1.0 - persist[i]) * rng.normal(size=3)
        u /= np.linalg.norm(u)
        steps[i] = u
    xyz = np.cumsum(3.8 * steps, axis=0)
    xyz -= xyz.mean(0)
    return (xyz / 25.0).astype(np.float32)


def synthetic_dataset(
    cfg: ModalityConfig, n_datapoints: int, seed: int = 0, kind: str = "smooth"
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (X, Y) exactly as the data pipeline would: Fourier-embedded
    coordinates and per-point features, optionally split into patches.

    kind: "smooth" (band-limited Fourier mixtures, any geometry),
    "speech" (speech-like clips, 1-D single-channel geometries only), or
    "backbone" (protein CA traces, 1-D three-channel geometries only).

    Returns X (R, P, fourier_dim), Y (R, P, out_dim) where R =
    n_datapoints * patches_per_datapoint.
    """
    rng = np.random.default_rng(seed)
    if cfg.patch:
        full_spatial = tuple(
            cfg.patch_nums[i] * cfg.pixel_sizes[i] for i in range(cfg.data_dim)
        )
    else:
        full_spatial = cfg.pixel_sizes

    feats = grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)  # per patch/datum
    P = feats.shape[0]

    if kind == "speech" and not (cfg.data_dim == 1 and cfg.output_dim == 1):
        raise ValueError("kind='speech' needs 1-D single-channel geometry")
    if kind == "backbone" and not (cfg.data_dim == 1 and cfg.output_dim == 3):
        raise ValueError("kind='backbone' needs 1-D three-channel geometry")

    Xs, Ys = [], []
    for _ in range(n_datapoints):
        if kind == "speech":
            sig = speech_like_clip(rng, full_spatial[0])
        elif kind == "backbone":
            sig = protein_backbone(rng, full_spatial[0])
        else:
            sig = smooth_signal(rng, full_spatial, cfg.output_dim)
        if cfg.patch:
            patches = patchify(sig, cfg.pixel_sizes)  # (n_patches, *ps, C)
            Ys.append(patches.reshape(patches.shape[0], P, cfg.output_dim))
            Xs.append(np.broadcast_to(feats, (patches.shape[0], P, cfg.fourier_dim)))
        else:
            Ys.append(sig.reshape(1, P, cfg.output_dim))
            Xs.append(feats[None])
    return np.concatenate(Xs).astype(np.float32), np.concatenate(Ys).astype(np.float32)
