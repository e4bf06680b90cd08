"""Audio loading and preprocessing (LibriSpeech, 3 s at 16 kHz -> [0, 1]), a
copy of ``recombiner_tpu/data/audio.py``. Clips load from the ``.npz``
dumps that ``process_audio_datasets`` writes or from the reference's
pickled tensor lists; a WAV file loads through scipy. torchaudio is
imported only by ``process_audio_datasets``' default corpus, which
downloads LibriSpeech."""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.data.pipeline import points_from_data, to_numpy_channel_last

SAMPLE_RATE = 16000
NUM_SECS = 3
CLIP_SAMPLES = SAMPLE_RATE * NUM_SECS  # 48000


def preprocess_clip(wav: np.ndarray) -> Optional[np.ndarray]:
    """[-1, 1] waveform -> [0, 1] 48,000-sample clip, or None if it is
    shorter: (wav + 1) / 2, truncated; only full clips are kept."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    wav = (wav + 1.0) / 2.0
    wav = wav[:CLIP_SAMPLES]
    return wav.astype(np.float32) if wav.shape[0] == CLIP_SAMPLES else None


def process_audio_datasets(save_dir: str, root: str = "./", corpus_fn=None) -> None:
    """Select clips, normalise them to [0, 1] and write
    ``test_dataset.npz`` and ``train_dataset.npz`` under ``save_dir``.

    ``corpus_fn(url)`` returns an indexable of 1-D [-1, 1] waveforms for
    LibriSpeech's ``test-clean`` and ``train-clean-100``; the default wraps
    torchaudio's LIBRISPEECH (a download)."""
    if corpus_fn is None:

        def corpus_fn(url: str):
            import torchaudio

            ds = torchaudio.datasets.LIBRISPEECH(root=root, url=url, download=True)

            class _Corpus:
                def __len__(self):
                    return len(ds)

                def __getitem__(self, i):
                    return ds[int(i)][0].float().numpy()[0]  # (L,)

            return _Corpus()

    def clips_of(url: str, limit: Optional[int]):
        ds = corpus_fn(url)
        n = len(ds)
        if limit is not None:
            idx = np.random.RandomState(0).choice(n, min(limit, n), False)
        else:
            idx = np.arange(n)
        out = []
        for i in idx:
            clip = preprocess_clip(ds[int(i)])
            if clip is not None:
                out.append(clip)
        return out

    test = clips_of("test-clean", None)
    train = clips_of("train-clean-100", 12000 // 60)
    np.savez(save_dir + "/test_dataset.npz", *test)
    np.savez(save_dir + "/train_dataset.npz", *train)


def load_clip_list(path: str) -> List[np.ndarray]:
    """Clips from an ``.npz`` dump, or from a ``.pkl`` of the reference's
    (1, 48000) torch tensors."""
    if path.endswith(".npz"):
        z = np.load(path)
        return [z[k] for k in z.files]
    with open(path, "rb") as f:
        tensors = pickle.load(f)
    return [to_numpy_channel_last(t).reshape(-1) for t in tensors]


def load_audio(clips: Sequence[np.ndarray], cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    data = [np.asarray(c, np.float32).reshape(CLIP_SAMPLES, 1) for c in clips]
    return points_from_data(data, cfg)


def load_wav_clip(path: str, cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    """One WAV file as an encode target: unsigned 8-bit, signed PCM or IEEE
    float, channel 0, scaled to [-1, 1] and clamped, then (wav + 1) / 2,
    truncated to the config's clip length."""
    from scipy.io import wavfile

    rate, wav = wavfile.read(path)
    if rate != SAMPLE_RATE:
        raise ValueError(f"{path}: sample rate {rate}, expected {SAMPLE_RATE}")
    if wav.ndim == 2:
        wav = wav[:, 0]
    elif wav.ndim != 1:
        raise ValueError(f"{path}: unsupported WAV shape {wav.shape}")
    if wav.dtype == np.uint8:  # unsigned, midpoint 128
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    elif wav.dtype.kind == "i":
        wav = wav.astype(np.float32) / float(np.iinfo(wav.dtype).max)
    elif wav.dtype.kind != "f":
        raise ValueError(f"{path}: unsupported WAV dtype {wav.dtype}")
    # full-scale negative PCM lands just below -1
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0).reshape(-1)
    n = cfg.patches_per_datapoint * cfg.pixel_sizes[0] if cfg.patch else cfg.pixel_sizes[0]
    if wav.shape[0] < n:
        raise ValueError(f"{path}: {wav.shape[0]} samples, need {n}")
    clip = (wav[:n] + 1.0) / 2.0
    return points_from_data([clip[:, None]], cfg)
