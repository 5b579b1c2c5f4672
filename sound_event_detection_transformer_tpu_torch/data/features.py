"""Host-side audio reading and the numpy mirror of the device frontend.

Counterpart of ``read_audio``, ``_stft_constants`` and ``logmel_numpy`` of the
JAX package's ``data/features.py``: wav decoding by scipy (or the stdlib),
polyphase resampling by scipy.signal, and the log-mel computation that shares
its window and mel weights with ``ops/frontend.py``, so cached features and
the device path agree to float tolerance.  The dataset preparation
(``SedData``, ``get_dfs``) waits for the data-pipeline slice.
"""
from __future__ import annotations

from functools import lru_cache
from math import gcd
from typing import Optional

import numpy as np

from ..config import FeatureConfig
from ..ops import frontend


def read_audio(path: str, target_fs: Optional[int] = None):
    """Read a wav file to mono float32, resampling if needed; returns
    (audio, sample rate)."""
    try:
        from scipy.io import wavfile

        fs, audio = wavfile.read(path)
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        elif audio.dtype == np.int32:
            audio = audio.astype(np.float32) / 2147483648.0
        elif audio.dtype == np.uint8:
            audio = (audio.astype(np.float32) - 128.0) / 128.0
        else:
            audio = audio.astype(np.float32)
    except (ImportError, ValueError):  # no scipy, or a wav it cannot parse: the stdlib reader
        import wave

        with wave.open(path, "rb") as w:
            fs = w.getframerate()
            raw = w.readframes(w.getnframes())
            width = w.getsampwidth()
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
            audio = np.frombuffer(raw, dtype=dtype).astype(np.float32)
            audio /= float(2 ** (8 * width - 1))
            ch = w.getnchannels()
            if ch > 1:
                audio = audio.reshape(-1, ch)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if target_fs is not None and fs != target_fs:
        from scipy.signal import resample_poly

        g = gcd(int(target_fs), int(fs))
        audio = resample_poly(audio, target_fs // g, fs // g).astype(np.float32)
        fs = target_fs
    return audio, fs


@lru_cache(maxsize=8)
def _stft_constants(sample_rate, n_fft, n_window, n_mels):
    """Padded float32 window + transposed mel weights, cached per config."""
    window = frontend.padded_window(n_window, n_fft)
    mel_wt = frontend.mel_filterbank(sample_rate, n_fft, n_mels).T
    return window.astype(np.float32), np.ascontiguousarray(mel_wt, np.float32)


def logmel_numpy(y: np.ndarray, fc: FeatureConfig) -> np.ndarray:
    """Host (numpy) mirror of ``ops.frontend.waveform_to_logmel``:
    [samples] -> [n_frames, n_mels] float32, float32 end to end (scipy's rfft
    keeps single precision)."""
    from scipy.fft import rfft

    window, mel_wt = _stft_constants(fc.sample_rate, fc.n_fft, fc.n_window, fc.n_mels)
    pad = fc.n_fft // 2
    yp = np.pad(np.asarray(y, np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(yp) - fc.n_fft) // fc.hop_size
    idx = np.arange(n_frames)[:, None] * fc.hop_size + np.arange(fc.n_fft)[None, :]
    frames = yp[idx] * window[None, :]
    mag = np.abs(rfft(frames, n=fc.n_fft, axis=-1))
    mel = mag @ mel_wt
    if fc.compute_log:
        log_spec = 20.0 * np.log10(np.maximum(1e-5, mel))
        mel = np.maximum(log_spec, log_spec.max() - 80.0)
    return mel.astype(np.float32)
