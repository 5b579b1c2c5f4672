"""Waveform -> log-mel spectrogram frontend on the device.

Counterpart of the JAX package's ``ops/frontend.py``, with librosa's
semantics: symmetric Hamming window centre-padded to n_fft, centred
reflect-padded STFT, *amplitude* (not power) mel projection with a
slaney-scale unnormalised filterbank, and ``amplitude_to_db`` (ref 1,
amin 1e-5, top_db 80 against each clip's own maximum).

The STFT is framing followed by one [T, n_fft] x [n_fft, 2 * n_bins] product
against a windowed real-DFT basis (``use_matmul_dft=True``, the default, as in
the JAX package) or ``torch.fft.rfft``; both are tested to agree.  The two
products are plain ``torch.matmul`` in f32, outside any kernel.  Window, mel
weights and DFT basis are built with numpy exactly as the JAX package builds
them (mel points in float64, cast to f32 last).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hamming_window(n: int) -> np.ndarray:
    """Symmetric Hamming window, as ``np.hamming``."""
    return np.hamming(n).astype(np.float32)


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney-scale (htk=False) Hz -> mel, as used by librosa."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_min = 0.0
    f_sp = 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = frequencies >= min_log_hz
    return np.where(
        log_t,
        min_log_mel + np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    """Slaney-scale mel -> Hz inverse."""
    mels = np.asarray(mels, dtype=np.float64)
    f_min = 0.0
    f_sp = 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Triangular slaney-scale mel filterbank with ``norm=None``:
    [n_mels, n_fft // 2 + 1] float32."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(np.array(fmin)), hz_to_mel(np.array(fmax)), n_mels + 2)
    mel_f = mel_to_hz(mel_pts)  # [n_mels + 2]
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]  # [n_mels + 2, n_bins]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32)


def dft_basis(n_fft: int, window: np.ndarray) -> np.ndarray:
    """Windowed real-DFT basis [n_fft, 2 * n_bins] (cos block, then -sin
    block): ``frames @ basis`` gives [real | imag] of the windowed rFFT."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    cos = np.cos(angle) * window[:, None]
    sin = np.sin(angle) * window[:, None]
    return np.concatenate([cos, sin], axis=1).astype(np.float32)


def padded_window(n_window: int, n_fft: int) -> np.ndarray:
    """The Hamming window centre-padded to n_fft, as librosa pads it."""
    window = hamming_window(n_window)
    if n_window < n_fft:
        lpad = (n_fft - n_window) // 2
        window = np.pad(window, (lpad, n_fft - n_window - lpad))
    return window


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centred reflect-pad + frame: [..., num_samples] -> [..., n_frames, n_fft]
    (librosa's ``center=True, pad_mode='reflect'``).  The frames are a view."""
    pad = n_fft // 2
    flat = y.reshape(-1, y.shape[-1])  # reflect padding wants a batch dim
    flat = F.pad(flat[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = flat.unfold(-1, n_fft, hop)  # [B, 1 + (N + 2 pad - n_fft) // hop, n_fft]
    return frames.reshape(y.shape[:-1] + frames.shape[1:])


def _magnitude(frames: torch.Tensor, basis: Optional[torch.Tensor],
               window: torch.Tensor) -> torch.Tensor:
    """|DFT| of [..., n_frames, n_fft] frames: by the product with ``basis``
    when given, else by rFFT of the windowed frames."""
    n_fft = frames.shape[-1]
    if basis is not None:
        ri = torch.matmul(frames, basis)
        n_bins = n_fft // 2 + 1
        re, im = ri[..., :n_bins], ri[..., n_bins:]
        return torch.sqrt(re * re + im * im + 1e-30)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs()


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, window: np.ndarray,
                   use_matmul_dft: bool = True) -> torch.Tensor:
    """|STFT| by the DFT product or rFFT: [..., num_samples] -> [..., n_frames, n_bins]."""
    window = np.asarray(window, np.float32)
    basis = torch.from_numpy(dft_basis(n_fft, window)).to(y.device) if use_matmul_dft else None
    return _magnitude(frame_signal(y, n_fft, hop), basis, torch.from_numpy(window).to(y.device))


@functools.lru_cache(maxsize=8)
def _constants(sr: int, n_fft: int, n_window: int, n_mels: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(padded window [n_fft], DFT basis [n_fft, 2 n_bins], mel weights
    [n_bins, n_mels]) on ``device``, built once per configuration."""
    window = padded_window(n_window, n_fft)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return to(window), to(dft_basis(n_fft, window)), to(mel_filterbank(sr, n_fft, n_mels).T)


def amplitude_to_db(s: torch.Tensor, amin: float = 1e-5, top_db: Optional[float] = 80.0,
                    batch_dims: int = 0) -> torch.Tensor:
    """librosa.amplitude_to_db (ref 1.0): 20 log10(max(amin, s)), then clipped
    below ``max - top_db``.  The maximum is one clip's own: it runs over the
    dims after the first ``batch_dims``."""
    log_spec = 20.0 * torch.log10(s.clamp_min(amin))
    if top_db is not None:
        peak = log_spec.amax(dim=tuple(range(batch_dims, s.dim())), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def batch_waveform_to_logmel(ys: torch.Tensor, *, sr: int, n_fft: int, n_window: int, hop: int,
                             n_mels: int, compute_log: bool = True,
                             use_matmul_dft: bool = True) -> torch.Tensor:
    """The frontend over a batch: [B, num_samples] -> [B, n_frames, n_mels]."""
    window, basis, mel_wt = _constants(sr, n_fft, n_window, n_mels, ys.device)
    frames = frame_signal(ys.float(), n_fft, hop)
    mag = _magnitude(frames, basis if use_matmul_dft else None, window)  # [B, T, n_bins]
    mel = torch.matmul(mag, mel_wt)  # [B, T, n_mels]
    if compute_log:
        mel = amplitude_to_db(mel, batch_dims=1)
    return mel


def waveform_to_logmel(y: torch.Tensor, **kw) -> torch.Tensor:
    """The frontend for one waveform: [num_samples] -> [n_frames, n_mels]."""
    return batch_waveform_to_logmel(y[None], **kw)[0]


def make_frontend_fn(sr: int, n_fft: int, n_window: int, hop: int, n_mels: int, max_frames: int,
                     scaler_mean: Optional[np.ndarray] = None,
                     scaler_std: Optional[np.ndarray] = None, compute_log: bool = True):
    """Build the device frontend: raw waveforms [B, num_samples] (or
    [B, num_samples, 1]) -> normalised model input [B, max_frames, n_mels, 1],
    on the waveforms' device.  Short clips are zero-padded to ``max_frames``
    and long ones cropped, then the scaler's mean and std are applied."""
    mean = None if scaler_mean is None else torch.as_tensor(np.asarray(scaler_mean, np.float32))
    std = None if scaler_std is None else torch.as_tensor(np.asarray(scaler_std, np.float32))

    def fn(waveforms: torch.Tensor) -> torch.Tensor:
        if waveforms.dim() == 3:  # collated wav batches carry [B, N, 1]
            waveforms = waveforms[..., 0]
        mel = batch_waveform_to_logmel(waveforms, sr=sr, n_fft=n_fft, n_window=n_window,
                                       hop=hop, n_mels=n_mels, compute_log=compute_log)
        t = mel.shape[1]
        if t < max_frames:
            mel = F.pad(mel, (0, 0, 0, max_frames - t))
        else:
            mel = mel[:, :max_frames, :]
        if mean is not None:
            mel = (mel - mean.to(mel.device)) / std.to(mel.device)
        return mel[..., None]

    return fn
