"""Plain PyTorch log-mel frontend: the yardstick of the predict cell's
features.

Written from the definitions the configuration states (librosa's, which
the recipe's features follow): a symmetric Hamming window of ``n_window``
samples, ``0.54 - 0.46 cos(2 pi n / (n_window - 1))``, centred in
``n_fft`` zeros; the short-time Fourier transform of the clip reflected by
``n_fft // 2`` samples at each end, a frame every ``hop`` samples
(``torch.stft``); its magnitude; a triangular filterbank over the Slaney
mel scale (linear at 200/3 Hz a mel below 1 kHz, logarithmic at
``ln(6.4) / 27`` a mel above), ``n_mels + 2`` points evenly spaced in mel
from 0 to the Nyquist frequency, the filters unnormalised; the magnitudes'
mel sums; then ``20 log10(max(1e-5, mel))``, floored 80 dB below the clip's
own peak; the frames cut or zero-padded to ``frames``.

``mode="f32"`` is the reference (TF32 off); ``"bf16"`` the control: the
clip, the magnitudes, the filters and the mel sums rounded to bf16.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

AMIN, TOP_DB = 1e-5, 80.0


def _hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    linear = f * 3.0 / 200.0
    return torch.where(f >= 1000.0, 15.0 + torch.log(f.clamp(min=1e-10) / 1000.0) * 27.0
                       / math.log(6.4), linear)


def _mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    return torch.where(m >= 15.0, 1000.0 * torch.exp((m - 15.0) * math.log(6.4) / 27.0),
                       m * 200.0 / 3.0)


def mel_filters(sr: int, n_fft: int, n_mels: int, device) -> torch.Tensor:
    """[n_mels, n_fft // 2 + 1] triangles, computed in float64."""
    f = torch.linspace(0.0, sr / 2.0, n_fft // 2 + 1, dtype=torch.float64, device=device)
    top = _hz_to_mel(torch.tensor(sr / 2.0, dtype=torch.float64))
    pts = _mel_to_hz(torch.linspace(0.0, float(top), n_mels + 2, dtype=torch.float64,
                                    device=device))
    left, centre, right = pts[:-2, None], pts[1:-1, None], pts[2:, None]
    rise = (f[None] - left) / (centre - left)
    fall = (right - f[None]) / (right - centre)
    return torch.clamp(torch.minimum(rise, fall), min=0.0)


def hamming(n_window: int, n_fft: int, device) -> torch.Tensor:
    n = torch.arange(n_window, dtype=torch.float64, device=device)
    w = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n / (n_window - 1))
    left = (n_fft - n_window) // 2
    return F.pad(w, (left, n_fft - n_window - left))


def logmel(waves: torch.Tensor, fc: Dict, frames: int, mode: str = "f32") -> torch.Tensor:
    """[B, S] waveforms -> [B, frames, n_mels] log-mel in dB.  ``fc`` holds
    ``sample_rate``, ``n_fft``, ``n_window``, ``hop`` and ``n_mels``."""
    rnd = (lambda x: x.bfloat16().float()) if mode == "bf16" else (lambda x: x)
    dev = waves.device
    window = hamming(fc["n_window"], fc["n_fft"], dev).float()
    spec = torch.stft(rnd(waves.float()), fc["n_fft"], hop_length=fc["hop"], window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    mag = rnd(spec.abs())  # [B, bins, T]
    filters = rnd(mel_filters(fc["sample_rate"], fc["n_fft"], fc["n_mels"], dev).float())
    mel = rnd(torch.matmul(filters, mag)).transpose(1, 2)  # [B, T, n_mels]
    db = 20.0 * torch.log10(mel.clamp(min=AMIN))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - TOP_DB)
    t = db.shape[1]
    return db[:, :frames] if t >= frames else F.pad(db, (0, 0, 0, frames - t))
