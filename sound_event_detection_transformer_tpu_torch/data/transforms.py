"""Host-side per-clip transforms (numpy).

The port's own copy of the JAX package's ``data/transforms.py``: the dB
conversion per clip (``apply_log``), pad or truncate, the eval/base pipeline
(``get_transforms``) and the audio-tag trainer's (``get_frame_transforms``,
``time_shift``), and the SP-SEDT patch helpers (``get_random_patch_boxes``,
``extract_patches``, ``resize_patch``).  The random helpers draw from a
``np.random.RandomState`` in the JAX package's order, so one seed gives the
same boxes, crops and shifts on both sides.  Stochastic spectrogram
augmentations run on the device instead (``ops/augment.py``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .scaler import Scaler


def apply_log(data: np.ndarray) -> np.ndarray:
    """Amplitude -> dB per clip [T, F], floored 80 dB below the clip's
    maximum (librosa's ``amplitude_to_db``)."""
    log_spec = 20.0 * np.log10(np.maximum(1e-5, data))
    return np.maximum(log_spec, log_spec.max() - 80.0).astype(np.float32)


def pad_trunc_seq(x: np.ndarray, max_len: int) -> np.ndarray:
    """Pad with zeros or truncate on axis -2 to ``max_len``."""
    if x.shape[-2] <= max_len:
        pad = [(0, 0)] * (x.ndim - 2) + [(0, max_len - x.shape[-2]), (0, 0)]
        return np.pad(x, pad, mode="constant")
    return x[..., :max_len, :]


def resize_patch(patch: np.ndarray, out_t: int = 128, out_f: int = 64) -> np.ndarray:
    """Bilinear resize of one patch to (out_t, out_f) (PIL's bilinear map,
    align_corners False) inside a min/max renormalisation of the patch."""
    t, f = patch.shape
    mn, mx = float(patch.min()), float(patch.max())
    scale = max(mx - mn, 1e-12)
    norm = (patch - mn) / scale
    # PIL Image.resize default is bilinear with align_corners=False semantics
    yi = (np.arange(out_t) + 0.5) * t / out_t - 0.5
    xi = (np.arange(out_f) + 0.5) * f / out_f - 0.5
    y0 = np.clip(np.floor(yi).astype(int), 0, t - 1)
    y1 = np.clip(y0 + 1, 0, t - 1)
    x0 = np.clip(np.floor(xi).astype(int), 0, f - 1)
    x1 = np.clip(x0 + 1, 0, f - 1)
    wy = np.clip(yi - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xi - x0, 0.0, 1.0)[None, :]
    out = (
        norm[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
        + norm[np.ix_(y1, x0)] * wy * (1 - wx)
        + norm[np.ix_(y0, x1)] * (1 - wy) * wx
        + norm[np.ix_(y1, x1)] * wy * wx
    )
    return (out * scale + mn).astype(np.float32)


def extract_patches(
    data: np.ndarray,  # [T, F]
    boxes: np.ndarray,  # [P, 2] (center, length) normalized
    out_t: int = 128,
    out_f: int = 64,
) -> np.ndarray:
    """Crop each (center, length) box's frames and resize the crop to
    (out_t, out_f); an empty crop grows by a frame on each side."""
    t = data.shape[0]
    patches = []
    for c, l in np.asarray(boxes, dtype=np.float32):
        s_idx, e_idx = int((c - l / 2) * t), int((c + l / 2) * t)
        if s_idx >= e_idx:  # make sure the patch is not empty
            s_idx = max(0, s_idx - 1)
            e_idx = min(t, e_idx + 1)
        patches.append(resize_patch(data[s_idx:e_idx, :], out_t, out_f))
    return np.stack(patches, axis=0)  # [P, out_t, out_f]


def get_random_patch_boxes(
    t: int,
    num_patches: int,
    mu: float = 0.2,
    sigma: float = 0.26,
    fixed_patch_size: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """``num_patches`` random (center, length) boxes over ``t`` frames:
    lengths from a normal(mu, sigma) truncated to [0.05, 0.8) by rejection
    (``5 * num_patches`` draws a round), then one integer center each."""
    rng = rng or np.random
    if fixed_patch_size:
        lengths = np.asarray([128 / t] * num_patches)
    else:
        lengths = []
        while len(lengths) < num_patches:
            draw = mu + sigma * rng.randn(5 * num_patches)
            lengths.extend([v for v in draw if 0.05 <= v < 0.8])
        lengths = np.asarray(lengths[:num_patches])
    boxes = []
    for l in lengths:
        lo, hi = int(t * l / 2) + 1, max(int(t * (1 - l / 2)), int(t * l / 2) + 2)
        c = rng.randint(lo, hi) / t
        s, e = int((c - l / 2) * t), int((c + l / 2) * t)
        boxes.append([(s + e) / (2 * t), (e - s) / t])
    return np.asarray(boxes, dtype=np.float32)


class Compose:
    """(data, label) transforms applied in turn."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def add_transform(self, transform):
        return Compose(self.transforms + [transform])

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def get_transforms(
    frames: int,
    scaler: Optional[Scaler] = None,
    add_axis: Optional[int] = 0,
    compute_log: bool = True,
):
    """The eval/base host pipeline: [dB] -> pad or truncate -> [normalize],
    as ``fn((data [T, F], label)) -> (data, label)``.  The random
    augmentations run on the device; ``collate`` adds the channel axis."""

    def fn(sample):
        data, label = sample
        if compute_log:
            data = apply_log(data)
        data = pad_trunc_seq(data, frames)
        if scaler is not None:
            data = scaler.normalize(data).astype(np.float32)
        return data, label

    return fn


def time_shift(
    data: np.ndarray,  # [T, F]
    label_matrix: Optional[np.ndarray] = None,  # [T, C] frame labels
    mean: float = 0.0,
    std: float = 90.0,
    rng: Optional[np.random.RandomState] = None,
):
    """Roll the clip in time by ``int(normal(mean, std))`` frames, and its
    frame labels with it (the audio-tag trainer's labels are frame matrices)."""
    rng = rng or np.random
    shift = int(rng.normal(mean, std))
    data = np.roll(data, shift, axis=0)
    if label_matrix is not None:
        label_matrix = np.roll(label_matrix, shift, axis=0)
    return data, label_matrix


def get_frame_transforms(
    frames: int,
    scaler: Optional[Scaler] = None,
    compute_log: bool = True,
    apply_time_shift: bool = False,
    rng: Optional[np.random.RandomState] = None,
):
    """The audio-tag trainer's host pipeline: [dB] -> pad or truncate ->
    [normalize] [-> time shift]."""

    def fn(sample):
        data, label = sample
        if compute_log:
            data = apply_log(data)
        data = pad_trunc_seq(data, frames)
        if scaler is not None:
            data = scaler.normalize(data).astype(np.float32)
        if apply_time_shift:
            lm = label if isinstance(label, np.ndarray) and label.ndim == 2 else None
            data, lm = time_shift(data, lm, rng=rng)
            if lm is not None:
                label = lm
        return data, label

    return fn
