"""Dataset-level feature normalization.

The port's own copy of the JAX package's ``data/scaler.py`` (numpy only):
per-mel-band mean and std over a dataset (mean over all leading axes, keeping
the last), JSON save/load, plus the per-audio variant.
"""
from __future__ import annotations

import json
from typing import Iterable, Optional, Tuple

import numpy as np


class Scaler:
    def __init__(self):
        self.mean_: Optional[np.ndarray] = None
        self.mean_of_square_: Optional[np.ndarray] = None
        self.std_: Optional[np.ndarray] = None

    @staticmethod
    def _mean_last(data: np.ndarray) -> np.ndarray:
        """Mean over all axes but the last."""
        m = np.asarray(data, dtype=np.float64)
        while m.ndim != 1:
            m = np.mean(m, axis=0, dtype=np.float64)
        return m

    def means(self, dataset: Iterable) -> "Scaler":
        counter = 0
        for sample in dataset:
            x = sample[0] if isinstance(sample, (tuple, list)) and len(sample) == 2 else sample
            if isinstance(x, tuple):  # (clean, noisy) pair: use clean
                x = x[0]
            x = np.asarray(x)
            counter += 1
            m = self._mean_last(x)
            sq = self._mean_last(x**2)
            self.mean_ = m if self.mean_ is None else self.mean_ + m
            self.mean_of_square_ = (
                sq if self.mean_of_square_ is None else self.mean_of_square_ + sq
            )
        if counter == 0:
            raise ValueError("empty dataset")
        self.mean_ /= counter
        self.mean_of_square_ /= counter
        return self

    def calculate_scaler(self, dataset: Iterable) -> Tuple[np.ndarray, np.ndarray]:
        self.means(dataset)
        var = self.mean_of_square_ - self.mean_**2
        self.std_ = np.sqrt(np.maximum(var, 0.0))
        return self.mean_, self.std_

    def normalize(self, batch: np.ndarray) -> np.ndarray:
        return (np.asarray(batch) - self.mean_) / self.std_

    def state_dict(self):
        return {
            "mean_": self.mean_.tolist(),
            "mean_of_square_": self.mean_of_square_.tolist(),
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.state_dict(), f)

    def load(self, path: str) -> None:
        with open(path) as f:
            self.load_state_dict(json.load(f))

    def load_state_dict(self, state_dict) -> None:
        self.mean_ = np.array(state_dict["mean_"])
        self.mean_of_square_ = np.array(state_dict["mean_of_square_"])
        self.std_ = np.sqrt(np.maximum(self.mean_of_square_ - self.mean_**2, 0.0))


class ScalerPerAudio:
    """Per-clip normalization."""

    def __init__(self, normalization: str = "global", type_norm: str = "standard"):
        if normalization not in ("global", "per_band"):
            raise ValueError(f"unknown normalization {normalization!r}")
        self.normalization = normalization
        self.type_norm = type_norm

    def normalize(self, spectrogram: np.ndarray) -> np.ndarray:
        x = np.asarray(spectrogram, dtype=np.float32)
        axis = None if self.normalization == "global" else 0
        if self.type_norm == "standard":
            mean = x.mean(axis=axis, keepdims=axis is not None)
            std = x.std(axis=axis, keepdims=axis is not None)
            return (x - mean) / np.maximum(std, 1e-8)
        if self.type_norm == "max":
            mx = np.abs(x).max(axis=axis, keepdims=axis is not None)
            return x / np.maximum(mx, 1e-8)
        return x - x.mean(axis=axis, keepdims=axis is not None)

    def state_dict(self):
        return {"normalization": self.normalization, "type_norm": self.type_norm}
