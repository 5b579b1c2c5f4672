"""Offline feature extraction: wav files -> cached log-mel ``.npy`` files and
metadata rows.

Counterpart of the JAX package's ``data/features.py``: wav decoding by scipy
(or the stdlib), polyphase resampling by scipy.signal, the log-mel
computation that shares its window and mel weights with ``ops/frontend.py``
(so cached features and the device path agree to float tolerance), and the
dataset preparation ``SedData`` / ``get_dfs`` on rows (``data/tsv.py``)
instead of DataFrames.  Features live under
``<base>/sr<sr>_win<w>_hop<h>_mels<m>[_nolog]/<clip>.npy``, the JAX
package's layout, so either side reads the other's cache.
"""
from __future__ import annotations

import dataclasses
import os
import os.path as osp
from functools import lru_cache
from math import gcd
from typing import Dict, List, Optional

import numpy as np

from ..config import FeatureConfig
from ..ops import frontend
from .tsv import read_tsv, unique


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


def meta_path_to_audio_dir(tsv_path: str) -> str:
    """``.../metadata/<x>/<split>.tsv`` -> ``.../audio/<x>/<split>``."""
    return osp.splitext(tsv_path.replace("metadata", "audio"))[0]


class SedData:
    """Dataset preparation: a metadata TSV -> rows with the clip's
    ``feature_filename`` and ``wav_filename``, extracting the missing
    ``.npy`` log-mels on the way.

    ``compute_log=False`` (the trainers' choice) caches mel amplitudes under
    a ``_nolog`` directory; the host transform then takes the dB per clip
    (``transforms.apply_log``).
    """

    def __init__(self, dataset_name: str, base_feature_dir: Optional[str] = None,
                 recompute_features: bool = False, compute_log: bool = False):
        fc = FeatureConfig.urbansed() if dataset_name == "urbansed" else FeatureConfig.dcase()
        self.fc = dataclasses.replace(fc, compute_log=compute_log)
        self.dataset_name = dataset_name
        self.recompute_features = recompute_features
        self.compute_log = compute_log
        self.n_extracted = 0  # clips whose features this object computed
        base = base_feature_dir or osp.join("data", dataset_name, "features")
        ext = "" if compute_log else "_nolog"
        self.feature_dir = osp.join(
            base, f"sr{self.fc.sample_rate}_win{self.fc.n_window}_hop{self.fc.hop_size}"
                  f"_mels{self.fc.n_mels}{ext}")
        os.makedirs(self.feature_dir, exist_ok=True)

    def load_and_compute_mel_spec(self, wav_path: str) -> np.ndarray:
        audio, _ = read_audio(wav_path, self.fc.sample_rate)
        return logmel_numpy(audio, self.fc)

    def _extract(self, wav_path: str, out_path: str) -> bool:
        """Write the clip's features unless they are cached; False when the
        wav cannot be read."""
        if osp.exists(out_path) and not self.recompute_features:
            return True
        try:
            mel = self.load_and_compute_mel_spec(wav_path)
        except OSError:  # a missing or unreadable wav drops the clip
            return False
        os.makedirs(osp.dirname(out_path), exist_ok=True)
        np.save(out_path, mel)
        self.n_extracted += 1
        return True

    def initialize_and_get_df(self, tsv_path: str, audio_dir: Optional[str] = None,
                              nb_files: Optional[int] = None) -> List[Dict]:
        """The TSV's rows (of its first ``nb_files`` distinct clips), each with
        ``feature_filename`` and ``wav_filename``, in the TSV's order; the
        rows of a clip whose wav could not be read are dropped."""
        rows = read_tsv(tsv_path)
        if nb_files is not None:
            keep = set(unique(r["filename"] for r in rows)[:nb_files])
            rows = [r for r in rows if r["filename"] in keep]
        audio_dir = audio_dir or meta_path_to_audio_dir(tsv_path)
        paths = {}
        for fname in unique(r["filename"] for r in rows):
            wav = osp.join(audio_dir, fname)
            out = osp.join(self.feature_dir, osp.splitext(fname)[0] + ".npy")
            if self._extract(wav, out):
                paths[fname] = (out, wav)
        return [dict(r, feature_filename=paths[r["filename"]][0],
                     wav_filename=paths[r["filename"]][1])
                for r in rows if r["filename"] in paths]


def get_dfs(dataset: SedData, paths: Dict[str, str], unlabel_data: bool = False,
            nb_files: Optional[int] = None,
            audio_dirs: Optional[Dict[str, str]] = None) -> Dict[str, List[Dict]]:
    """Each split's rows from ``SedData.initialize_and_get_df``.

    ``paths`` maps a split to its TSV, e.g. {train, validation, eval} for
    URBAN-SED or {weak, synthetic, validation, eval[, unlabel]} for DCASE;
    the ``unlabel`` split is read only with ``unlabel_data``.  ``audio_dirs``
    overrides the metadata -> audio mapping per split (DCASE's
    ``validation.tsv`` lies one directory deeper than its audio).
    """
    out = {}
    for split, tsv in paths.items():
        if split == "unlabel" and not unlabel_data:
            continue
        out[split] = dataset.initialize_and_get_df(
            tsv, audio_dir=(audio_dirs or {}).get(split), nb_files=nb_files)
    return out
