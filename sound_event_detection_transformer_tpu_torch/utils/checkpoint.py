"""Checkpoints, the best-model and early-stopping policies, source back-up.

Counterpart of the JAX package's ``utils/checkpoint.py``: one file per state,
written under a temporary name and renamed, so a crash never leaves a
half-written best model.  The format is the port's own (``torch.save`` of
``{"model": state_dict, ...}``); a checkpoint of the JAX package crosses
through ``weights.from_flax``.  The pretrain and audio-tag weight surgery
waits for the SP-SEDT slice (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Save a state dict (tensors, numbers, strings, nested dicts and lists;
    by convention the model's ``state_dict`` under ``"model"``) to ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a state saved by :func:`save_checkpoint`, tensors on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


class SaveBest:
    """Says when a metric reached its best so far (always on the first
    call): "sup" keeps the largest value, "inf" the smallest."""

    def __init__(self, val_comp: str = "sup"):
        if val_comp not in ("inf", "sup"):
            raise ValueError(f"val_comp must be 'inf' or 'sup', not {val_comp!r}")
        self.val_comp = val_comp
        self.best_val = np.inf if val_comp == "inf" else -np.inf
        self.best_epoch = 0
        self.current_epoch = 0

    def apply(self, value: float) -> bool:
        decision = self.current_epoch == 0
        if (self.val_comp == "inf" and value < self.best_val) or (
                self.val_comp == "sup" and value > self.best_val):
            self.best_epoch = self.current_epoch
            self.best_val = value
            decision = True
        self.current_epoch += 1
        return decision

    def state_dict(self):
        return {"best_val": float(self.best_val), "best_epoch": self.best_epoch,
                "current_epoch": self.current_epoch}

    def load_state_dict(self, sd) -> None:
        self.best_val = float(sd["best_val"])
        self.best_epoch = int(sd["best_epoch"])
        self.current_epoch = int(sd["current_epoch"])


class EarlyStopping:
    """Stop once no fusion strategy has improved for ``patience`` epochs,
    and never before ``init_patience`` epochs.  ``apply`` takes one metric at
    a time, the strategies in turn."""

    def __init__(self, patience: int = 50, val_comp: str = "sup", init_patience: int = 50,
                 fusion_strategy=(1,)):
        if val_comp not in ("inf", "sup"):
            raise ValueError(f"val_comp must be 'inf' or 'sup', not {val_comp!r}")
        self.patience = patience
        self.init_patience = init_patience
        self.val_comp = val_comp
        self.fusion_strategy = list(fusion_strategy)
        self.best_val = {m: (np.inf if val_comp == "inf" else -np.inf)
                         for m in self.fusion_strategy}
        self.best_epoch = {m: 0 for m in self.fusion_strategy}
        self.current_epoch = 0
        self._idx = 0

    def apply(self, value: float) -> bool:
        """Feed the next strategy's metric; True means stop."""
        m = self.fusion_strategy[self._idx]
        self._idx = (self._idx + 1) % len(self.fusion_strategy)
        if (self.val_comp == "inf" and value < self.best_val[m]) or (
                self.val_comp == "sup" and value > self.best_val[m]):
            self.best_val[m] = value
            self.best_epoch[m] = self.current_epoch
        if self._idx == 0:
            self.current_epoch += 1
        if self.current_epoch < self.init_patience:
            return False
        return all(self.current_epoch - self.best_epoch[m] > self.patience
                   for m in self.fusion_strategy)

    def state_dict(self):
        return {
            "best_val": {str(m): float(v) for m, v in self.best_val.items()},
            "best_epoch": {str(m): int(v) for m, v in self.best_epoch.items()},
            "current_epoch": self.current_epoch,
            "idx": self._idx,
        }

    def load_state_dict(self, sd) -> None:
        for m in self.fusion_strategy:
            if str(m) in sd["best_val"]:
                self.best_val[m] = float(sd["best_val"][str(m)])
                self.best_epoch[m] = int(sd["best_epoch"][str(m)])
        self.current_epoch = int(sd["current_epoch"])
        self._idx = int(sd["idx"])


def back_up_code(store_dir: str, info: str, src_root: Optional[str] = None) -> str:
    """Copy the port's package source to ``<store_dir>/code_backup/<info>/``."""
    src_root = src_root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(store_dir, "code_backup", info)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src_root, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc", ".git", "exp", "data"))
    return dst
