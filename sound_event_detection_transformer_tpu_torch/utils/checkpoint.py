"""Checkpoint save and load.

Counterpart of ``save_checkpoint`` / ``load_checkpoint`` of the JAX package's
``utils/checkpoint.py``: one file per state, written under a temporary name
and renamed, so a crash never leaves a half-written best model.  The format
is the port's own (``torch.save`` of ``{"model": state_dict, ...}``); a
checkpoint of the JAX package crosses through ``weights.from_flax``.  The
weight surgery, ``SaveBest``, ``EarlyStopping`` and ``back_up_code`` wait for
the trainer slice.
"""
from __future__ import annotations

import os
from typing import Any, Dict

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
