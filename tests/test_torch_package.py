"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points never fall back to the CPU, kernels that are not
ported yet raise, and ``chip_smoke.py`` fails without a GPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.engine import make_eval_step
from sound_event_detection_transformer_tpu_torch.models import build_model, resolve_device
from sound_event_detection_transformer_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    scaled_dot_attention,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sound_event_detection_transformer_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "sound_event_detection_transformer_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    """Top-level names of every absolute import in a file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    # the port's own name starts with the JAX package's, so roots are compared whole
    assert not BANNED & set(_imported_roots(path))


def _run(code_or_args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_runs_without_loading_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from sound_event_detection_transformer_tpu_torch.config import SEDTConfig\n"
        "from sound_event_detection_transformer_tpu_torch.models import build_model\n"
        "cfg = SEDTConfig.tiny_test()\n"
        "model, wd = build_model(cfg, device='cpu')\n"
        "m = cfg.model\n"
        "out = model(torch.zeros(1, m.max_frames, m.n_mels, 1), torch.zeros(1, m.max_frames, dtype=torch.bool))\n"
        "assert out['pred_logits'].shape == (1, m.num_queries, m.num_classes + 1)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        f"{sorted(BANNED)!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SEDTConfig.tiny_test()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model, wd = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(model, wd, cfg, (1,))
    make_eval_step(model, wd, cfg, (1,), device="cpu")


def test_bare_cuda_means_the_current_card(monkeypatch):
    """A model moved to "cuda" sits on cuda:<current>; the step must agree."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_flash_dispatch_raises_until_k4_is_ported():
    q = torch.zeros(1, 2, 4, 8)
    k = torch.zeros(1, 2, FLASH_MIN_SEQ, 8)
    with pytest.raises(NotImplementedError, match="K4"):
        scaled_dot_attention(q, k, k, use_flash=True)
    # the automatic rule picks flash only for CUDA tensors
    assert scaled_dot_attention(q, k, k).shape == (1, 2, 4, 8)


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    proc = _run(["chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = _run(["chip_smoke.py"], alone)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
