"""Boundaries of the PyTorch port: it imports nothing of JAX, of the JAX
package, of ``tools/`` (whose wav writer imports the JAX package's config)
or pandas (which the card's machine lacks), at module level or inside a
function; its entry points never
fall back to the CPU, every kernel's wrapper
dispatches (none raises "not ported"), and ``chip_smoke.py`` fails without a
GPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sound_event_detection_transformer_tpu_torch.cli import (
    at_args,
    main_at,
    main_semi,
    main_sedt,
    main_spsedt,
    sedt_args,
    semi_args,
    spsedt_args,
)
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.engine import (
    init_train_state,
    make_eval_step,
    make_semi_train_step,
    make_train_step,
)
from sound_event_detection_transformer_tpu_torch.models import build_model, resolve_device
from sound_event_detection_transformer_tpu_torch.ops import _build, attention
from sound_event_detection_transformer_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    scaled_dot_attention,
)
from sound_event_detection_transformer_tpu_torch.train_lib import (
    run_audio_tag,
    run_semi,
    run_spsedt,
    run_supervised,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sound_event_detection_transformer_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "sound_event_detection_transformer_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "predict_torch.py",
                                        ROOT / "bench_torch.py", ROOT / "train_sedt_torch.py",
                                        ROOT / "train_spsedt_torch.py",
                                        ROOT / "train_ss_sedt_torch.py",
                                        ROOT / "train_at_torch.py",
                                        ROOT / "tools" / "time_jv_kernels.py"]


def _imported_roots(path: Path):
    """Top-level names of every absolute import in a file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    # the port's own name starts with the JAX package's, so roots are compared whole;
    # every import statement counts, a function's too
    assert not (BANNED | {"pandas", "tools"}) & set(_imported_roots(path))


def test_import_scan_sees_function_level_imports(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("import csv\n\ndef f():\n    import pandas as pd\n"
                    "    from tools.make_wav_dataset import synth_clip\n")
    assert set(_imported_roots(path)) == {"csv", "pandas", "tools"}


def test_the_disk_path_modules_are_scanned():
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"data/tsv.py", "data/transforms.py", "data/collapse_event.py", "data/features.py",
            "data/wav_dataset.py", "data/dataset.py", "models/torch_import.py",
            "train_lib.py", "ops/patches.py", "models/sedt.py", "cli.py", "engine.py",
            "config.py", "models/criterion.py"} <= names


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
        "from sound_event_detection_transformer_tpu_torch import cli, engine, metrics, predict_cli, train_lib\n"
        "from sound_event_detection_transformer_tpu_torch.data import dataset, feature_bank\n"
        "from sound_event_detection_transformer_tpu_torch.data import collapse_event, features, transforms, tsv, wav_dataset\n"
        "from sound_event_detection_transformer_tpu_torch.models import torch_import\n"
        "from sound_event_detection_transformer_tpu_torch.ops import augment, dropout, patches\n"
        "from sound_event_detection_transformer_tpu_torch.parallel import optim\n"
        "from sound_event_detection_transformer_tpu_torch.utils import checkpoint\n"
        "import bench_torch, predict_torch, train_sedt_torch, train_spsedt_torch, train_ss_sedt_torch\n"
        "import train_at_torch\n"
        "cfg = SEDTConfig.tiny_test()\n"
        "model, wd = build_model(cfg, device='cpu')\n"
        "m = cfg.model\n"
        "out = model(torch.zeros(1, m.max_frames, m.n_mels, 1), torch.zeros(1, m.max_frames, dtype=torch.bool))\n"
        "assert out['pred_logits'].shape == (1, m.num_queries, m.num_classes + 1)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        f"{sorted(BANNED | {'pandas'})!r}]\n"
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
    state = init_train_state(model, cfg, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, wd, cfg, state.optimizer)
    make_train_step(model, wd, cfg, state.optimizer, device="cpu")
    argv = ["--dataname", "urbansed", "--synthetic_smoke", "--log"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_supervised(sedt_args(argv))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_sedt(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_spsedt(spsedt_args(argv))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_spsedt(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_semi_train_step(wd, cfg)
    make_semi_train_step(wd, cfg, device="cpu")
    argv = ["--dataname", "dcase", "--synthetic_smoke", "--log"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_semi(semi_args(argv))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_semi(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_audio_tag(at_args(argv))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_at(argv)


def test_bare_cuda_means_the_current_card(monkeypatch):
    """A model moved to "cuda" sits on cuda:<current>; the step must agree."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_flash_dispatch_raises_until_k4_is_ported(monkeypatch):
    """K4 is ported, so the dispatch that used to raise now runs: forced on
    CPU tensors it takes the kernel's plain blockwise version, the automatic
    rule leaves CPU tensors on the non-flash path, and attention dropout (now
    ported) stays on the non-flash path and needs a generator."""
    calls = []
    real = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a: (calls.append(a[1].shape[-2]), real(*a))[1])
    rng = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 4, 8, generator=rng)
    k = torch.randn(1, 2, FLASH_MIN_SEQ, 8, generator=rng)
    flash = scaled_dot_attention(q, k, k, use_flash=True)
    assert calls == [FLASH_MIN_SEQ]
    # the automatic rule picks flash only for CUDA tensors
    plain = scaled_dot_attention(q, k, k)
    assert calls == [FLASH_MIN_SEQ] and plain.shape == (1, 2, 4, 8)
    torch.testing.assert_close(flash, plain, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        scaled_dot_attention(q, k, k, dropout_rate=0.1)
    dropped = scaled_dot_attention(q, k, k, dropout_rate=0.1,
                                   generator=torch.Generator().manual_seed(1))
    assert calls == [FLASH_MIN_SEQ] and dropped.shape == plain.shape
    for path in (PORT / "ops" / "attention.py", PORT / "ops" / "hungarian.py"):
        assert "not ported" not in path.read_text()


def test_every_cuda_source_is_listed_for_the_build():
    """``python3 chip_smoke.py`` alone builds every source under csrc/."""
    assert sorted(p.stem for p in (PORT / "csrc").glob("*.cu")) == sorted(_build.SOURCES)
    for name in _build.SOURCES:
        text = (PORT / "csrc" / f"{name}.cu").read_text()
        assert 'extern "C"' in text and "torch/extension.h" not in text


def test_kernel_builds_raise_without_nvcc(monkeypatch, tmp_path):
    """No fallback: a build that cannot run raises and leaves nothing behind."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises((RuntimeError, OSError)):
        _build.build_library("hungarian_jv")
    assert not list((tmp_path / "kernels").glob("*.so"))


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
