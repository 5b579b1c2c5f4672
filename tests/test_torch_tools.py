"""The port's measuring tools (``tools/*_torch.py``) on the CPU at the tiny
test size: ``utils.profiler.trace_table`` exact on a hand-written Chrome
trace, ``capture_trace_torch`` writing a trace whose host ops it reads,
``profile_step_torch``'s train step the port's own ``make_train_step`` and
all its rows, the semi and SP-SEDT tools' steps, ``bench_spsedt_bank_torch``'s
two loops returning equal losses, every ``try_remat_torch`` variant at
dropout 0.1 reproducing the baseline's loss, gradients and generator state
(and the naive checkpoint, without the generator fix, failing to), and each
card tool refusing to run without a GPU unless given ``--device cpu``.

On the CPU the tools read the host clock and report no device time; their
numbers on the card come from ``chip_smoke.py`` phase 4k.  This file imports
no JAX: the tools' JAX-side comparisons are in
``tests/test_torch_tools_host.py``.
"""
import concurrent.futures
import dataclasses
import gzip
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_torch import synthetic_batch
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.engine import init_train_state, make_train_step
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.utils import profiler

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT / "tools"))

import bench_spsedt_bank_torch  # noqa: E402
import capture_trace_torch  # noqa: E402
import profile_semi_torch  # noqa: E402
import profile_spsedt_torch  # noqa: E402
import profile_step_torch  # noqa: E402
import trace_report_torch  # noqa: E402
import try_remat_torch  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
CARD_TOOLS = ["profile_step_torch", "profile_semi_torch", "profile_spsedt_torch",
              "capture_trace_torch", "bench_spsedt_bank_torch", "try_remat_torch"]


def _tiny_spsedt() -> SEDTConfig:
    cfg = SEDTConfig.tiny_test()
    return cfg.replace(model=dataclasses.replace(cfg.model, self_sup=True, dec_at=False,
                                                 num_patches=3, feature_recon=True,
                                                 num_classes=1),
                       data=dataclasses.replace(cfg.data, classes=("event",)))


# --------------------------------------------------------------- trace_table


def _event(cat, name, ts, dur, stream=7, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": stream, "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": stream}}


HAND_TRACE = [
    _event("cpu_op", "aten::mm", 80, 50),
    _event("user_annotation", "step 0", 80, 100),
    _event("gpu_user_annotation", "step 0", 90, 80),  # covers the kernels below
    _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 90, 5),
    _event("gpu_memset", "Memset (Device)", 95, 1),
    _event("kernel", "void jv_warp_kernel<1>(float const*, int)", 100, 10),
    _event("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 120, 30),
    _event("kernel", "void at::native::vectorized_elementwise_kernel<4>", 150, 20, stream=13),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 1, "ts": 85, "id": 1},
]


def _write(path, events, gz=False):
    data = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)
    return str(path)


@pytest.mark.parametrize("gz", [False, True], ids=["json", "gz"])
def test_trace_table_is_exact_on_a_hand_written_trace(tmp_path, gz):
    name = "w.1.pt.trace.json" + (".gz" if gz else "")
    path = _write(tmp_path / name, HAND_TRACE, gz)
    assert profiler.find_trace(str(tmp_path)) == path
    t = profiler.trace_table(path)
    assert t["window_ms"] == pytest.approx(0.100, abs=1e-12)  # 80 .. 180 µs
    # the union of the device events: 5 + 1 + 10 + 30 + 20 µs
    assert t["busy_ms"] == pytest.approx(0.066, abs=1e-12)
    s7 = t["planes"]["GPU 0 stream 7"]
    assert s7["total_ms"] == pytest.approx(0.046, abs=1e-12)  # no annotation span
    assert [(k, n) for k, _, _, n in s7["rows"]] == [("matmul", 1), ("hand-written", 1),
                                                     ("copy", 2)]
    for (_, ms, share, _), us in zip(s7["rows"], (30, 10, 6)):
        assert ms == pytest.approx(us / 1e3, abs=1e-12)
        assert share == pytest.approx(us / 46, abs=1e-12)
    assert t["planes"]["GPU 0 stream 13"]["rows"] == [
        ("elementwise and other", pytest.approx(0.020, abs=1e-12), 1.0, 1)]
    assert "host" not in t["planes"]
    raw = profiler.trace_table(path, raw=True, top=2)["planes"]["GPU 0 stream 7"]["rows"]
    assert [k for k, *_ in raw] == ["sm90_xmma_gemm_bf16bf16_bf16f32",
                                    "void jv_warp_kernel<1>(float const*, int)"]
    host = profiler.trace_table(path, all_planes=True)["planes"]["host"]
    assert host["rows"] == [("aten::mm", pytest.approx(0.050, abs=1e-12), 1.0, 1)]
    lines = trace_report_torch.report_lines(t)
    assert "device busy 0.066 ms (66.0%)" in lines[0]
    assert any("x2" in line and "copy" in line for line in lines)


def test_trace_table_raises_without_device_events(tmp_path):
    host_only = [e for e in HAND_TRACE if e["cat"] in ("cpu_op", "user_annotation")]
    path = _write(tmp_path / "h.pt.trace.json", host_only)
    with pytest.raises(RuntimeError, match="no device events"):
        profiler.trace_table(path)
    assert profiler.trace_table(path, all_planes=True)["busy_ms"] == 0.0
    with pytest.raises(FileNotFoundError):
        profiler.find_trace(str(tmp_path / "nothing"))


def test_kernel_kinds_put_the_ports_kernels_first():
    assert profiler.KERNEL_KINDS[0][0] == "hand-written"
    for name in ("void jv_warp_kernel<1>(...)", "jv_block_kernel", "jv_square_kernel",
                 "void flash_mma_kernel<32>", "flash_combine_kernel", "flash_kernel"):
        assert profiler.kernel_kind(name) == "hand-written"
    assert profiler.kernel_kind("Memcpy DtoD") == "copy"
    assert profiler.kernel_kind("sm90_xmma_fprop_implicit_gemm_tf32f32") == "convolution"
    assert profiler.kernel_kind("sm90_xmma_wgrad_implicit_gemm_bf16") == "convolution"
    assert profiler.kernel_kind("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n") == "matmul"
    assert profiler.kernel_kind("ampere_bf16_s16816gemm_bf16_128x64") == "matmul"
    rows = [("jv_warp_kernel", 30.0, 3), ("ampere_gemm", 600.0, 6), ("add_kernel", 90.0, 9)]
    assert profiler.kernel_kinds(rows, 3) == {"matmul": (0.2, 2),
                                              "elementwise and other": (0.03, 3),
                                              "hand-written": (0.01, 1)}


# --------------------------------------------------------- the step tools


@pytest.fixture(scope="module")
def tiny_setup():
    return profile_step_torch.train_setup(SEDTConfig.tiny_test(), CPU)


def test_capture_trace_writes_a_trace_of_the_host(tiny_setup, tmp_path):
    path = capture_trace_torch.capture(tiny_setup.run, str(tmp_path / "t"), iters=2, warmup=1)
    assert path.endswith(".pt.trace.json") and os.path.dirname(path) == str(tmp_path / "t")
    host = profiler.trace_table(path, all_planes=True, top=1000)["planes"]["host"]
    names = {k for k, *_ in host["rows"]}
    assert "aten::convolution" in names and "aten::addmm" in names
    with pytest.raises(RuntimeError, match="no device events"):
        profiler.trace_table(path)
    with pytest.raises(ValueError, match="on the device"):
        capture_trace_torch.main(["--spsedt", "--host_patches", "--device", "cpu"])


def test_profile_step_takes_the_ports_train_step_and_every_row():
    cfg = SEDTConfig.tiny_test()
    model, wd = build_model(cfg, device=CPU, generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, cfg, 100)
    step = make_train_step(model, wd, cfg, state.optimizer, device=CPU)
    want = step(synthetic_batch(cfg, cfg.data.batch_size), torch.Generator().manual_seed(1))
    s = profile_step_torch.train_setup(cfg, CPU)
    assert float(s.run()["loss"]) == float(want["loss"])
    rows = profile_step_torch.step_rows(s, iters=1)
    assert list(rows) == ["train_step", "forward_eval", "forward_plus_criterion",
                          "matcher_batch", "forward_backward", "optimizer_update", "backbone",
                          "criterion_only", "backward_plus_update"]
    for name, r in rows.items():
        assert math.isfinite(r.ms) and r.device_ms is None, (name, r)
        assert r.ms > 0 or name == "backward_plus_update", (name, r)
    assert rows["train_step"].calls == rows["criterion_only"].calls == 4
    assert rows["backward_plus_update"].calls == 0
    assert set(profile_step_torch.K1_ROWS) <= set(rows)


def test_profile_step_main_at_its_tiny_geometry(capsys):
    rows = profile_step_torch.main(["--device", "cpu", "--tiny", "--step_only", "--batch", "2",
                                    "--iters", "1", "--dropout", "0"])
    assert list(rows) == ["train_step"]
    out = capsys.readouterr().out
    assert "batch=2 dtype=float32 dropout=0.0" in out and "device not measured" in out


def test_profile_semi_steps_and_splits_at_tiny_size():
    s = profile_semi_torch.semi_setup(SEDTConfig.tiny_test(), CPU)
    assert s.n_lab == 2 and [int(f.sum()) for f in s.flags] == [1, 1, 2]
    assert not s.batch.targets.box_valid[2:].any()
    step = profiler.measure(s.run, 1, CPU, warmup=1)
    parts = profile_semi_torch.components(s, step)
    assert list(parts)[:3] == ["teacher fwd (unlabeled half, deterministic)",
                               "pseudo-labels (postprocess + same-class NMS)",
                               "remainder (sup fwd + student fwd + bwd + opt + EMA)"]
    assert {"part backward", "part EMA", "part clip and AdamW"} <= set(parts)
    assert all(math.isfinite(v) for v in parts.values())


def test_profile_spsedt_batch_and_step_at_tiny_size():
    cfg = _tiny_spsedt()
    s = profile_spsedt_torch.spsedt_setup(cfg, CPU)
    boxes, valid = s.batch.targets.boxes, s.batch.targets.box_valid
    assert valid[:, :3].all() and not valid[:, 3:].any() and not boxes[:, 3:].any()
    assert ((boxes[:, :3, 0] >= 0.1) & (boxes[:, :3, 0] <= 0.9)).all()
    assert math.isfinite(float(s.run()["loss"]))
    big = profile_spsedt_torch.spsedt_config()
    assert (big.data.batch_size, big.model.num_patches, big.model.enc_layers,
            big.model.dec_layers, big.model.num_queries) == (200, 10, 6, 6, 20)


def test_spsedt_bank_loops_return_equal_losses():
    cfg = _tiny_spsedt()
    s = profile_step_torch.train_setup(cfg, CPU, augment_on=False)
    ds = bench_spsedt_bank_torch.make_dataset(cfg, 12)
    batches = bench_spsedt_bank_torch.index_batches(len(ds), cfg.data.batch_size, 4)
    assert batches[3] == batches[0] == [0, 1, 2, 3]
    bank = bench_spsedt_bank_torch.FeatureBank(ds, CPU)
    before = {k: v.clone() for k, v in s.model.state_dict().items()}
    inline, banked = bench_spsedt_bank_torch.same_losses(s, ds, bank, batches)
    assert torch.equal(inline, banked) and len(inline) == 4
    assert torch.isfinite(inline).all() and inline[0] != inline[3]  # the weights moved
    assert all(torch.equal(v, before[k]) for k, v in s.model.state_dict().items())


# ------------------------------------------------------------------ remat


@pytest.fixture(scope="module")
def remat_setup():
    cfg = SEDTConfig.tiny_test()
    assert cfg.model.dropout == 0.1
    s = profile_step_torch.train_setup(cfg, CPU)
    return s, try_remat_torch.first_step(s, "baseline")


@pytest.mark.parametrize("variant", try_remat_torch.VARIANTS[1:])
def test_remat_variant_reproduces_the_baseline_step(remat_setup, variant):
    s, ref = remat_setup
    d = try_remat_torch.compare(ref, try_remat_torch.first_step(s, variant))
    assert d["loss"] <= try_remat_torch.LOSS_RTOL and d["grad"] <= try_remat_torch.GRAD_TOL, d
    assert d["same_generator"] and d["same_leaves"], d
    ref_gen = torch.Generator().manual_seed(1)
    assert not torch.equal(ref["gen"], ref_gen.get_state())  # the step drew its masks


@pytest.mark.parametrize("variant", try_remat_torch.VARIANTS[1:])
def test_naive_checkpoint_draws_other_masks(remat_setup, variant):
    """Without the generator fix the recompute draws from the advanced step
    generator: the forward (and the loss) is the baseline's, the backward
    runs through other masks and the generator moves twice."""
    s, ref = remat_setup
    d = try_remat_torch.compare(ref, try_remat_torch.first_step(s, variant,
                                                                fix_generator=False))
    assert d["loss"] <= try_remat_torch.LOSS_RTOL, d
    assert d["grad"] > 0.1 and not d["same_generator"], d


def test_remat_timing_runs_every_variant(remat_setup):
    s, _ = remat_setup
    timed = try_remat_torch.time_variants(s, iters=1)
    assert list(timed) == list(try_remat_torch.VARIANTS)
    assert all(r.ms > 0 and r.device_ms is None and peak is None for r, peak in timed.values())


# ------------------------------------------------------- no card, no run


@pytest.mark.parametrize("tool", CARD_TOOLS)
def test_card_tool_needs_a_device_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(profile_step_torch, "build_model", lambda *a, **k: built.append(1))
    monkeypatch.setattr(profile_semi_torch, "build_model", lambda *a, **k: built.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sys.modules[tool].main([])
    assert not built


def test_tools_run_as_scripts():
    """From the repository's root, as the README says: every card tool
    without a GPU exits non-zero with "no CUDA device", and the trace report
    starts."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    cmds = [[f"tools/{t}.py"] for t in CARD_TOOLS] + [["tools/trace_report_torch.py", "--help"]]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        procs = list(pool.map(lambda c: subprocess.run(
            [sys.executable, *c], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300), cmds))
    for cmd, p in zip(cmds[:-1], procs[:-1]):
        assert p.returncode != 0 and "no CUDA device" in p.stderr, (cmd, p.stderr[-2000:])
        assert p.stdout == "", cmd
    assert procs[-1].returncode == 0 and "--all_planes" in procs[-1].stdout


def test_remat_policies_name_the_ops_they_save():
    aten = torch.ops.aten
    dots, drop = try_remat_torch._dots_policy, try_remat_torch._dropmask_policy
    save, recompute = (try_remat_torch.CheckpointPolicy.MUST_SAVE,
                       try_remat_torch.CheckpointPolicy.PREFER_RECOMPUTE)
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default, aten.convolution.default):
        assert dots(None, op) == save and drop(None, op) == save
    for op in (aten.rand.generator, aten.rand.default, aten.lt.Scalar):
        assert dots(None, op) == recompute and drop(None, op) == recompute
    assert dots(None, aten.add.Tensor) == recompute and drop(None, aten.add.Tensor) == save
    assert try_remat_torch.VARIANTS == ("baseline", "nothing", "dots", "dropmask")
