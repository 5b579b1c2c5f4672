"""AST (``models/ast.AST``) on the port's audio-tag trainer, against the
benchmark's plain reference (``benchmark/reference/ast.py``), on the CPU.

* On seeded random weights at a small size (2 layers, d 64, 4 heads, 12
  classes, a 96-frame x 64-bin input, 47 tokens): the logits, every leaf's
  gradient of the mean BCE, and every leaf after two steps of the port's
  AST optimizer against the reference's Adam.  Both sides compute in f32 on
  the CPU, so what is left is the order of sums: the logits and gradients
  agree to a relative 1e-5 of each tensor's largest entry, the losses to
  1e-5, and after two steps every entry to 1e-5 absolute against steps of
  about the lr, 1e-3, where both its gradients lie above 1e-6.  Adam turns
  the round-off of a gradient near its eps (1e-8), such as the key bias's,
  whose exact gradient is 0, into a step of up to the lr: those entries are
  held to the two steps' reach, 2 lr.
* The same with ``use_flash=True`` at 602 keys (a 512 x 128 input): K4's
  plain blockwise version forward and its recompute backward.
* At the published geometry, from shapes alone: 12 x 101 patches in
  frequency-major order, 1,212 + 2 tokens, 86,594,063 parameters.
* The trainer: ``--at_model ast --synthetic_smoke`` finishes an epoch on the
  CPU at a tiny geometry through ``run_audio_tag`` (one K4 recompute a layer
  a step when K4 is forced), and so does ``--at_model ast`` on a seeded
  URBAN-SED layout on disk; ``--at_model resnet`` keeps today's defaults;
  the step's autocast dtype, AST's lr schedule, and the K4 counters and
  span.
"""
import functools

import numpy as np
import pytest
import torch

from benchmark.reference import ast as RA
from benchmark.reference.params import make_weights
from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.data import wav_dataset
from sound_event_detection_transformer_tpu_torch.models import AST, AUDIOSET, ASTConfig
from sound_event_detection_transformer_tpu_torch.models import ast as ast_module
from sound_event_detection_transformer_tpu_torch.ops import flash_attention as fa
from sound_event_detection_transformer_tpu_torch.ops.attention import scaled_dot_attention
from sound_event_detection_transformer_tpu_torch.parallel.optim import (
    AST_BETAS, AST_WEIGHT_DECAY, halving_lr, make_ast_optimizer)
from sound_event_detection_transformer_tpu_torch.utils import profiler

SMALL = {"n_mels": 64, "frames": 96, "num_classes": 12, "dim": 64, "heads": 4, "layers": 2,
         "mlp": 128}
LONG = dict(SMALL, n_mels=128, frames=512)  # 12 x 50 patches: 602 keys, K4's side of 512
LR = 1e-3
STEADY_GRAD = 1e-6  # 100 Adam eps: a gradient this far from 0 keeps its step's sign


def settings(geometry):
    c = ASTConfig(**geometry)
    return c, {**geometry, "patch": c.patch, "fstride": c.fstride, "tstride": c.tstride,
               "eps": c.eps}


def force_k4(monkeypatch):
    """Every AST attention through K4 (its plain blockwise version on the CPU)."""
    monkeypatch.setattr(ast_module, "scaled_dot_attention",
                        functools.partial(scaled_dot_attention, use_flash=True))


def both_sides(geometry, batch=3, seed=11):
    """The port's AST and the reference on the same seeded weights and batch:
    (model, reference params, reference settings, x, y)."""
    c, m = settings(geometry)
    model = AST(c)
    weights = make_weights(RA.param_spec(m), seed, torch.device("cpu"))
    model.load_state_dict(weights, strict=True)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, c.frames, c.n_mels, generator=g) * 0.5
    y = (torch.rand(batch, c.num_classes, generator=g) < 0.2).float()
    return model, weights, m, x, y


def backward_calls():
    """(K4 backward calls, recomputes): every backward opens the
    ``attention.backward`` span; on the CPU it runs the plain blockwise
    backward, so no call recomputes."""
    return (profiler.SPANS.totals().get("attention.backward", (0, 0.0))[0],
            fa.flash_attention.recomputes)


def close(got, want, rel):
    scale = want.abs().max().clamp(min=1e-30)
    assert float((got - want).abs().max() / scale) < rel


@pytest.mark.parametrize("geometry, use_flash", [(SMALL, False), (LONG, True)],
                         ids=["plain", "k4_plain_blockwise"])
def test_logits_and_gradients_match_the_reference(geometry, use_flash, monkeypatch):
    if use_flash:
        force_k4(monkeypatch)
    model, weights, m, x, y = both_sides(geometry)
    calls, recomputes = backward_calls()
    logits = model(x)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(logits, y)
    loss.backward()
    assert backward_calls() == (calls + (m["layers"] if use_flash else 0), recomputes)
    leaves = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    ref = RA.forward(leaves, x, m)
    ref_loss = torch.nn.functional.binary_cross_entropy_with_logits(ref, y)
    ref_grads = dict(zip(leaves, torch.autograd.grad(ref_loss, list(leaves.values()))))
    close(logits.detach(), ref.detach(), 1e-5)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        close(p.grad, ref_grads[name], 1e-5)


def test_two_optimizer_steps_match_the_reference():
    model, weights, m, x, y = both_sides(SMALL)
    opt = make_ast_optimizer(model, LR, steps_per_epoch=10)
    step = train_lib.make_audio_tag_step(model, opt)
    params = {n: w.clone() for n, w in weights.items()}
    config = {"model": m, "optimizer": {"lr": LR, "betas": list(AST_BETAS), "eps": 1e-8,
                                        "weight_decay": AST_WEIGHT_DECAY}}
    ref_opt = RA.Adam(params, config["optimizer"])
    steady = {n: torch.ones_like(w, dtype=torch.bool) for n, w in weights.items()}
    for k in range(2):
        xs, ys = x[k:k + 2], y[k:k + 2]
        loss = step(xs, ys)
        ref_loss, seen = RA.train_step(params, ref_opt, xs, ys, config)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        for n, g in seen.items():
            steady[n] &= g.abs() > STEADY_GRAD
    for name, p in model.named_parameters():
        gap = (p.detach() - params[name]).abs()
        assert float(torch.where(steady[name], gap, 0.0).max()) < 1e-5, name
        assert float(gap.max()) <= 2 * LR * 1.01, name
        assert float((p.detach() - weights[name]).abs().max()) > 1e-4, name  # every leaf moved


def test_published_geometry_tokens_and_order_from_shapes():
    assert AUDIOSET.grid == (12, 101) and AUDIOSET.tokens == 1214
    with torch.device("meta"):
        model = AST(AUDIOSET)
        tokens = model.v.patch_embed(torch.empty(2, 1, 128, 1024))
    assert tuple(tokens.shape) == (2, 1212, 768)
    assert tuple(model.v.pos_embed.shape) == (1, 1214, 768)
    assert sum(p.numel() for p in model.parameters()) == 86_594_063
    # one channel that reads each patch's first (frequency, time) bin: token
    # i is the patch at frequency i // 101, time i % 101
    embed = AST(ASTConfig(dim=1, heads=1, layers=0, mlp=1)).v.patch_embed
    with torch.no_grad():
        embed.proj.weight.zero_()
        embed.proj.weight[0, 0, 0, 0] = 1.0
        embed.proj.bias.zero_()
    f, t = torch.meshgrid(torch.arange(128.0), torch.arange(1024.0), indexing="ij")
    got = embed((f * 10000 + t)[None, None])[0, :, 0]
    i = torch.arange(1212)
    assert torch.equal(got, ((i // 101) * 10 * 10000 + (i % 101) * 10).float())


def test_the_step_autocasts_ast_only():
    args = cli.at_args(["--at_model", "ast"])
    cfg, ast = train_lib.audio_tag_ast(args, train_lib.args_to_config(args))
    assert train_lib.audio_tag_dtype(cfg, ast) == torch.bfloat16
    assert train_lib.audio_tag_dtype(cfg, None) is None  # the ResNet tagger: f32
    f32 = cli.at_args(["--at_model", "ast", "--compute_dtype", "float32"])
    assert train_lib.audio_tag_dtype(train_lib.args_to_config(f32), ast) is None
    model = AST(ASTConfig(**SMALL))
    seen = []
    model.mlp_head.register_forward_hook(lambda _m, _a, out: seen.append(out.dtype))
    step = train_lib.make_audio_tag_step(model, make_ast_optimizer(model, LR, 1), torch.bfloat16)
    loss = step(torch.randn(2, 96, 64, 1), torch.zeros(2, 12))
    assert seen == [torch.bfloat16] and loss.dtype == torch.float32


def test_at_model_flags():
    resnet = cli.at_args([])
    assert (resnet.at_model, resnet.lr) == ("resnet", 1e-4)
    assert resnet.pooling == "avg" and resnet.info == "at_avg_dcase"
    assert train_lib.audio_tag_ast(resnet, train_lib.args_to_config(resnet))[1] is None
    assert cli.at_args(["--at_model", "resnet", "--lr", "3e-4"]).lr == 3e-4
    ast = cli.at_args(["--at_model", "ast"])
    assert (ast.at_model, ast.lr) == ("ast", 1e-5)
    assert cli.at_args(["--at_model", "ast", "--lr", "3e-4"]).lr == 3e-4
    cfg, c = train_lib.audio_tag_ast(ast, train_lib.args_to_config(ast))
    # from disk AST takes the data's geometry (DCASE here) and keeps its widths
    assert c == ASTConfig(n_mels=cfg.model.n_mels, frames=cfg.model.max_frames, num_classes=10)
    smoke = cli.at_args(["--at_model", "ast", "--synthetic_smoke"])
    cfg, c = train_lib.audio_tag_ast(smoke, train_lib.args_to_config(smoke))
    assert c == AUDIOSET and len(cfg.data.classes) == 527  # the clips take AST's
    assert (cfg.model.max_frames, cfg.model.n_mels) == (1024, 128)


def test_ast_epoch_on_synthetic_clips(tmp_path, monkeypatch):
    """``train_at_torch.py --at_model ast --synthetic_smoke`` at a tiny
    geometry (AST's settings patched): two epochs through ``run_audio_tag``,
    K4's plain version forced in every attention, a checkpoint that loads
    into AST."""
    monkeypatch.setattr(train_lib, "AUDIOSET", ASTConfig(**SMALL))
    force_k4(monkeypatch)
    calls, recomputes = backward_calls()
    argv = ["--at_model", "ast", "--synthetic_smoke", "--smoke_clips", "8", "--batch_size", "4", "--epochs", "2", "--log",
            "--exp_root", str(tmp_path / "exp")]
    result = cli.main_at(argv, device="cpu")
    assert [e["steps"] for e in result.epochs] == [2, 2]
    assert all(np.isfinite(e["loss"]) for e in result.epochs)
    assert backward_calls() == (calls + 2 * 2 * SMALL["layers"], recomputes)
    assert result.checkpoint.endswith("at_ast_dcase")
    state = torch.load(result.checkpoint, weights_only=False)["model"]
    AST(ASTConfig(**SMALL)).load_state_dict(state, strict=True)


def test_ast_epoch_on_a_dataset_from_disk(tmp_path, monkeypatch):
    """``train_at_torch.py --at_model ast`` on a seeded URBAN-SED layout
    written by ``data/wav_dataset.py`` (6 training clips at batch 3, 4
    validation clips): AST takes the data's 500 x 64 geometry and 10 classes
    and keeps its (here tiny) widths; one epoch of 2 steps."""
    widths = {k: SMALL[k] for k in ("dim", "heads", "layers", "mlp")}
    monkeypatch.setattr(train_lib, "AUDIOSET", ASTConfig(**widths))
    wav_dataset.write_urbansed(str(tmp_path / "data"), train=6, validate=4, test=2, seed=5)
    argv = ["--at_model", "ast", "--dataname", "urbansed", "--data_root", str(tmp_path / "data"),
            "--batch_size", "3", "--epochs", "1", "--log", "--exp_root", str(tmp_path / "exp")]
    result = cli.main_at(argv, device="cpu")
    assert result.epochs[0]["steps"] == 2 and np.isfinite(result.epochs[0]["loss"])
    assert result.checkpoint.endswith("at_ast_urbansed")
    state = torch.load(result.checkpoint, weights_only=False)["model"]
    AST(ASTConfig(n_mels=64, frames=500, num_classes=10, **widths)).load_state_dict(state,
                                                                                  strict=True)


def test_halving_schedule():
    sched = halving_lr(1e-5, 2, steps_per_epoch=3)
    assert [sched(s) for s in (0, 5, 6, 9, 12)] == [1e-5, 1e-5, 5e-6, 2.5e-6, 1.25e-6]
    opt = make_ast_optimizer(AST(ASTConfig(**SMALL)), 1e-5, 3)
    assert opt.clip_max_norm is None and isinstance(opt.adamw, torch.optim.Adam)
    group = opt.adamw.param_groups[0]
    assert (group["betas"], group["weight_decay"]) == (AST_BETAS, AST_WEIGHT_DECAY)


def test_k4_backward_counts_and_opens_its_span():
    q, k, v = (torch.randn(1, 2, 8, 16, requires_grad=True) for _ in range(3))
    calls, recomputes = backward_calls()
    launches = fa.flash_attention.backward_launches
    fa.flash_attention(q, k, v).sum().backward()
    assert backward_calls() == (calls + 1, recomputes)  # the plain backward on the CPU
    assert fa.flash_attention.backward_launches == launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fa.flash_attention(q, k, v).sum().backward()
    assert any(e.name == "attention.backward" for e in prof.events())
