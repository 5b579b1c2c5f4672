"""FrozenBN folded into its convolution in the port's ResNet.

The blocks compute ``bn(conv(x, W))`` as ``conv(x, W * w) + b``, with
``(w, b)`` and a frozen convolution's ``W * w`` cached.  Held here on the
CPU: the outputs and the trained convolutions' gradients against the
unfolded formula, which this file writes out itself; the cache against
every way its sources change (a load, the mean teacher's EMA, a deep copy,
inference mode); the state dict's names; and the count of aten operations
of a ResNet-50 pass, so that a per-call rebuild of the constants cannot come
back unseen.
"""
import collections
import copy

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference import params as RP
from sound_event_detection_transformer_tpu_torch import engine
from sound_event_detection_transformer_tpu_torch.models import resnet as R
from sound_event_detection_transformer_tpu_torch.parallel.optim import ema_update, param_label

ARCHS = ("resnet18", "resnet50", "audio_tag")
BF16 = 0.03  # of the output's largest entry: two bf16 roundings of a 16-block trunk


def _seed_buffers(model: torch.nn.Module, seed: int) -> None:
    """Non-trivial FrozenBN statistics, in the benchmark's ranges (scale and
    var in 0.8-1.2, bias and mean in +-0.1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, R.FrozenBatchNorm):
                for name, lo, hi in (("scale", 0.8, 1.2), ("var", 0.8, 1.2),
                                     ("bias", -0.1, 0.1), ("mean", -0.1, 0.1)):
                    buf = getattr(mod, name)
                    buf.copy_(lo + (hi - lo) * torch.rand(buf.shape, generator=g))


def _build(arch: str, seed: int = 0):
    """The model, seeded; a backbone under the trainer's freeze policy (the
    audio-tag trainer freezes nothing)."""
    torch.manual_seed(seed)
    if arch == "audio_tag":
        model = R.AudioTagBackbone("resnet50", pooling="avg", logits_out=True)
    else:
        model = R.ResNetBackbone(arch, dilation=True)
        for n, p in model.named_parameters():
            if param_label(f"backbone.{n}") == "frozen":
                p.requires_grad_(False)
    _seed_buffers(model, seed + 1)
    return model


def _unfolded_backbone(m: R.ResNetBackbone, x: torch.Tensor) -> torch.Tensor:
    """The trunk as it was before the fold: each convolution, then FrozenBN's
    multiply-add over its output."""

    def conv_bn(conv, bn, h):
        h = conv(h)
        w = bn.scale * torch.reciprocal(torch.sqrt(bn.var + R.BN_EPS))
        b = bn.bias - bn.mean * w
        return h * w.to(h.dtype)[:, None, None] + b.to(h.dtype)[:, None, None]

    x = x.permute(0, 3, 1, 2)
    x = F.relu(conv_bn(m.conv1, m.bn1, m.conv0(x)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for name in m.block_names:
        blk = getattr(m, name)
        out = F.relu(conv_bn(blk.conv1, blk.bn1, x))
        if isinstance(blk, R.Bottleneck):
            out = F.relu(conv_bn(blk.conv2, blk.bn2, out))
            out = conv_bn(blk.conv3, blk.bn3, out)
        else:
            out = conv_bn(blk.conv2, blk.bn2, out)
        sc = conv_bn(blk.downsample_conv, blk.downsample_bn, x) if blk.has_downsample else x
        x = F.relu(out + sc)
    return x.permute(0, 2, 3, 1)


def _unfolded(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(model, R.AudioTagBackbone):
        pooled = _unfolded_backbone(model.backbone, x).mean(dim=(1, 2))
        return model.fc2(F.relu(model.fc1(pooled)))
    return _unfolded_backbone(model, x)


def _input(seed: int = 5) -> torch.Tensor:
    return torch.randn(2, 64, 32, 1, generator=torch.Generator().manual_seed(seed))


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference over ``b``'s largest entry."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def _conv_weights(model: torch.nn.Module):
    return {n: p for n, p in model.named_parameters() if n.endswith(".weight") and p.dim() == 4}


def _grads(model, fn, x):
    model.zero_grad(set_to_none=True)
    out = fn(x)
    (out.float() * torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)).sum().backward()
    return out.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fold_matches_unfolded_f32(arch, grad):
    """f32: outputs and every trained convolution's gradient within 1e-5 of
    the largest entry; frozen parameters get no gradient."""
    model = _build(arch)
    x = _input()
    if not grad:
        with torch.no_grad():
            got, want = model(x), _unfolded(model, x)
        assert _gap(got, want) < 1e-5
        return
    got, g_fold = _grads(model, model, x)
    want, g_ref = _grads(model, lambda t: _unfolded(model, t), x)
    assert _gap(got, want) < 1e-5
    weights = _conv_weights(model)
    trained = [n for n, p in weights.items() if p.requires_grad]
    assert trained
    for n in trained:
        assert _gap(g_fold[n], g_ref[n]) < 1e-5, n
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert g_fold[n] is None, n
    if arch == "audio_tag":
        assert len(trained) == len(weights)  # every convolution trains
    else:
        assert g_fold["conv1.weight"] is None and g_fold["layer1_0.conv1.weight"] is None


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fold_matches_unfolded_bf16(arch, grad):
    """Under bf16 autocast the folded output is bf16, within bf16's rounding
    of the unfolded one, and no further from the f32 result than it (by half
    again, or by 2^-7 of the largest entry, bf16's step: the audio-tag
    model's 20 logits are too few for the ratio alone)."""
    model = _build(arch)
    x = _input()
    with torch.no_grad():
        exact = _unfolded(model, x)
    with torch.set_grad_enabled(grad), torch.autocast("cpu", dtype=torch.bfloat16):
        got, want = model(x), _unfolded(model, x)
    if arch != "audio_tag":
        assert got.dtype == torch.bfloat16
    assert _gap(got, want) < BF16
    assert _gap(got, exact) <= max(1.5 * _gap(want, exact), 2.0 ** -7)


def test_frozen_bn_alone_matches_formula():
    """The module's own forward still computes the multiply-add."""
    bn = R.FrozenBatchNorm(8)
    _seed_buffers(bn, 3)
    x = torch.randn(2, 8, 5, 4)
    w = bn.scale * torch.reciprocal(torch.sqrt(bn.var + R.BN_EPS))
    want = x * w[:, None, None] + (bn.bias - bn.mean * w)[:, None, None]
    assert torch.equal(bn(x), want)
    assert torch.equal(bn(x), want)


def _since(before: collections.Counter):
    return {k: R.FOLDS[k] - before[k] for k in ("wb_reused", "wb_rebuilt", "weight_reused",
                                                "weight_rebuilt")}


def _n_bn(model):
    return sum(isinstance(m, R.FrozenBatchNorm) for m in model.modules())


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_second_pass_reuses_every_fold(grad):
    """A second pass with nothing changed rebuilds nothing; under grad mode
    only the frozen convolutions' weights are cached."""
    model = _build("resnet50")
    x = _input()
    with torch.set_grad_enabled(grad):
        model(x)
        before = R.FOLDS.copy()
        model(x)
    n = _n_bn(model)
    frozen = sum(not p.requires_grad for p in _conv_weights(model).values())
    assert (n, frozen) == (53, 11)
    cached = frozen if grad else n
    assert _since(before) == {"wb_reused": n, "wb_rebuilt": 0, "weight_reused": cached,
                              "weight_rebuilt": 0}


def test_load_state_dict_rebuilds():
    """New buffers and weights from ``load_state_dict``: rebuilt, and the
    output is the unfolded one of the new state."""
    model = _build("resnet50")
    x = _input()
    with torch.no_grad():
        model(x)
    other = _build("resnet50", seed=7)
    model.load_state_dict(other.state_dict(), strict=True)
    before = R.FOLDS.copy()
    with torch.no_grad():
        got, want = model(x), _unfolded(other, x)
    assert _gap(got, want) < 1e-5
    n = _n_bn(model)
    assert _since(before) == {"wb_reused": 0, "wb_rebuilt": n, "weight_reused": 0,
                              "weight_rebuilt": n}


def test_ema_update_rebuilds_teacher_weights():
    """The mean teacher (``engine.make_teacher``) after an EMA step
    (``parallel.optim.ema_update``, ``_foreach_mul_``): its folded weights
    are rebuilt, its (w, b) kept, and its output follows its new weights."""
    student = _build("resnet50")
    teacher = engine.make_teacher(student)
    x = _input()
    with torch.no_grad():
        teacher(x)
        for p in student.parameters():
            p.add_(0.01 * torch.randn_like(p))
    ema_update(teacher.parameters(), student.parameters(), 0.5)
    before = R.FOLDS.copy()
    with torch.no_grad():
        got, want = teacher(x), _unfolded(teacher, x)
    assert _gap(got, want) < 1e-5
    n = _n_bn(teacher)
    assert _since(before) == {"wb_reused": n, "wb_rebuilt": 0, "weight_reused": 0,
                              "weight_rebuilt": n}


def test_deepcopy_rebuilds_from_its_own_buffers():
    """A deep copy starts with no folds, and a change to its buffers leaves
    the original's folds alone."""
    model = _build("resnet18")
    x = _input()
    with torch.no_grad():
        model(x)
        twin = copy.deepcopy(model)
        before = R.FOLDS.copy()
        got = twin(x)
        n = _n_bn(twin)
        assert _since(before) == {"wb_reused": 0, "wb_rebuilt": n, "weight_reused": 0,
                                  "weight_rebuilt": n}
        assert _gap(got, _unfolded(model, x)) < 1e-5
        _seed_buffers(twin, 11)
        assert _gap(twin(x), _unfolded(twin, x)) < 1e-5
        before = R.FOLDS.copy()
        assert _gap(model(x), _unfolded(model, x)) < 1e-5
        assert _since(before)["wb_reused"] == n


def test_folds_made_in_inference_mode_train_afterwards():
    """Folds built under ``torch.inference_mode`` (the evaluation step) are
    normal tensors: a training pass after it runs and is exact."""
    model = _build("resnet50")
    x = _input()
    with torch.inference_mode():
        model(x)
    got, g_fold = _grads(model, model, x)
    want, g_ref = _grads(model, lambda t: _unfolded(model, t), x)
    assert _gap(got, want) < 1e-5
    assert _gap(g_fold["layer2_0.conv1.weight"], g_ref["layer2_0.conv1.weight"]) < 1e-5


def test_state_dict_names_unchanged_and_benchmark_weights_load():
    """The folds are plain attributes: the state dict has the buffers and
    parameters alone, before and after a pass, and the benchmark's seeded
    weights load strictly by its names."""
    model = _build("resnet50")
    keys = list(model.state_dict().keys())
    with torch.no_grad():
        model(_input())
    assert list(model.state_dict().keys()) == keys
    weights = RP.make_weights(RP.backbone_spec(), 3, torch.device("cpu"))
    own = {name[len("backbone."):]: t for name, t in weights.items()}
    assert sorted(own) == sorted(keys)
    model.load_state_dict(own, strict=True)
    with torch.no_grad():
        x = _input()
        assert _gap(model(x), _unfolded(model, x)) < 1e-5


def test_epoch_line_share():
    """The epoch line's share of folds reused since a snapshot."""
    before = R.FOLDS.copy()
    model = _build("resnet18")
    with torch.no_grad():
        for _ in range(4):
            model(_input())
    n = _n_bn(model)
    assert R.fold_summary(before) == (f"fold reuse: (w, b) 75.0 % of {4 * n}, "
                                      f"frozen W' 75.0 % of {4 * n}")
    assert R.fold_summary(R.FOLDS.copy()) == "fold reuse: (w, b) - of 0, frozen W' - of 0"


class _CountOps(TorchDispatchMode):
    """aten operations that compute (views left out)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_resnet50_pass_launch_guard():
    """One ResNet-50 forward and backward under bf16 autocast and the
    trainer's freeze policy, the folds warm: at most 600 operations (971
    when FrozenBN rebuilt its constants and applied them in two passes on
    every call); no FrozenBN arithmetic is left."""
    model = _build("resnet50")
    x = _input()

    def one_pass():
        with torch.autocast("cpu", dtype=torch.bfloat16):
            out = model(x)
        out.float().sum().backward()

    one_pass()
    with _CountOps() as count:
        one_pass()
    assert sum(count.ops.values()) <= 600, count.ops.most_common(12)
    for op in ("aten.sqrt", "aten.reciprocal", "aten.sub"):
        assert count.ops[op] == 0, op
