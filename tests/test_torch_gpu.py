"""Tests of the PyTorch port that need a CUDA device; each skips without one.

This file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The checks are ``chip_smoke.py``'s own.  Kernels K1, K2 and K3 (both
variants of each of the last two) against their plain versions on the card
index for index (the same arithmetic and tie-break), and against scipy on the
host by optimal cost to 1e-2 * max(1, |cost|), since scipy may break ties
otherwise.  Kernel
K4 (both variants, and which one ran) against its plain blockwise version:
1e-5 on f32 inputs (the sums run in another order), one bf16 rounding (1e-2)
on bf16 inputs.  The tiny f32
evaluation step, long-clip predict and two train steps on the card against
the CPU, TF32 off, to 1e-3, since the two devices sum convolutions and
matmuls in a different order.  Dropout on the card from an explicit CUDA
generator: the same seed gives the same mask, and the keep share lies
within 5 standard deviations of its binomial share.  The train step
launches K1 once (plain matching) or twice (fine-tune matching: the final
layer, then the aux layers).  SP-SEDT: the patch crop on the card against
the CPU to 1e-5; two tiny SP-SEDT steps on the card against the CPU to
1e-3; one step launches K1 once and leaves the lr-0 backbone leaves bit for
bit.  The audio-tag step: two tiny updates on the card against the CPU, TF32
off, to 1e-3, every parameter moved and no K1-K4 launched.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.data.dataset import batch_iterator
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder
from sound_event_detection_transformer_tpu_torch.data.feature_bank import FeatureBank
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset
from sound_event_detection_transformer_tpu_torch.engine import (
    init_train_state,
    make_semi_train_step,
    make_teacher,
    make_train_step,
)
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.ops import flash_attention as fa
from sound_event_detection_transformer_tpu_torch.ops import hungarian
from sound_event_detection_transformer_tpu_torch.ops.dropout import dropout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(192, 10, 20), (192, 20, 20), (1200, 20, 20), (5, 31, 31)],
                         ids=_ids)
def test_k1_kernel_vs_plain_and_scipy(cuda, shape):
    """The warp kernel at one column a lane: the plain version's indices
    (``k1_against_references`` raises on any difference) on random,
    tie-heavy and BIG-padded costs."""
    rng = np.random.RandomState(shape[0] + shape[1])
    for kind in chip_smoke.K1_COST_KINDS:
        before = hungarian.lsap_lane.launches
        chip_smoke.k1_against_references(chip_smoke.k1_costs(rng, shape, kind), cuda, kind)
        torch.cuda.synchronize()
        assert hungarian.lsap_lane.launches == before + 1


@pytest.mark.gpu
def test_k1_rejects_widths_of_k2(cuda):
    """The warp kernel raises past 31 columns; ``lsap`` sends those to K2."""
    cost = torch.zeros(2, 3, 40, device=cuda)
    with pytest.raises(ValueError, match="K1"):
        hungarian.lsap_lane(cost)
    before = hungarian.lsap_block.launches
    assert hungarian.lsap(cost).shape == (2, 40)
    assert hungarian.lsap_block.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 40, 60), (8, 33, 33), (192, 10, 20), (3, 1, 5),
                                   (2, 120, 300)], ids=_ids)
def test_k2_kernel_vs_plain_scipy_and_k1(cuda, shape):
    """Index for index against the plain version, which shares no code with
    the kernels (K1 runs the same kernel as K2's warp variant, so it is no
    cross-check any more)."""
    rng = np.random.RandomState(shape[1] + shape[2])
    for kind in chip_smoke.K1_COST_KINDS:
        before = hungarian.lsap_block.launches
        chip_smoke.k2_against_references(chip_smoke.k1_costs(rng, shape, kind), cuda, kind)
        torch.cuda.synchronize()
        assert hungarian.lsap_block.launches > before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", chip_smoke.K2_WARP_SHAPES + chip_smoke.K2_BLOCK_SHAPES, ids=_ids)
def test_k2_variants_at_their_edges(cuda, shape):
    """The warp variant at nc + 1 = 33, 64, 65, 128 and 256, the block variant
    at 257 and beyond: each against plain and scipy, counted per variant
    (``k2_against_references`` raises when the other variant ran)."""
    variant = "warp" if shape in chip_smoke.K2_WARP_SHAPES else "block"
    assert hungarian.block_variant(*shape[1:]) == variant
    rng = np.random.RandomState(shape[1] + shape[2])
    for kind in chip_smoke.K1_COST_KINDS:
        before = chip_smoke.launch_counts()
        chip_smoke.k2_against_references(chip_smoke.k1_costs(rng, shape, kind), cuda, kind)
        after = chip_smoke.launch_counts()
        assert after[f"K2 {variant}"] == before[f"K2 {variant}"] + 1
        assert after["K2"] == before["K2"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(192, 10, 20), (24, 40, 60), (7, 30, 31)], ids=_ids)
def test_k2_warp_variant_equals_plain_and_k1_index_for_index(cuda, shape):
    """Same arithmetic and tie-break as the other kernels: the same indices,
    not only the same cost, also on tie-heavy costs."""
    rng = np.random.RandomState(sum(shape))
    for kind in chip_smoke.K1_COST_KINDS:
        cost = torch.from_numpy(chip_smoke.k1_costs(rng, shape, kind)).to(cuda)
        got = hungarian.lsap(cost, force_block=True)
        assert torch.equal(got, hungarian.lsap_plain(cost))
        if shape[2] + 1 <= hungarian.LSEG:
            assert torch.equal(got, hungarian.lsap_lane(cost))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 40, 60), (8, 16, 16), (3, 1, 1), (4, 70, 70),
                                   (2, 126, 126), (2, 127, 127)], ids=_ids)
def test_k3_kernel_vs_plain_and_scipy(cuda, shape):
    """Both variants (the warp kernel up to n = 126, the square kernel from
    127) index for index against the plain version, counted per variant."""
    rng = np.random.RandomState(shape[1] + shape[2])
    variant = hungarian.square_variant(shape[2])
    for kind in chip_smoke.K1_COST_KINDS:
        before = chip_smoke.launch_counts()
        chip_smoke.k3_against_references(chip_smoke.k1_costs(rng, shape, kind), cuda, kind)
        torch.cuda.synchronize()
        after = chip_smoke.launch_counts()
        assert after["K3"] == before["K3"] + 1
        assert after[f"K3 {variant}"] == before[f"K3 {variant}"] + 1
        other = "square" if variant == "warp" else "warp"
        assert after[f"K3 {other}"] == before[f"K3 {other}"]


@pytest.mark.gpu
@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf")],
                         ids=["nan", "inf", "-inf"])
def test_k1_and_k3_end_on_nan_and_inf_costs(cuda, fill):
    """Garbage in gives an assignment out, never a warp that spins: every
    real row once, from K1 and from both variants of K3."""
    rng = np.random.RandomState(5)
    cost = torch.from_numpy(rng.randn(4, 10, 20).astype(np.float32))
    cost[0] = fill
    cost[1, :, ::2] = fill
    cost[2, 3] = fill
    out = hungarian.lsap_lane(cost.to(cuda)).cpu()
    for row in out:
        assert sorted(int(r) for r in row if r >= 0) == list(range(10))
    for n in (60, 127):  # the warp variant, then the square one
        square = torch.from_numpy(rng.randn(3, n, n).astype(np.float32))
        square[0] = fill
        square[1, :, n // 2:] = fill
        square[2, :, ::3] = fill
        out = hungarian.lsap_square(square.to(cuda)).cpu()
        for row in out:
            assert sorted(row.tolist()) == list(range(n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 4, 40, 528, 16), (2, 8, 41, 752, 32), (1, 8, 752, 752, 32),
                                   (2, 2, 70, 130, 64), (1, 2, 33, 200, 128)], ids=_ids)
def test_k4_kernel_vs_plain(cuda, shape, dtype):
    rng = np.random.RandomState(sum(shape))
    b, h, sq, sk, d = shape
    for bias_kind in ("padding", "full", "none"):
        q, k, v, bias = chip_smoke.attention_inputs(rng, b, h, sq, sk, d, dtype, cuda, bias_kind,
                                                    projected=bias_kind == "padding")
        chip_smoke.k4_against_plain(q, k, v, bias, bias_kind)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,split", [
    ((8, 8, 752, 752, 32), False), ((8, 8, 41, 752, 32), True),  # the long clip's two shapes
    ((2, 2, 1, 752, 32), True), ((2, 2, 16, 40, 32), False), ((2, 2, 17, 100, 64), True),
    ((1, 2, 41, 200, 128), True), ((2, 4, 41, 130, 64), True), ((3, 2, 16, 65, 32), True),
    ((2, 2, 300, 190, 128), True), ((8, 8, 300, 70, 64), False)], ids=lambda x: _ids(x) if isinstance(x, tuple) else str(x))
def test_k4_tensor_core_variant(cuda, shape, split):
    """bf16 inputs at head dims 32, 64 and 128 take the tensor-core variant:
    query sides of 1, 16, 17 and 41 rows, key sides below one tile and ragged,
    the keys split where the query side is short (clip 0 of the padding bias
    has every key padded, so whole ranges of the split are masked)."""
    rng = np.random.RandomState(sum(shape))
    b, h, sq, sk, d = shape
    for bias_kind in ("padding", "full", "none"):
        q, k, v, bias = chip_smoke.attention_inputs(rng, b, h, sq, sk, d, torch.bfloat16, cuda,
                                                    bias_kind, projected=bias_kind == "padding")
        chip_smoke.k4_against_plain(q, k, v, bias, bias_kind, "tensor", split)


@pytest.mark.gpu
def test_k4_counts_each_variant_and_misaligned_bf16_takes_the_f32_cores(cuda):
    rng = np.random.RandomState(3)
    chip_smoke.reset_launch_counts()
    q, k, v, bias = chip_smoke.attention_inputs(rng, 2, 4, 41, 200, 32, torch.bfloat16, cuda,
                                                "padding", shifted=True)
    assert q.data_ptr() % 16 == 8  # 8- but not 16-byte aligned
    chip_smoke.k4_against_plain(q, k, v, bias, "shifted", "f32", False)
    q, k, v, bias = chip_smoke.attention_inputs(rng, 2, 4, 41, 200, 32, torch.bfloat16, cuda,
                                                "padding", projected=True)
    chip_smoke.k4_against_plain(q, k, v, bias, "projected", "tensor", True)
    chip_smoke.k4_against_plain(q.float(), k.float(), v.float(), bias, "f32", "f32", False)
    counts = chip_smoke.launch_counts()
    assert (counts["K4"], counts["K4 tensor"], counts["K4 f32"], counts["K4 split"]) == (3, 1, 2, 1)


@pytest.mark.gpu
def test_k4_tensor_core_variant_under_a_cuda_graph(cuda):
    """Nothing on the per-call path but the launches: a captured call replays
    to the same answer, the split's scratch included."""
    rng = np.random.RandomState(4)
    q, k, v, bias = chip_smoke.attention_inputs(rng, 2, 4, 41, 752, 32, torch.bfloat16, cuda,
                                                "padding", projected=True)
    want = fa.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fa.flash_attention(q, k, v, bias)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_k4_gradient_is_the_non_flash_paths(cuda):
    """Forward through the kernel, backward through the recomputed plain math."""
    rng = np.random.RandomState(0)
    q, k, v, bias = chip_smoke.attention_inputs(rng, 1, 2, 40, 520, 32, torch.float32, cuda,
                                                "padding")
    w = torch.from_numpy(rng.randn(*q.shape).astype(np.float32)).to(cuda)
    grads = []
    for fn in (fa.flash_attention, fa.reference_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves, bias) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, r in zip(*grads):
        assert torch.allclose(g, r, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_k4_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 2, 8, 40, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 32, 8, device=cuda).transpose(2, 3)  # the last dim is strided
    with pytest.raises(ValueError, match="dense"):
        fa.flash_attention(q, q, q)


@pytest.mark.gpu
def test_eval_step_on_card_matches_cpu(cuda):
    chip_smoke.small_reference(cuda, seed=1)


@pytest.mark.gpu
def test_long_predict_on_card_matches_cpu(cuda):
    chip_smoke.small_long_predict(cuda, seed=1)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    chip_smoke.small_train_step(cuda, seed=1)


@pytest.mark.gpu
def test_dropout_on_the_card_follows_its_generator(cuda):
    x = torch.ones(1_000_000, device=cuda)
    gen = lambda s: torch.Generator(device=cuda).manual_seed(s)
    a, b, c = (dropout(x, 0.1, gen(s), deterministic=False) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    share = float((a != 0).float().mean())
    assert abs(share - 0.9) < 5 * (0.9 * 0.1 / x.numel()) ** 0.5, share
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))


@pytest.mark.gpu
@pytest.mark.parametrize("fine_tune,launches", [(False, 1), (True, 2)], ids=["plain", "fine_tune"])
def test_k1_launches_per_train_step(cuda, fine_tune, launches):
    cfg = chip_smoke.tiny_train_config()
    _, batches = chip_smoke.make_batches(cfg, 4, 1, seed=2)
    model, wd = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(2))
    state = init_train_state(model, cfg, steps_per_epoch=10)
    step = make_train_step(model, wd, cfg, state.optimizer, fine_tune=fine_tune, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    step(batches[0], gen)
    before = hungarian.lsap_lane.launches
    metrics = step(batches[0], gen)
    torch.cuda.synchronize()
    assert hungarian.lsap_lane.launches - before == launches
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.gpu
def test_evaluate_on_card_equals_cpu(cuda):
    """``train_lib.evaluate`` with its feature bank on the card: the same F1
    and PSDS as on the CPU, the loss means to 1e-3 (``chip_smoke``'s check,
    which raises on any miss)."""
    assert chip_smoke.small_evaluate(cuda, seed=1) <= 1e-3


@pytest.mark.gpu
def test_bank_gather_on_card_equals_host_batch(cuda):
    """Pinned bank batches: the gather on the card returns the features that
    the host would collate, −1 rows reading row 0."""
    cfg = SEDTConfig.tiny_test()
    m = cfg.model
    enc = BoxEncoder(list(cfg.data.classes), cfg.features.max_len_seconds)
    ds = SyntheticDataset(10, cfg.data.classes, m.max_frames, m.n_mels, enc.encode_strong_df,
                          seed=3)
    bank = FeatureBank(ds, cuda)
    host = list(batch_iterator(ds, 4, m.max_events, cfg.features.max_len_seconds,
                               return_indexes=True))
    banked = list(batch_iterator(ds, 4, m.max_events, cfg.features.max_len_seconds,
                                 return_indexes=True, bank=bank, pin_memory=True))
    assert len(host) == len(banked) == 3
    for h, b in zip(host, banked):
        assert b.feats is None and b.indexes.is_pinned() and b.targets.boxes.is_pinned()
        feats = bank.gather(b.indexes)
        assert feats.is_cuda
        want = h.feats.clone()
        want[h.indexes < 0] = torch.from_numpy(ds[0][0])[..., None]
        assert torch.equal(feats.cpu(), want)


@pytest.mark.gpu
def test_patch_crop_on_card_equals_cpu(cuda):
    """SP-SEDT's crop on the card against the CPU to 1e-5 (``chip_smoke``'s
    check, which raises on any miss), at 496 x 64 and at 100 x 48."""
    assert chip_smoke.patch_crop_against_cpu(cuda, seed=1) <= 1e-5


@pytest.mark.gpu
def test_spsedt_step_on_card_matches_cpu(cuda):
    chip_smoke.small_spsedt_step(cuda, seed=1)


@pytest.mark.gpu
def test_spsedt_step_launches_k1_once_and_keeps_lr0_leaves(cuda):
    """One tiny SP-SEDT step on the card: K1 once (the final and aux layers'
    joint solve), the backbone's lr-0 leaves, the frozen ones and the
    FrozenBN buffers bit for bit, the rest moved."""
    cfg = chip_smoke.tiny_spsedt_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dec_layers=2, mask_ratio=0.1,
                                                dropout=0.1))
    batch = chip_smoke.spsedt_batch(cfg, 4, seed=2)
    model, wd = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(2))
    state = init_train_state(model, cfg, steps_per_epoch=10)
    step = make_train_step(model, wd, cfg, state.optimizer, augment_on=False, device=cuda)
    before = chip_smoke.leaves_by_rule(model)
    launches = hungarian.lsap_lane.launches
    metrics = step(batch, torch.Generator(device=cuda).manual_seed(2))
    torch.cuda.synchronize()
    assert hungarian.lsap_lane.launches - launches == 1
    assert torch.isfinite(metrics["loss"]).item() and "loss_feature_0" in metrics
    chip_smoke.check_spsedt_leaves(model, before)


@pytest.mark.gpu
def test_semi_step_on_card_matches_cpu(cuda):
    chip_smoke.small_semi_step(cuda, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("fine_tune,launches", [(False, 1), (True, 4)], ids=["plain", "fine_tune"])
def test_k1_launches_per_semi_step(cuda, fine_tune, launches):
    """A tiny semi step on the card: K1 once under plain matching (the
    labeled and pseudo-labeled problems of every decoder layer in one
    solve), twice per criterion under fine-tune; pseudo events found."""
    cfg = chip_smoke.tiny_train_config()
    sizes = (2, 2, 4)
    batch = chip_smoke.semi_batch(cfg, sizes, seed=2)
    model, wd = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(2))
    state = init_train_state(model, cfg, steps_per_epoch=10, schedule="cosine")
    teacher = make_teacher(model)
    step = make_semi_train_step(wd, cfg, fine_tune=fine_tune, n_labeled=4, device=cuda)
    thr = torch.full((cfg.model.num_classes,), 0.05, device=cuda)
    args = (state, teacher, batch.feats, batch.feats * 1.0625, batch.pad_mask, batch.targets,
            *chip_smoke.semi_flags(sizes, cuda), thr, torch.Generator(device=cuda).manual_seed(2),
            True)
    step(*args)
    before = hungarian.lsap_lane.launches
    metrics, counts = step(*args)
    torch.cuda.synchronize()
    assert hungarian.lsap_lane.launches - before == launches
    assert torch.isfinite(metrics["loss"]).item() and counts.sum().item() > 0


@pytest.mark.gpu
def test_audio_tag_step_on_card_matches_cpu(cuda):
    """``chip_smoke.small_audio_tag_step`` raises on a loss difference above
    1e-3, an update off optax's Adam by 1e-3 of the lr, changes that agree
    card against CPU on fewer than nine entries in ten, a parameter that did
    not move, a changed buffer or a K1-K4 launch."""
    assert chip_smoke.small_audio_tag_step(cuda, chip_smoke.SEED) <= 1e-3
