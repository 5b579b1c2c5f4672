"""Tests of the PyTorch port that need a CUDA device; each skips without one.

This file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The checks are ``chip_smoke.py``'s own.  Kernels K1, K2 and K3 against their
plain versions on the card and scipy on the host, by optimal cost to
1e-2 * max(1, |cost|) since ties may pick different indices.  Kernel K4
against its plain blockwise version: 1e-5 on f32 inputs (the sums run in
another order), one bf16 rounding (1e-2) on bf16 inputs.  The tiny f32
evaluation step and long-clip predict on the card against the CPU, TF32 off,
to 1e-3, since the two devices sum convolutions and matmuls in a different
order.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from sound_event_detection_transformer_tpu_torch.ops import flash_attention as fa
from sound_event_detection_transformer_tpu_torch.ops import hungarian


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
    rng = np.random.RandomState(shape[1] + shape[2])
    for kind in chip_smoke.K1_COST_KINDS:
        before = hungarian.lsap_block.launches
        chip_smoke.k2_against_references(chip_smoke.k1_costs(rng, shape, kind), cuda, kind)
        torch.cuda.synchronize()
        assert hungarian.lsap_block.launches > before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 40, 60), (8, 16, 16), (3, 1, 1), (4, 70, 70)], ids=_ids)
def test_k3_kernel_vs_plain_and_scipy(cuda, shape):
    rng = np.random.RandomState(shape[1] + shape[2])
    for kind in chip_smoke.K1_COST_KINDS:
        before = hungarian.lsap_square.launches
        chip_smoke.k3_against_references(chip_smoke.k1_costs(rng, shape, kind), cuda, kind)
        torch.cuda.synchronize()
        assert hungarian.lsap_square.launches == before + 1


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
