"""Tests of the PyTorch port that need a CUDA device; each skips without one.

This file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The checks are ``chip_smoke.py``'s own: kernel K1 against its plain version
on the card and scipy on the host, by optimal cost to 1e-2 * max(1, |cost|)
since ties may pick different indices; the tiny f32 evaluation step on the
card against the CPU, TF32 off, to 1e-3, since the two devices sum
convolutions and matmuls in a different order.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from sound_event_detection_transformer_tpu_torch.ops import hungarian


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(192, 10, 20), (192, 20, 20), (1200, 20, 20), (5, 31, 31)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_kernel_vs_plain_and_scipy(cuda, shape):
    rng = np.random.RandomState(shape[0] + shape[1])
    for kind in chip_smoke.K1_COST_KINDS:
        before = hungarian.lsap.launches
        chip_smoke.k1_against_references(chip_smoke.k1_costs(rng, shape, kind), cuda, kind)
        torch.cuda.synchronize()
        assert hungarian.lsap.launches == before + 1


@pytest.mark.gpu
def test_k1_rejects_widths_of_k2(cuda):
    with pytest.raises(NotImplementedError, match="K2"):
        hungarian.lsap(torch.zeros(2, 3, 40, device=cuda))


@pytest.mark.gpu
def test_eval_step_on_card_matches_cpu(cuda):
    chip_smoke.small_reference(cuda, seed=1)
