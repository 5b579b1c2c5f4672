"""Kernel K1 of the PyTorch port (ops/hungarian.py): the plain version that
runs on the CPU against the JAX package's lane-packed Pallas kernel (interpret
mode), its CPU solve and scipy.  The CUDA kernel is held against the plain
version on the card by ``test_torch_gpu.py`` and ``chip_smoke.py``.

Assignments are compared by optimal cost, to 1e-2 * max(1, |cost|), since
ties may pick different indices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from chip_smoke import assignment_cost, jv_expansions, k1_costs
from sound_event_detection_transformer_tpu.ops.matcher import _solve_rect_flat
from sound_event_detection_transformer_tpu.ops.pallas.hungarian import pallas_hungarian_packed
from sound_event_detection_transformer_tpu_torch.ops import hungarian

torch.set_num_threads(2)


def _check(costs, out):
    """Each row assigned once, -1 on exactly the free columns, optimal cost."""
    assert out.dtype == np.int32
    got = assignment_cost(costs, out)
    for i in range(costs.shape[0]):
        best = costs[i][linear_sum_assignment(costs[i])].sum()
        assert abs(got[i] - best) <= 1e-2 * max(1.0, abs(best)), (i, got[i], best)


SHAPES = [(192, 10, 20), (2, 1, 5), (3, 8, 8), (4, 3, 7), (3, 10, 31), (2, 31, 31)]
KINDS = ["random", "ties", "big"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_vs_scipy_and_jax_cpu_solve(shape, kind):
    rng = np.random.RandomState(3 * SHAPES.index(shape) + KINDS.index(kind))
    costs = k1_costs(rng, shape, kind)
    hungarian.lsap.launches = 0
    out = hungarian.lsap(torch.from_numpy(costs)).numpy()
    assert hungarian.lsap.launches == 0  # CPU tensors never launch the kernel
    _check(costs, out)
    ref = np.asarray(_solve_rect_flat(jnp.asarray(costs)))
    np.testing.assert_allclose(assignment_cost(costs, out), assignment_cost(costs, ref),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("shape", [(9, 10, 20), (4, 3, 7), (2, 1, 5), (3, 8, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_vs_pallas_lane_kernel(shape):
    """The JAX package's K1 in interpret mode, at its own test sizes."""
    rng = np.random.RandomState(sum(shape))
    for kind in KINDS:
        costs = k1_costs(rng, shape, kind)
        out = hungarian.lsap(torch.from_numpy(costs)).numpy()
        ref = np.asarray(pallas_hungarian_packed(jnp.asarray(costs), interpret=True))
        _check(costs, out)
        np.testing.assert_allclose(assignment_cost(costs, out), assignment_cost(costs, ref),
                                   rtol=1e-2, atol=1e-2)
        if kind == "random":  # a unique optimum: the same free columns
            np.testing.assert_array_equal(out < 0, ref < 0)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        hungarian.lsap(torch.zeros(2, 5, 3))  # rows > cols
    with pytest.raises(TypeError):
        hungarian.lsap(torch.zeros(2, 3, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        hungarian.lsap(torch.zeros(3, 5))


def test_plain_terminates_on_nan_costs():
    """Garbage in gives an assignment out, never a hang: the minimum runs
    over live columns only, as in the kernel."""
    costs = torch.full((2, 4, 6), float("nan"))
    costs[1, :, 3:] = 1.0
    out = hungarian.lsap(costs)
    assert out.shape == (2, 6)
    assert sorted(int(r) for r in out[0] if r >= 0) == [0, 1, 2, 3]


def test_expansion_count_behind_the_bound():
    """``chip_smoke.jv_expansions``, the data-dependent work of K1's bound:
    one expansion per row when each row's best column is free, i to insert
    row i when ties send every search through all assigned columns."""
    assert jv_expansions(-np.eye(5, 8, dtype=np.float32)[None]) == 5
    assert jv_expansions(np.zeros((1, 3, 5), np.float32)) == 1 + 2 + 3
    costs = k1_costs(np.random.RandomState(7), (16, 10, 20), "random")
    assert 16 * 10 <= jv_expansions(costs) <= 16 * 55
