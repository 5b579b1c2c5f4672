"""Kernels K1, K2 and K3 of the PyTorch port (ops/hungarian.py): the plain
versions that run on the CPU against the JAX package's Pallas kernels in
interpret mode (lane-packed, sublane-packed and the square reference one), its
CPU solve and scipy.  The CUDA kernels are held against the plain versions on
the card by ``test_torch_gpu.py`` and ``chip_smoke.py``.

Assignments are compared by optimal cost, to 1e-2 * max(1, |cost|), since
ties may pick different indices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import chip_smoke
from chip_smoke import assignment_cost, jv_expansions, k1_costs
from sound_event_detection_transformer_tpu.ops import matcher as jmatcher
from sound_event_detection_transformer_tpu.ops.matcher import _solve_rect_flat
from sound_event_detection_transformer_tpu.ops.pallas.hungarian import (
    pallas_hungarian,
    pallas_hungarian_packed,
)
from sound_event_detection_transformer_tpu_torch.ops import hungarian, matcher

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
    chip_smoke.reset_launch_counts()
    out = hungarian.lsap(torch.from_numpy(costs)).numpy()
    assert not any(chip_smoke.launch_counts().values())  # CPU tensors never launch a kernel
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


WIDE = [(24, 40, 60), (8, 33, 33), (3, 1, 40), (2, 1, 1), (11, 14, 14), (9, 10, 20)]


@pytest.mark.parametrize("shape", WIDE, ids=lambda s: "x".join(map(str, s)))
def test_plain_vs_pallas_sublane_kernel(shape):
    """K2's counterpart, the JAX package's sublane-packed kernel, forced in
    interpret mode: the widths past one warp, edge sizes and a narrow one."""
    rng = np.random.RandomState(sum(shape))
    for kind in KINDS:
        costs = k1_costs(rng, shape, kind)
        out = hungarian.lsap(torch.from_numpy(costs), force_block=True).numpy()
        ref = np.asarray(pallas_hungarian_packed(jnp.asarray(costs), interpret=True,
                                                 force_sublane=True))
        _check(costs, out)
        np.testing.assert_allclose(assignment_cost(costs, out), assignment_cost(costs, ref),
                                   rtol=1e-2, atol=1e-2)
        if kind == "random":  # a unique optimum: the same assignment
            np.testing.assert_array_equal(out, ref)


def test_dispatch_paths_agree():
    """``lsap`` picks K1 up to 31 columns and K2 beyond, as the JAX function
    picks its lane and sublane kernels; the forced and the automatic path
    give the same answer, and the warp kernel refuses what it cannot hold."""
    rng = np.random.RandomState(11)
    narrow = torch.from_numpy(k1_costs(rng, (5, 10, 20), "random"))
    wide = torch.from_numpy(k1_costs(rng, (3, 20, hungarian.LSEG), "random"))
    np.testing.assert_array_equal(hungarian.lsap(narrow).numpy(),
                                  hungarian.lsap(narrow, force_block=True).numpy())
    np.testing.assert_array_equal(hungarian.lsap(narrow).numpy(),
                                  hungarian.lsap_lane(narrow).numpy())
    np.testing.assert_array_equal(hungarian.lsap(wide).numpy(), hungarian.lsap_block(wide).numpy())
    with pytest.raises(ValueError, match="K1"):
        hungarian.lsap_lane(wide)
    with pytest.raises(ValueError, match="K2"):
        hungarian.lsap(torch.zeros(1, 2, hungarian.MAX_BLOCK))


def test_square_plain_vs_pallas_reference_kernel():
    """K3's counterpart, ``pallas_hungarian`` in interpret mode, on the JAX
    package's own test: BIG-padded square problems of mixed real size."""
    rng = np.random.RandomState(12)
    n, b = 16, 8
    costs = np.full((b, n, n), matcher.BIG, dtype=np.float32)
    for i in range(b):
        k = rng.randint(2, n + 1)
        costs[i, :k, :k] = rng.randn(k, k) * rng.uniform(0.1, 10)
    chip_smoke.reset_launch_counts()
    out = hungarian.lsap_square(torch.from_numpy(costs)).numpy()
    assert not any(chip_smoke.launch_counts().values())
    ref = np.asarray(pallas_hungarian(jnp.asarray(costs), interpret=True))
    _check(costs, out)
    np.testing.assert_allclose(assignment_cost(costs, out), assignment_cost(costs, ref),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 7, 33])
def test_square_plain_vs_scipy_and_rect_plain(n, kind):
    """K3's plain version shares no code with K1's and K2's: equal optimum."""
    costs = k1_costs(np.random.RandomState(n), (3, n, n), kind)
    out = hungarian.lsap_square(torch.from_numpy(costs)).numpy()
    _check(costs, out)
    rect = hungarian.lsap(torch.from_numpy(costs)).numpy()
    np.testing.assert_allclose(assignment_cost(costs, out), assignment_cost(costs, rect),
                               rtol=1e-2, atol=1e-2)


def test_square_pad_and_solve_lsap_match_jax():
    rng = np.random.RandomState(13)
    cost = rng.randn(2, 3, 4, 6).astype(np.float32)
    sq = matcher._square_pad(torch.from_numpy(cost[0]))
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jmatcher._square_pad(jnp.asarray(cost[0]))))
    stacked = torch.stack([matcher._square_pad(torch.from_numpy(c)) for c in cost])  # [2, 3, 6, 6]
    got = matcher.solve_lsap(stacked).numpy()
    want = np.asarray(jmatcher.solve_lsap(jnp.asarray(stacked.numpy())))
    assert got.shape == want.shape == (2, 3, 6)
    flat = stacked.numpy().reshape(-1, 6, 6)
    np.testing.assert_allclose(assignment_cost(flat, got.reshape(-1, 6)),
                               assignment_cost(flat, want.reshape(-1, 6)), rtol=1e-2, atol=1e-2)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        hungarian.lsap(torch.zeros(2, 5, 3))  # rows > cols
    with pytest.raises(TypeError):
        hungarian.lsap(torch.zeros(2, 3, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        hungarian.lsap(torch.zeros(3, 5))
    with pytest.raises(ValueError, match="square"):
        hungarian.lsap_square(torch.zeros(2, 3, 5))


def test_plain_terminates_on_nan_costs():
    """Garbage in gives an assignment out, never a hang: the minimum runs
    over live columns only, as in the kernel."""
    costs = torch.full((2, 4, 6), float("nan"))
    costs[1, :, 3:] = 1.0
    out = hungarian.lsap(costs)
    assert out.shape == (2, 6)
    assert sorted(int(r) for r in out[0] if r >= 0) == [0, 1, 2, 3]
    # the square version's loops are data-dependent: they must end all the same
    square = torch.full((2, 5, 5), float("nan"))
    square[1, :, 2:] = float("inf")
    out = hungarian.lsap_square(square)
    assert sorted(out[0].tolist()) == sorted(out[1].tolist()) == [0, 1, 2, 3, 4]


def test_expansion_count_behind_the_bound():
    """``chip_smoke.jv_expansions``, the data-dependent work of K1's bound:
    one expansion per row when each row's best column is free, i to insert
    row i when ties send every search through all assigned columns."""
    assert jv_expansions(-np.eye(5, 8, dtype=np.float32)[None]) == 5
    assert jv_expansions(np.zeros((1, 3, 5), np.float32)) == 1 + 2 + 3
    costs = k1_costs(np.random.RandomState(7), (16, 10, 20), "random")
    assert 16 * 10 <= jv_expansions(costs) <= 16 * 55


@pytest.mark.parametrize("nr,nc,want", [
    (40, 60, "warp"),  # the long evaluation step
    (10, 20, "warp"),  # K1's width, when K2 is forced
    (1, 1, "warp"),
    (32, 32, "warp"), (63, 63, "warp"), (64, 64, "warp"), (100, 127, "warp"), (60, 255, "warp"),
    (64, 255, "block"),  # 255 columns fit the lanes, 64 rows of them not the 64 KB
    (255, 255, "block"),
    (20, 256, "block"),  # nc + 1 = 257
    (120, 300, "block"),
    (126, 126, "warp"), (127, 127, "block"),  # the 64 KB line on square problems
])
def test_k2_variant_is_a_pure_function_of_the_shape(nr, nc, want):
    assert hungarian.block_variant(nr, nc) == want


@pytest.mark.parametrize("n,want", [
    (1, "warp"), (31, "warp"),
    (60, "warp"),  # the long evaluation step's problems, square-padded
    (126, "warp"),  # 65,028 B of cost and state: the last within 64 KB
    (127, "square"), (255, "square"), (256, "square"), (300, "square"),
])
def test_k3_variant_is_a_pure_function_of_the_size(n, want):
    assert hungarian.square_variant(n) == want


def test_ordered_key_is_monotone_over_every_bid():
    """The uint32 image the warp variant reduces over: strictly increasing
    where the f32 bids are, equal where they are equal (-0 and +0)."""
    bids = np.array([-np.inf, -3.0e38, -1.0e18, -2.5, -1.0, -1.0e-30, -1.0e-45, -0.0, 0.0,
                     1.0e-45, 1.0e-30, 1.0, 2.5, 1.0e4, 1.0e18, 3.0e38, np.inf], np.float32)
    keys = hungarian.ordered_key(bids).astype(np.int64)
    assert keys.dtype == np.int64 and hungarian.ordered_key(bids).dtype == np.uint32
    for i in range(len(bids)):
        for j in range(len(bids)):
            assert (bids[i] < bids[j]) == (keys[i] < keys[j]), (bids[i], bids[j])
            assert (bids[i] == bids[j]) == (keys[i] == keys[j]), (bids[i], bids[j])
    rs = np.random.RandomState(9)
    x = (rs.randn(4096) * 10.0 ** rs.randint(-20, 19, 4096)).astype(np.float32)
    order = np.argsort(x, kind="stable")
    assert (np.diff(hungarian.ordered_key(x[order]).astype(np.int64)) >= 0).all()
    # the clamp of a live bid and the +inf of a dead column keep their order
    assert hungarian.ordered_key(np.float32(hungarian.INF)) < hungarian.ordered_key(np.float32(np.inf))
