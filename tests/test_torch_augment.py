"""The augmentations of the PyTorch port (``ops/augment.py``) against the JAX
package's, each apply fed JAX's own draws: the uniforms and normals that the
JAX function draws from its key (split as it splits it), its Beta draw and
its permutation.  So the two sides compute the same function of the same
numbers.

Tolerances: masks, shifts, labels, flags and validity exactly; mixed
features and mixup ratios rtol 1e-6, atol 1e-6 (f32, lam * a + (1 - lam) * b
in either order).  The draws themselves are held to their distributions and
to their seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.models.criterion import DenseTargets as JTargets
from sound_event_detection_transformer_tpu.ops import augment as jaug
from sound_event_detection_transformer_tpu_torch.models.criterion import DenseTargets as TTargets
from sound_event_detection_transformer_tpu_torch.ops import augment as taug

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)
B, T, F, M = 8, 40, 16, 6


def _feats(seed, shape=(B, T, F, 1)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _uniform(key, n):
    return _t(jax.random.uniform(key, (n,)))


@pytest.mark.parametrize("seed", range(4))
def test_gaussian_noise_pair_on_jax_draws(seed):
    x = _feats(seed)
    key = jax.random.PRNGKey(seed)
    want = jaug.gaussian_noise_pair(jnp.asarray(x), key, snr=20.0)
    r_apply, r_noise = jax.random.split(key)
    draws = taug.NoiseDraws(_t(jax.random.uniform(r_apply, (B, 1, 1, 1))).reshape(B),
                            _t(jax.random.normal(r_noise, x.shape)))
    got = taug.gaussian_noise_pair_apply(_t(x), draws, snr=20.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["time", "freq"])
def test_masks_on_jax_draws(seed, kind):
    """p 1.0 and wide bands, so every clip is masked somewhere."""
    x = _feats(seed)
    key = jax.random.PRNGKey(seed)
    draws = taug.BandDraws(*(_uniform(k, B) for k in jax.random.split(key, 3)))
    if kind == "time":
        want = jaug.time_mask(jnp.asarray(x), key, p=1.0, max_band_part=0.5)
        got = taug.time_mask_apply(_t(x), draws, p=1.0, max_band_part=0.5)
    else:
        want = jaug.freq_mask(jnp.asarray(x), key, p=1.0, fill_constant=-1.5)
        got = taug.freq_mask_apply(_t(x), draws, p=1.0, fill_constant=-1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != x).any()


@pytest.mark.parametrize("seed", range(4))
def test_freq_shift_on_jax_draws(seed):
    x = _feats(seed, (B, T, F))
    key = jax.random.PRNGKey(seed)
    r_apply, r_shift = jax.random.split(key)
    draws = taug.ShiftDraws(_uniform(r_apply, B), _t(jax.random.normal(r_shift, (B,))))
    want = jaug.freq_shift(jnp.asarray(x), key, p=0.7, std=3.0)
    got = taug.freq_shift_apply(_t(x), draws, p=0.7, std=3.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _targets(seed, n=B):
    """Clips with 1-5 events of 3 classes (same-class overlaps likely), a
    weak clip (labels without boxes) and an empty one."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(1, 6, n)
    counts[0], counts[1] = 0, 2
    valid = np.arange(M)[None, :] < counts[:, None]
    labels = np.where(valid, rng.randint(0, 3, (n, M)), 0).astype(np.int32)
    boxes = np.stack([rng.uniform(0.1, 0.9, (n, M)), rng.uniform(0.02, 0.3, (n, M))], -1)
    boxes = np.where(valid[..., None], boxes, 0.0).astype(np.float32)
    box_valid = valid.copy()
    box_valid[1] = False  # weak: labels, no boxes
    ratio = np.where(valid, rng.uniform(0.5, 1.0, (n, M)), 1.0).astype(np.float32)
    orig = np.full(n, 10.0, np.float32)
    fields = (labels, boxes, box_valid, valid, ratio, orig)
    return JTargets(*(jnp.asarray(f) for f in fields)), TTargets(*(_t(f) for f in fields))


def _check_targets(got, want):
    for name, g, w in zip(TTargets._fields, got, want):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_concat_targets_matches_jax(seed):
    (j1, t1), (j2, t2) = _targets(seed), _targets(seed + 10)
    _check_targets(taug.concat_targets(t1, t2, torch.tensor(0.3)),
                   jaug.concat_targets(j1, j2, jnp.asarray(0.3)))


@pytest.mark.parametrize("seed", range(6))
def test_mixup_on_jax_draws(seed):
    """Mixes, rejections for overlap and overflow (capacity 6), one-empty
    fallbacks, flag flips."""
    x = _feats(seed)
    jt, tt = _targets(seed)
    strong = np.arange(B) != 1
    weak = ~strong
    key = jax.random.PRNGKey(seed)
    want = jaug.mixup(jnp.asarray(x), jt, jnp.asarray(strong), jnp.asarray(weak), key,
                      mix_up_ratio=0.75, max_events=M)
    r_lam, r_perm = jax.random.split(key)
    draws = taug.MixupDraws(_t(jax.random.beta(r_lam, 1.0, 1.0)),
                            _t(jax.random.permutation(r_perm, B)).long())
    got = taug.mixup_apply(_t(x), tt, _t(strong), _t(weak), draws, mix_up_ratio=0.75,
                           max_events=M)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    _check_targets(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("seed", range(4))
def test_mixup_label_unlabel_on_jax_draws(seed):
    xl, xu = _feats(seed, (6, T, F, 1)), _feats(seed + 1)
    (jl, tl), (jp, tp) = _targets(seed, 6), _targets(seed + 20)
    key = jax.random.PRNGKey(seed)
    want = jaug.mixup_label_unlabel(jnp.asarray(xl), jnp.asarray(xu), jl, jp, key,
                                    mix_up_ratio=0.5, max_events=M)
    draws = taug.MixupDraws(_t(jax.random.beta(key, 1.0, 1.0)))
    got = taug.mixup_label_unlabel_apply(_t(xl), _t(xu), tl, tp, draws, mix_up_ratio=0.5,
                                         max_events=M)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    _check_targets(got[1], want[1])


def test_draws_follow_their_seed_and_distribution():
    gen = lambda s: torch.Generator().manual_seed(s)
    x = torch.from_numpy(_feats(0))
    jt, tt = _targets(0)
    strong, weak = torch.ones(B, dtype=torch.bool), torch.zeros(B, dtype=torch.bool)
    for fn in (lambda g: taug.time_mask(x, g, p=1.0), lambda g: taug.freq_mask(x, g),
               lambda g: taug.freq_shift(x, g), lambda g: taug.gaussian_noise_pair(x, g)[1],
               lambda g: taug.mixup(x, tt, strong, weak, g)[0]):
        assert torch.equal(fn(gen(1)), fn(gen(1)))
        assert not torch.equal(fn(gen(1)), fn(gen(2)))
    d = taug.mixup_draws(B, gen(0), torch.device("cpu"))
    assert sorted(d.perm.tolist()) == list(range(B)) and 0 < float(d.lam) < 1
    # Beta(alpha, alpha) has mean 1/2 and variance 1 / (4 (2 alpha + 1))
    g = gen(3)
    for alpha in (1.0, 2.0):
        lam = np.array([float(taug.mixup_draws(2, g, torch.device("cpu"), alpha).lam)
                        for _ in range(4000)])
        var = 1 / (4 * (2 * alpha + 1))
        assert abs(lam.mean() - 0.5) < 5 * (var / len(lam)) ** 0.5
        assert abs(lam.var() - var) < 0.15 * var
    assert float(taug.mixup_draws(2, g, torch.device("cpu"), 0.0).lam) == 1.0
