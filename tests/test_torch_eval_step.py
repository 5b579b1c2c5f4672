"""The whole evaluation step of the PyTorch port against the JAX package's
``make_eval_step``, on transferred weights and one ``SyntheticDataset``
batch, f32 at the tiny test geometry: the losses, ``at``, the three fusion
strategies' post-processing and the events ``BoxEncoder`` decodes from them.

Tolerance atol 1e-4, rtol 1e-4: f32 convolution and matmul sums run in a
different order on the two sides.  Random weights give continuous costs, so
both sides match the same pairs."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.data import dataset as jdataset
from sound_event_detection_transformer_tpu.data.encoder import BoxEncoder as JEncoder
from sound_event_detection_transformer_tpu.data.encoder import to_dense_targets as jto_dense_targets
from sound_event_detection_transformer_tpu.data.synthetic import SyntheticDataset as JSynthetic
from sound_event_detection_transformer_tpu.engine import make_eval_step as jmake_eval_step
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.data import dataset as tdataset
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder as TEncoder
from sound_event_detection_transformer_tpu_torch.data.encoder import to_dense_targets as tto_dense_targets
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset as TSynthetic
from sound_event_detection_transformer_tpu_torch.engine import make_eval_step as tmake_eval_step
from sound_event_detection_transformer_tpu_torch.models import build_model as tbuild
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
B, SECONDS, FUSION = 4, 10.0, (1, 2, 3)


def _random_frozen(frozen, rng):
    """FrozenBN statistics away from the identity (see test_torch_model.py)."""
    def draw(path, x):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.2, 0.5, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, frozen)


@pytest.fixture(scope="module")
def both():
    """Each package's eval step result on the same weights and batch."""
    jcfg, tcfg = JConfig.tiny_test(), TConfig.tiny_test()
    m = jcfg.model
    classes = jcfg.data.classes
    jenc, tenc = JEncoder(classes, SECONDS), TEncoder(classes, SECONDS)
    jds = JSynthetic(B, classes, m.max_frames, m.n_mels, jenc.encode_strong_df, seed=5)
    tds = TSynthetic(B, classes, m.max_frames, m.n_mels, tenc.encode_strong_df, seed=5)
    jbatch = jdataset.collate([jds[i] for i in range(B)], m.max_events, SECONDS)
    tbatch = tdataset.collate([tds[i] for i in range(B)], m.max_events, SECONDS)
    np.testing.assert_array_equal(tbatch.feats.numpy(), jbatch.feats)
    # a padded tail on one clip, and a padded last row that the loss skips
    pad = np.zeros((B, m.max_frames), bool)
    pad[2, 90:] = True
    jbatch = jbatch._replace(pad_mask=pad)
    tbatch = tbatch._replace(pad_mask=torch.from_numpy(pad))
    valid = np.array([True, True, True, False])

    jmodel, jwd = jbuild(jcfg)
    v = jax.jit(lambda r: jmodel.init({"params": r}, jnp.asarray(jbatch.feats),
                                      jnp.asarray(pad), True))(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, flax.core.unfreeze(v["params"]))
    frozen = _random_frozen(jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"])),
                            np.random.RandomState(3))
    want = jmake_eval_step(jmodel, jwd, jcfg, FUSION)(
        params, frozen, jax.tree.map(lambda x: None if x is None else jnp.asarray(x), jbatch),
        jnp.asarray(valid))

    tmodel, twd = tbuild(tcfg, device="cpu")
    tmodel.load_state_dict(from_flax(params, frozen), strict=True)
    got = tmake_eval_step(tmodel, twd, tcfg, FUSION, device="cpu")(tbatch, torch.from_numpy(valid))
    return want, got, jwd, twd, jenc, tenc


def test_weight_dicts_and_result_keys(both):
    want, got, jwd, twd, _, _ = both
    assert twd == jwd
    assert set(got) == set(want) == {"losses", "at"} | {f"pp_{m}" for m in FUSION}


def test_losses_match_jax(both):
    want, got, _, _, _, _ = both
    assert set(got["losses"]) == set(want["losses"])
    for k, w in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k].numpy(), np.asarray(w), err_msg=k, **TOL)


def test_audio_tags_match_jax(both):
    want, got, _, _, _, _ = both
    np.testing.assert_allclose(got["at"].numpy(), np.asarray(want["at"]), **TOL)


@pytest.mark.parametrize("at_m", FUSION)
def test_postprocess_matches_jax(both, at_m):
    want, got, _, _, _, _ = both
    w, g = want[f"pp_{at_m}"], got[f"pp_{at_m}"]
    np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores), **TOL)
    np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))
    np.testing.assert_allclose(g.boxes.numpy(), np.asarray(w.boxes), **TOL)


@pytest.mark.parametrize("at_m", FUSION)
def test_decoded_events_match_jax(both, at_m):
    """The host decode of each side's post-processing gives the same events.
    Random weights give low scores, so the threshold sits in the widest gap
    of the middle half of the scores: it keeps some events, and no score lies
    within the tolerance of it."""
    want, got, _, _, jenc, tenc = both
    w, g = want[f"pp_{at_m}"], got[f"pp_{at_m}"]
    s = np.sort(np.asarray(w.scores).ravel())
    lo, hi = len(s) // 4, 3 * len(s) // 4
    k = lo + int(np.argmax(np.diff(s)[lo:hi]))
    thr = float(s[k] + s[k + 1]) / 2
    jev = jenc.decode_strong_batch(np.asarray(w.scores), np.asarray(w.labels),
                                   np.asarray(w.boxes), threshold=thr)
    tev = tenc.decode_strong_batch(g.scores.numpy(), g.labels.numpy(), g.boxes.numpy(),
                                   threshold=thr)
    assert sum(len(v) for v in jev.values()) > 0
    assert tev.keys() == jev.keys()
    for b in jev:
        assert [e[0] for e in tev[b]] == [e[0] for e in jev[b]]
        np.testing.assert_allclose(np.array([e[1:] for e in tev[b]], np.float64),
                                   np.array([e[1:] for e in jev[b]], np.float64), **TOL)


def test_encoder_and_dense_targets_match_jax():
    """List-label encodings (strong, plain labels, weak, empty), the dense
    targets with their strong/weak flags and a capacity overflow, and the
    weak and non-suppressing strong decoders."""
    classes = TConfig.tiny_test().data.classes
    jenc, tenc = JEncoder(classes, SECONDS), TEncoder(classes, SECONDS)
    strong = [[classes[1], 0.5, 2.0], [classes[3], 4.0, 9.5], [classes[1], 1.0, 3.0]]
    cases = [("strong", strong), ("strong", [classes[2], classes[0]]), ("strong", "empty"),
             ("weak", f"{classes[0]},{classes[2]}"), ("weak", [classes[3]]), ("weak", "empty")]
    encoded = []
    for kind, labels in cases:
        method = "encode_weak" if kind == "weak" else "encode_strong_df"
        j, t = getattr(jenc, method)(labels), getattr(tenc, method)(labels)
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{kind} {labels} {k}")
        encoded.append(t)
    want = jto_dense_targets(encoded, 2, SECONDS)
    got = tto_dense_targets(encoded, 2, SECONDS)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert tenc.decode_weak([0, 1, 0, 1]) == jenc.decode_weak([0, 1, 0, 1])
    pred = {"scores": np.array([0.9, 0.4, 0.7]), "labels": np.array([1, 2, 1]),
            "boxes": np.array([[0.0, 3.0], [1.0, 1.1], [2.0, 6.0]])}
    for kw in (dict(), dict(del_overlap=False), dict(threshold=0.3, min_duration=0.05)):
        assert tenc.decode_strong(pred, **kw) == jenc.decode_strong(pred, **kw)
