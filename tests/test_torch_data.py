"""The port's data side against the JAX package's: ``SyntheticDataset``
(clips, rows and file names, strong, weak and unlabeled), the label codecs
(``ManyHotEncoder``, ``BoxEncoder.encode_unlabel`` and table rows, the
encoders' ``state_dict``), ``MultiStreamBatchSampler``'s batches in both
stream layouts, and ``batch_iterator``'s batches (the −1 rows that fill
the last one, ``return_indexes``, unlabeled streams, the prefetch thread and
the feature bank).  All exact: the same numpy draws and integer logic."""
import numpy as np
import pandas as pd
import pytest
import torch

from sound_event_detection_transformer_tpu.data import dataset as jdataset
from sound_event_detection_transformer_tpu.data.encoder import BoxEncoder as JBox
from sound_event_detection_transformer_tpu.data.encoder import ManyHotEncoder as JManyHot
from sound_event_detection_transformer_tpu.data.synthetic import SyntheticDataset as JSynthetic
from sound_event_detection_transformer_tpu_torch.data import dataset as tdataset
from sound_event_detection_transformer_tpu_torch.data import feature_bank
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder as TBox
from sound_event_detection_transformer_tpu_torch.data.encoder import ManyHotEncoder as TManyHot
from sound_event_detection_transformer_tpu_torch.data.feature_bank import FeatureBank, maybe_bank
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset as TSynthetic

CLASSES = ["a", "b", "c", "d", "e"]
FRAMES, MELS, SECONDS, MAX_EVENTS = 32, 16, 10.0, 4
COLS = ["filename", "onset", "offset", "event_label"]


def _pair(n, seed, **kw):
    j = JSynthetic(n, CLASSES, FRAMES, MELS, JBox(CLASSES, SECONDS).encode_strong_df,
                   max_events=3, seconds=SECONDS, seed=seed, **kw)
    t = TSynthetic(n, CLASSES, FRAMES, MELS, TBox(CLASSES, SECONDS).encode_strong_df,
                   max_events=3, seconds=SECONDS, seed=seed, **kw)
    return j, t


def _assert_label_dicts_equal(t, j):
    assert t.keys() == j.keys()
    for k in j:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["strong", "weak_only", "unlabel"])
def test_synthetic_dataset_matches_jax(kind):
    kw = {} if kind == "strong" else {kind: True}
    j, t = _pair(7, 4, **kw)
    assert len(t) == len(j) == 7
    assert t.filenames == list(j.filenames) == [f"synthetic_4_{i}.wav" for i in range(7)]
    ref = j.ref_df()
    assert t.ref_rows() == list(ref.itertuples(index=False, name=None))
    assert len(t.ref_rows()) >= 7  # every clip has an event
    for i in range(len(j)):
        (jf, jy), (tf, ty) = j[i], t[i]
        np.testing.assert_array_equal(tf, jf)
        _assert_label_dicts_equal(ty, jy)
        np.testing.assert_array_equal(t.features_only(i)[0], j.features_only(i)[0])
        assert t.features_only(i)[1] == j.features_only(i)[1] == FRAMES
        _assert_label_dicts_equal(t.targets_only(i, FRAMES), j.targets_only(i, FRAMES))


def test_box_encoder_rows_unlabel_and_state_dict_match_jax():
    jenc, tenc = JBox(CLASSES, SECONDS), TBox(CLASSES, SECONDS)
    rows = [("f.wav", 0.5, 2.0, "b"), ("f.wav", 4.0, 9.5, "d"), ("f.wav", None, None, None)]
    _assert_label_dicts_equal(tenc.encode_strong_df(rows),
                              jenc.encode_strong_df(pd.DataFrame(rows, columns=COLS)))
    _assert_label_dicts_equal(tenc.encode_strong_df([("f.wav", np.nan, np.nan, np.nan)]),
                              jenc.encode_strong_df(pd.DataFrame([("f.wav", np.nan, np.nan, np.nan)],
                                                                 columns=COLS)))
    boxes = [[0.2, 0.1], [0.7, 0.3]]
    _assert_label_dicts_equal(tenc.encode_unlabel(boxes), jenc.encode_unlabel(boxes))
    assert tenc.state_dict() == jenc.state_dict()
    back = TBox.load_state_dict(jenc.state_dict())
    assert (back.labels, back.seconds) == (tenc.labels, tenc.seconds)


def test_many_hot_encoder_matches_jax():
    jenc, tenc = JManyHot(CLASSES, n_frames=50), TManyHot(CLASSES, n_frames=50)
    for labels in ("a,c", "empty", ["e", "b", None], ["d"]):
        np.testing.assert_array_equal(tenc.encode_weak(labels), jenc.encode_weak(labels))
    rows = [("f.wav", 3.4, 20.6, "b"), ("f.wav", 10, 49, "e"), ("f.wav", 0, 5, "b"),
            ("f.wav", None, None, None)]
    strong = tenc.encode_strong_df(rows)
    np.testing.assert_array_equal(strong, jenc.encode_strong_df(pd.DataFrame(rows, columns=COLS)))
    assert tenc.decode_strong(strong) == jenc.decode_strong(strong)
    assert tenc.decode_weak([0, 1, 0, 1, 1]) == jenc.decode_weak([0, 1, 0, 1, 1])
    act = np.array([1, 1, 0, 1, 0, 0, 1])
    np.testing.assert_array_equal(TManyHot.find_contiguous_regions(act),
                                  JManyHot.find_contiguous_regions(act))
    assert tenc.state_dict() == jenc.state_dict()
    back = TManyHot.load_state_dict(jenc.state_dict())
    assert (back.labels, back.n_frames) == (tenc.labels, tenc.n_frames)


def _concats(layout):
    """The trainer's stream layouts: one strong stream (URBAN-SED), or a
    strong and a weak one (DCASE)."""
    j_strong, t_strong = _pair(11, 0)
    if layout == "urbansed":
        return jdataset.ConcatDataset([j_strong]), tdataset.ConcatDataset([t_strong]), [4]
    j_weak, t_weak = _pair(6, 2, weak_only=True)
    return (jdataset.ConcatDataset([j_strong, j_weak]),
            tdataset.ConcatDataset([t_strong, t_weak]), [3, 2])


@pytest.mark.parametrize("layout", ["urbansed", "dcase"])
def test_sampler_batches_match_jax(layout):
    jcat, tcat, sizes = _concats(layout)
    assert tcat.filenames == list(jcat.filenames)
    assert tcat.cumulative_sizes == jcat.cumulative_sizes
    js = jdataset.MultiStreamBatchSampler(jcat, sizes, seed=2020)
    ts = tdataset.MultiStreamBatchSampler(tcat, sizes, seed=2020)
    assert len(ts) == len(js) == (2 if layout == "urbansed" else 3)
    for _ in range(3):  # one permutation per pass, from one RandomState
        assert list(ts) == list(js)


def _assert_batches_equal(tb, jb, feats=True):
    if feats:
        np.testing.assert_array_equal(tb.feats.numpy(), jb.feats)
    np.testing.assert_array_equal(tb.pad_mask.numpy(), jb.pad_mask)
    for t, j in zip(tb.targets, jb.targets):
        np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(tb.strong.numpy(), jb.strong)
    np.testing.assert_array_equal(tb.weak.numpy(), jb.weak)
    np.testing.assert_array_equal(tb.indexes.numpy(), jb.indexes)


@pytest.mark.parametrize("prefetch", [False, True], ids=["inline", "prefetch"])
def test_batch_iterator_in_order_pads_the_last_batch(prefetch):
    """10 clips at batch size 4: the last batch repeats clip 9 twice, as
    rows of index −1.  The port always builds its batches on the prefetch
    thread; they equal the JAX package's built inline and prefetched."""
    j, t = _pair(10, 0)
    jb = list(jdataset.batch_iterator(j, 4, MAX_EVENTS, SECONDS, to_device=False,
                                      return_indexes=True, prefetch=prefetch))
    tb = list(tdataset.batch_iterator(t, 4, MAX_EVENTS, SECONDS, return_indexes=True))
    assert len(tb) == len(jb) == 3
    assert tb[-1].indexes.tolist() == [8, 9, -1, -1]
    np.testing.assert_array_equal(tb[-1].feats[3].numpy(), t[9][0][..., None])
    for x, y in zip(tb, jb):
        _assert_batches_equal(x, y)


@pytest.mark.parametrize("layout", ["urbansed", "dcase"])
def test_batch_iterator_with_sampler_bank_and_unlabel_streams(layout):
    """Sampler batches, the weak stream marked unlabeled, and the bank: its
    batches carry no features, and its gather equals the collated ones."""
    jcat, tcat, sizes = _concats(layout)
    unlabel = [1] if layout == "dcase" else None
    jb = list(jdataset.batch_iterator(
        jcat, iter(jdataset.MultiStreamBatchSampler(jcat, sizes, seed=7)), MAX_EVENTS, SECONDS,
        unlabel_streams=unlabel, prefetch=False, to_device=False, return_indexes=True))
    bank = FeatureBank(tcat, torch.device("cpu"))
    assert bank.shape == (len(tcat), FRAMES, MELS, 1) and len(bank) == len(tcat)
    tb = list(tdataset.batch_iterator(
        tcat, iter(tdataset.MultiStreamBatchSampler(tcat, sizes, seed=7)), MAX_EVENTS, SECONDS,
        unlabel_streams=unlabel, bank=bank))
    assert len(tb) == len(jb) > 0
    for x, y in zip(tb, jb):
        assert x.feats is None
        _assert_batches_equal(x, y, feats=False)
        np.testing.assert_array_equal(bank.gather(x.indexes).numpy(), y.feats)
    if layout == "dcase":
        assert not any(b.weak.any() for b in tb)  # the weak stream's rows are unlabeled
    padded = torch.tensor([3, -1])
    np.testing.assert_array_equal(bank.gather(padded).numpy(),
                                  np.stack([tcat[3][0], tcat[0][0]])[..., None])


def test_maybe_bank_follows_the_flags(capsys, monkeypatch):
    _, t = _pair(5, 0)
    cfg = type("Cfg", (), {"model": type("M", (), {"max_frames": FRAMES, "n_mels": MELS})})
    args = type("Args", (), {"device_data": True, "shard_bank": False})
    assert isinstance(maybe_bank(args, t, cfg, torch.device("cpu")), FeatureBank)
    with monkeypatch.context() as mp:
        mp.setattr(feature_bank, "BANK_BUDGET_BYTES", 10)
        assert maybe_bank(args, t, cfg, torch.device("cpu")) is None
    args.device_data = False
    assert maybe_bank(args, t, cfg, torch.device("cpu")) is None
    args.device_data, args.shard_bank = True, True
    with pytest.raises(NotImplementedError, match="item 7"):
        maybe_bank(args, t, cfg, torch.device("cpu"))


def test_prefetcher_raises_the_worker_error_and_stops_early():
    def items():
        yield 1
        yield 2
        raise KeyError("boom")

    it = iter(tdataset.Prefetcher(items))
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(KeyError, match="boom"):
        next(it)
    endless = iter(tdataset.Prefetcher(lambda: iter(range(10**9))))
    assert next(endless) == 0
    endless.close()  # ends the worker thread without draining the stream
