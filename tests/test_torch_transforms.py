"""The port's ``data/transforms.py``, ``config.load_classes_from_tsv`` and
``data/collapse_event.py`` against the JAX package's, exactly: the same
seeded arrays and ``np.random.RandomState`` seeds give equal arrays, boxes,
crops and shifts, and the same annotation files give the same TSV bytes."""
import numpy as np
import pandas as pd
import pytest

from sound_event_detection_transformer_tpu import config as jconfig
from sound_event_detection_transformer_tpu.data import collapse_event as jcollapse
from sound_event_detection_transformer_tpu.data import scaler as jscaler
from sound_event_detection_transformer_tpu.data import transforms as jt
from sound_event_detection_transformer_tpu_torch import config
from sound_event_detection_transformer_tpu_torch.data import collapse_event, scaler
from sound_event_detection_transformer_tpu_torch.data import transforms as tt
from sound_event_detection_transformer_tpu_torch.data.tsv import read_tsv

CLASSES = ("dog_bark", "siren", "car_horn")


def amplitudes(seed, t=120, f=16):
    return np.abs(np.random.RandomState(seed).randn(t, f)).astype(np.float32) ** 3


def same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_apply_log():
    x = amplitudes(0)
    x[3, 4] = 0.0  # below the 1e-5 floor
    same(tt.apply_log(x), jt.apply_log(x))


@pytest.mark.parametrize("shape, max_len", [((50, 8), 64), ((70, 8), 64), ((64, 8), 64),
                                            ((2, 30, 8), 40)])
def test_pad_trunc_seq(shape, max_len):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    same(tt.pad_trunc_seq(x, max_len), jt.pad_trunc_seq(x, max_len))


@pytest.mark.parametrize("shape", [(37, 11), (300, 64), (1, 5)])
def test_resize_patch(shape):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    same(tt.resize_patch(x), jt.resize_patch(x))
    same(tt.resize_patch(x, 20, 7), jt.resize_patch(x, 20, 7))


@pytest.mark.parametrize("t, num_patches, mu, sigma, fixed", [
    (500, 10, 0.2, 0.26, False),  # the SP-SEDT defaults: many draws rejected
    (157, 3, 0.05, 0.4, False),   # most draws rejected: several rounds of the loop
    (500, 6, 0.2, 0.26, True),
])
def test_patch_boxes_and_crops(t, num_patches, mu, sigma, fixed):
    """Boxes from one ``RandomState`` seed, then their crops; the next draw
    of each stream agrees too, so both consumed the same count."""
    rt, rj = np.random.RandomState(7), np.random.RandomState(7)
    bt = tt.get_random_patch_boxes(t, num_patches, mu, sigma, fixed, rt)
    bj = jt.get_random_patch_boxes(t, num_patches, mu, sigma, fixed, rj)
    same(bt, bj)
    assert bt.shape == (num_patches, 2)
    assert rt.randint(1 << 30) == rj.randint(1 << 30)
    data = amplitudes(3, t, 64)
    same(tt.extract_patches(data, bt), jt.extract_patches(data, bj))


def test_extract_patches_grows_an_empty_crop():
    data = amplitudes(4, 40, 8)
    boxes = np.asarray([[0.5, 0.0], [0.0, 0.01], [0.999, 0.001]], np.float32)
    same(tt.extract_patches(data, boxes, 16, 8), jt.extract_patches(data, boxes, 16, 8))


@pytest.mark.parametrize("with_scaler, compute_log", [(False, True), (True, True), (True, False)])
def test_get_transforms(with_scaler, compute_log):
    clips = [amplitudes(s, 90 + 20 * s, 16) for s in range(3)]
    ts, js = scaler.Scaler(), jscaler.Scaler()
    ts.calculate_scaler(clips)
    js.calculate_scaler(clips)
    ft = tt.get_transforms(100, ts if with_scaler else None, compute_log=compute_log)
    fj = jt.get_transforms(100, js if with_scaler else None, compute_log=compute_log)
    label = {"labels": np.arange(2)}
    for x in clips:
        (dt, lt), (dj, lj) = ft((x, label)), fj((x, label))
        same(dt, dj)
        assert lt is label and lj is label
    composed = tt.Compose([ft]).add_transform(lambda s: (s[0] * 2, s[1]))
    same(composed((clips[0], None))[0], fj((clips[0], None))[0] * 2)


@pytest.mark.parametrize("with_labels", [True, False])
def test_time_shift(with_labels):
    x = amplitudes(5, 100, 8)
    lm = (np.random.RandomState(6).rand(100, 3) > 0.5).astype(np.float32) if with_labels else None
    dt, lt = tt.time_shift(x, lm, rng=np.random.RandomState(11))
    dj, lj = jt.time_shift(x, lm, rng=np.random.RandomState(11))
    same(dt, dj)
    if with_labels:
        same(lt, lj)
    else:
        assert lt is None and lj is None


@pytest.mark.parametrize("shift, label_kind", [(True, "matrix"), (True, "dict"), (False, "matrix")])
def test_get_frame_transforms(shift, label_kind):
    clips = [amplitudes(s, 80, 8) for s in range(3)]
    ts, js = scaler.Scaler(), jscaler.Scaler()
    ts.calculate_scaler(clips)
    js.calculate_scaler(clips)
    ft = tt.get_frame_transforms(96, ts, apply_time_shift=shift, rng=np.random.RandomState(3))
    fj = jt.get_frame_transforms(96, js, apply_time_shift=shift, rng=np.random.RandomState(3))
    for i, x in enumerate(clips):
        label = (np.random.RandomState(i).rand(96, 4) > 0.5).astype(np.float32) \
            if label_kind == "matrix" else {"labels": np.arange(i)}
        (dt, lt), (dj, lj) = ft((x, label)), fj((x, label))
        same(dt, dj)
        if label_kind == "matrix":
            same(lt, lj)
        else:
            assert lt is label and lj is label


def test_load_classes_from_tsv(tmp_path):
    path = tmp_path / "m.tsv"
    path.write_text("filename\tonset\toffset\tevent_label\n"
                    "a.wav\t0.5\t1.0\tsiren\nb.wav\t\t\t\nc.wav\t1.0\t2.5\tdog_bark\n"
                    "c.wav\t3.0\t4.0\tsiren\n\nd.wav\t0\t1\tair_conditioner\n")
    assert config.load_classes_from_tsv(str(path)) == jconfig.load_classes_from_tsv(str(path)) \
        == ("air_conditioner", "dog_bark", "siren")


def annotations(seed, n_files=5):
    """Seeded annotation lines per file: onsets on a 0.5 s grid, so events of
    one class overlap, touch and tie; one file has none."""
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(n_files):
        lines = []
        for _ in range(0 if i == 2 else rng.randint(1, 8)):
            on = rng.randint(0, 16) * 0.5
            lines.append((on, on + rng.randint(1, 5) * 0.5 + rng.choice([0.0, 0.125]),
                          CLASSES[rng.randint(len(CLASSES))]))
        out[f"soundscape_{seed}_{i}"] = lines
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collapse_matches_jax(seed):
    rows = [(f"{name}.wav", on, off, lbl) for name, lines in annotations(seed).items()
            for on, off, lbl in lines]
    rows.append(("empty.wav", None, None, None))
    jdf = pd.DataFrame([r if r[3] else (r[0], np.nan, np.nan, np.nan) for r in rows],
                       columns=["filename", "onset", "offset", "event_label"])
    want = [tuple(r) for r in jcollapse.collapse(jdf).itertuples(index=False)]
    got = collapse_event.collapse(rows)
    assert got == want
    assert len(got) < len(rows) - 1  # something merged


def test_build_urbansed_tsvs_matches_jax(tmp_path):
    """The same annotation files give the same three TSVs, byte for byte."""
    src = tmp_path / "URBAN-SED"
    for k, split in enumerate(("train", "validate", "test")):
        d = src / "annotations" / split
        d.mkdir(parents=True)
        for name, lines in annotations(10 + k).items():
            (d / f"{name}.txt").write_text("".join(f"{on:.6f}\t{off:.6f}\t{lbl}\n"
                                                   for on, off, lbl in lines))
    collapse_event.build_urbansed_tsvs(str(src), str(tmp_path / "torch"))
    jcollapse.build_urbansed_tsvs(str(src), str(tmp_path / "jax"))
    for split in ("train", "validate", "test"):
        got = (tmp_path / "torch" / f"{split}.tsv").read_bytes()
        assert got == (tmp_path / "jax" / f"{split}.tsv").read_bytes()
        rows = read_tsv(str(tmp_path / "torch" / f"{split}.tsv"))
        assert rows and all(isinstance(r["onset"], float) for r in rows)
