"""The port's on-disk data path against the JAX package's: the seeded wav
writer (``data/wav_dataset.py`` against ``tools/make_wav_dataset.py``),
``SedData`` and ``get_dfs``, ``DataLoadDf`` and ``WavLoadDf``,
``cap_strong_clips`` and ``train_lib.build_real_data``.

The datasets are a handful of 10 s clips in both layouts, written once per
module by the port's writer.  Tolerances: the writers and the tables agree
exactly; the cached ``.npy`` mel amplitudes to 1e-6 relative (both sides
run scipy's float32 FFT and a float32 matmul, so only the summation order of
the mel matmul may differ); the dataset items exactly, since both sides read
the same ``.npy`` files; the scaler's mean and std to 1e-5 relative (its
float64 sums of clip means over features that differ by 1e-6).
"""
import argparse
import filecmp
import importlib.util
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from sound_event_detection_transformer_tpu import train_lib as jtrain_lib
from sound_event_detection_transformer_tpu.data import dataset as jdataset
from sound_event_detection_transformer_tpu.data import features as jfeatures
from sound_event_detection_transformer_tpu.data.encoder import BoxEncoder as JBoxEncoder
from sound_event_detection_transformer_tpu.data.scaler import Scaler as JScaler
from sound_event_detection_transformer_tpu.data.transforms import get_transforms as jget_transforms
from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.config import DCASE_CLASSES, URBAN_CLASSES
from sound_event_detection_transformer_tpu_torch.data import dataset, features, wav_dataset
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder
from sound_event_detection_transformer_tpu_torch.data.scaler import Scaler
from sound_event_detection_transformer_tpu_torch.data.transforms import get_transforms
from sound_event_detection_transformer_tpu_torch.data.tsv import read_tsv

ROOT = Path(__file__).resolve().parents[1]
URBAN = dict(train=4, validate=2, test=2)
DCASE = dict(strong=3, weak=2, unlabel=2, validate=2, test=2)


def jax_writer():
    spec = importlib.util.spec_from_file_location("make_wav_dataset",
                                                  ROOT / "tools" / "make_wav_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_write(root, dataname, headroom=False):
    """``tools/make_wav_dataset.py``'s ``main`` on the module's sizes."""
    mod = jax_writer()
    n = dict(URBAN, strong=2048, weak=2048, unlabel=8192) if dataname == "urbansed" else \
        dict(DCASE, train=2048)
    args = argparse.Namespace(root=str(root), dataname=dataname, num_classes=10, seed=5,
                              headroom=headroom, **n)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", lambda self, *a: args)
        mod.main()


def files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("disk")
    wav_dataset.main(["--root", str(root), "--seed", "5"] + [f"--{k}={v}" for k, v in URBAN.items()])
    wav_dataset.main(["--root", str(root), "--dataname", "dcase", "--seed", "5"]
                     + [f"--{k}={v}" for k, v in DCASE.items()])
    # a clip listed in the TSV whose wav is missing: both sides drop its rows
    os.remove(root / "urbansed" / "audio" / "validate" / "validate_clip_1.wav")
    # a clip without events: an empty label row, and a short line
    with open(root / "urbansed" / "metadata" / "test.tsv", "a") as f:
        f.write("test_clip_0.wav\t\t\t\ntest_clip_1.wav\n")
    return root


@pytest.mark.parametrize("dataname, headroom", [("urbansed", False), ("dcase", False),
                                                ("dcase", True)])
def test_writer_matches_the_jax_tool(dataname, headroom, tmp_path):
    """Identical wav bytes and TSV bytes, file for file."""
    n = URBAN if dataname == "urbansed" else DCASE
    argv = ["--root", str(tmp_path / "torch"), "--dataname", dataname, "--seed", "5"] + \
        [f"--{k}={v}" for k, v in n.items()] + (["--headroom"] if headroom else [])
    wav_dataset.main(argv)
    jax_write(tmp_path / "jax", dataname, headroom)
    got, want = files(tmp_path / "torch"), files(tmp_path / "jax")
    assert got == want and len(got) == sum(n.values()) + (3 if dataname == "urbansed" else 5)
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "torch", tmp_path / "jax",
                                           [str(p) for p in got], shallow=False)
    assert not mismatch and not errors
    tsvs = [p for p in got if p.suffix == ".tsv"]
    assert any(len(read_tsv(str(tmp_path / "torch" / p))) > 1 for p in tsvs)


def jax_rows(df):
    """A JAX DataFrame as the port's rows: NaN cells become None."""
    return [{k: (None if isinstance(v, float) and math.isnan(v) else v) for k, v in r.items()}
            for r in df.to_dict("records")]


def prepare(data_root, tmp_path, dataname, **kw):
    """``get_dfs`` of both packages on the dataset, each with its own feature
    directory: (port's rows, JAX's DataFrames) per split."""
    base = data_root / dataname
    if dataname == "urbansed":
        paths = {"train": "train.tsv", "validation": "validate.tsv", "eval": "test.tsv"}
        audio_dirs = None
    else:
        paths = {"weak": "train/weak.tsv", "synthetic": "train/synthetic_2019/soundscapes.tsv",
                 "unlabel": "train/unlabel_in_domain.tsv",
                 "validation": "validation/validation.tsv", "eval": "eval/public.tsv"}
        audio_dirs = {"validation": str(base / "audio" / "validation")}
    paths = {k: str(base / "metadata" / v) for k, v in paths.items()}
    tds = features.SedData(dataname, base_feature_dir=str(tmp_path / "torch"))
    jds = jfeatures.SedData(dataname, base_feature_dir=str(tmp_path / "jax"))
    got = features.get_dfs(tds, paths, audio_dirs=audio_dirs, **kw)
    want = jfeatures.get_dfs(jds, paths, audio_dirs=audio_dirs, **kw)
    return got, want, tds, jds


@pytest.mark.parametrize("dataname, kw", [("urbansed", {}), ("urbansed", {"nb_files": 1}),
                                          ("dcase", {}), ("dcase", {"unlabel_data": True})])
def test_get_dfs_matches_jax(data_root, tmp_path, dataname, kw):
    """The same rows per split (filenames, labels, the empty row; the clip
    whose wav is missing dropped) and the same ``.npy`` features."""
    got, want, tds, jds = prepare(data_root, tmp_path, dataname, **kw)
    assert got.keys() == want.keys()
    assert ("unlabel" in got) == bool(kw.get("unlabel_data"))
    assert Path(tds.feature_dir).relative_to(tmp_path / "torch") == \
        Path(jds.feature_dir).relative_to(tmp_path / "jax")
    assert tds.feature_dir.endswith("_nolog")
    for split, rows in got.items():
        wrows = jax_rows(want[split])
        assert len(rows) == len(wrows) > 0, split
        for r, w in zip(rows, wrows):
            assert r.keys() == w.keys()
            assert Path(r["feature_filename"]).relative_to(tmp_path / "torch") == \
                Path(w["feature_filename"]).relative_to(tmp_path / "jax")
            assert {k: v for k, v in r.items() if k != "feature_filename"} == \
                {k: v for k, v in w.items() if k != "feature_filename"}
            a, b = np.load(r["feature_filename"]), np.load(w["feature_filename"])
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
        if kw.get("nb_files"):
            assert len({r["filename"] for r in rows}) == kw["nb_files"]
    if dataname == "urbansed":
        assert {r["filename"] for r in got["validation"]} == {"validate_clip_0.wav"}
        assert got["eval"][-1]["event_label"] is None  # the clip without events
    else:
        # DCASE validation audio comes from audio/validation
        assert all("/audio/validation/" in r["wav_filename"] for r in got["validation"])
    n = tds.n_extracted
    assert n == sum(len({r["filename"] for r in rows}) for rows in got.values())
    path = str(data_root / dataname / "metadata" / ("test.tsv" if dataname == "urbansed"
                                                     else "eval/public.tsv"))
    tds.initialize_and_get_df(path, nb_files=kw.get("nb_files"))
    assert tds.n_extracted == n  # a second pass reads the cache


def test_cap_strong_clips(data_root, tmp_path):
    got, want, *_ = prepare(data_root, tmp_path, "dcase")
    # the feature paths differ by their directory
    strip = lambda rows: [{k: v for k, v in r.items() if k != "feature_filename"} for r in rows]
    for n in (1, 2, 10):
        capped = train_lib.cap_strong_clips(got["synthetic"], n)
        assert strip(capped) == strip(jax_rows(jtrain_lib.cap_strong_clips(want["synthetic"], n)))
        assert len({r["filename"] for r in capped}) == min(n, DCASE["strong"])


def items_equal(got, want):
    (dt, yt), (dj, yj) = got, want
    np.testing.assert_array_equal(dt, dj)
    assert dt.dtype == dj.dtype
    assert set(yt) == set(yj) - {"patches"} | ({"patches"} if "patches" in yt else set())
    for k in yt:
        np.testing.assert_array_equal(np.asarray(yt[k]), np.asarray(yj[k]), err_msg=k)


@pytest.mark.parametrize("split, in_memory, cache", [
    ("train", False, False), ("train", True, True), ("eval", False, True),
    ("weak", True, False), ("unlabel", False, False)])
def test_data_load_df_matches_jax(data_root, tmp_path, split, in_memory, cache):
    """``__getitem__``, ``features_only`` and ``targets_only`` on the same rows
    (strong with an empty clip, weak, unlabeled), with and without the RAM
    cache and the cache of transformed items; twice, so the caches serve."""
    dataname = "dcase" if split in ("weak", "unlabel") else "urbansed"
    _, want, *_ = prepare(data_root, tmp_path, dataname, unlabel_data=True)
    df = want[split]
    classes = list(DCASE_CLASSES if dataname == "dcase" else URBAN_CLASSES)
    enc, jenc = BoxEncoder(classes, 10.0), JBoxEncoder(classes, seconds=10.0)
    scaler = Scaler()
    scaler.calculate_scaler(np.load(f) for f in df.feature_filename.drop_duplicates())
    jscaler = JScaler()
    jscaler.load_state_dict(scaler.state_dict())
    tds = dataset.DataLoadDf(jax_rows(df), enc.encode_strong_df, get_transforms(500, scaler),
                             in_memory=in_memory, cache_transformed=cache)
    jds = jdataset.DataLoadDf(df, jenc.encode_strong_df, jget_transforms(500, jscaler),
                              in_memory=in_memory, cache_transformed=cache)
    assert len(tds) == len(jds) > 0 and tds.filenames == list(jds.filenames)
    for _ in range(2):
        for i in range(len(tds)):
            items_equal(tds[i], jds[i])
            ft, fj = tds.features_only(i), jds.features_only(i)
            np.testing.assert_array_equal(ft[0], fj[0])
            assert ft[1] == fj[1]
            items_equal((ft[0], tds.targets_only(i, ft[1])), (fj[0], jds.targets_only(i, fj[1])))
    if split == "weak":
        assert all(len(tds[i][1]["labels"]) > 0 for i in range(len(tds)))
        assert all(tds[i][1]["boxes"].shape == (0,) for i in range(len(tds)))
    if split == "unlabel":
        assert all(len(tds[i][1]["labels"]) == 0 for i in range(len(tds)))
    if split == "eval":  # the clip without events: no labels, and its rows kept
        assert tds._raw_label(0)[-1][3] is None
    assert bool(tds._tcache) == cache


def test_weak_row_without_tags_has_no_labels(tmp_path):
    """An empty ``event_labels`` cell is no label (pandas' NaN), not ``[""]``."""
    for name in "ab":
        np.save(tmp_path / f"{name}.npy", np.ones((5, 4), np.float32))
    rows = [{"filename": "a.wav", "event_labels": None, "feature_filename": str(tmp_path / "a.npy")},
            {"filename": "b.wav", "event_labels": "Cat,Dog",
             "feature_filename": str(tmp_path / "b.npy")}]
    enc = BoxEncoder(list(DCASE_CLASSES), 10.0)
    ds = dataset.DataLoadDf(rows, enc.encode_strong_df)
    assert ds._raw_label(0) == [] and ds._raw_label(1) == ["Cat", "Dog"]
    assert ds[0][1]["labels"].tolist() == [] and ds[1][1]["labels"].tolist() == [2, 4]


@pytest.mark.parametrize("device_patches", [False, True])
def test_patch_branch_matches_jax(data_root, tmp_path, device_patches):
    """SP-SEDT's branch: the same random boxes from one seed, in the same
    order across ``__getitem__`` and ``targets_only``, and the same crops."""
    _, want, *_ = prepare(data_root, tmp_path, "urbansed")
    df = want["train"]
    enc = BoxEncoder(list(URBAN_CLASSES), 10.0)
    jenc = JBoxEncoder(list(URBAN_CLASSES), seconds=10.0)
    tf, jtf = get_transforms(500), jget_transforms(500)
    kw = dict(num_patches=4, device_patches=device_patches, cache_transformed=True)
    tds = dataset.DataLoadDf(jax_rows(df), enc.encode_strong_df, tf,
                             rng=np.random.RandomState(3), **kw)
    jds = jdataset.DataLoadDf(df, jenc.encode_strong_df, jtf, rng=np.random.RandomState(3), **kw)
    assert not tds.cache_transformed
    for i in list(range(len(tds))) * 2:
        got, wanted = tds[i], jds[i]
        items_equal(got, wanted)
        assert ("patches" in got[1]) == (not device_patches)
        if not device_patches:
            assert got[1]["patches"].shape == (4, 128, 64)
        items_equal((got[0], tds.targets_only(i, 431)), (wanted[0], jds.targets_only(i, 431)))


@pytest.mark.parametrize("n_samples, in_memory", [(441000, True), (300000, False),
                                                  (500000, False)])
def test_wav_load_df_matches_jax(data_root, tmp_path, n_samples, in_memory):
    """Raw waveforms cropped or zero-padded to ``n_samples``, with the labels."""
    _, want, *_ = prepare(data_root, tmp_path, "urbansed")
    df = want["train"]
    enc = BoxEncoder(list(URBAN_CLASSES), 10.0)
    jenc = JBoxEncoder(list(URBAN_CLASSES), seconds=10.0)
    tds = dataset.WavLoadDf(jax_rows(df), enc.encode_strong_df, n_samples=n_samples,
                            sr=44100, in_memory=in_memory)
    jds = jdataset.WavLoadDf(df, jenc.encode_strong_df, n_samples=n_samples, sr=44100,
                             in_memory=in_memory)
    for i in list(range(len(tds))) * 2:
        items_equal(tds[i], jds[i])
        assert tds[i][0].shape == (n_samples,)
        ft, fj = tds.features_only(i), jds.features_only(i)
        np.testing.assert_array_equal(ft[0], fj[0])
        assert ft[1] == fj[1] == n_samples
    if n_samples > 441000:
        assert (tds[0][0][441000:] == 0).all()
    batch = dataset.collate([tds[0], tds[1]], 20, 10.0)
    assert batch.feats.shape == (2, n_samples, 1) and batch.pad_mask.shape == (2, 1)
    assert bool(tds._cache) == in_memory


def real_args(data_root, exp_root, dataname, extra=()):
    argv = ["--dataname", dataname, "--data_root", str(data_root), "--exp_root", str(exp_root),
            "--batch_size", "2", "--n_weak", "1"] + list(extra)
    return argv


@pytest.mark.parametrize("dataname, extra", [
    ("urbansed", []), ("urbansed", ["--from_wavs"]), ("dcase", ["--max_strong_clips", "2"])])
def test_build_real_data_matches_jax(data_root, tmp_path, dataname, extra):
    """The scaler (computed and saved, then loaded), each split's length and
    items, the references, and the frontend's arguments with ``--from_wavs``."""
    root = tmp_path / "data"
    shutil.copytree(data_root / dataname, root / dataname)
    argv = real_args(root, tmp_path / "exp_torch", dataname, extra)
    targs = cli.sedt_args(argv)
    jargs = jtrain_lib.get_parser().parse_args(real_args(root, tmp_path / "exp_jax", dataname,
                                                         extra))
    got = train_lib.build_real_data(train_lib.args_to_config(targs), targs)
    want = jtrain_lib.build_real_data(jtrain_lib.args_to_config(jargs), jargs)
    t = got["timings"]
    assert t["extracted"] == t["clips"] > 0 and t["features_s"] > 0
    np.testing.assert_allclose(got["scaler"].mean_, want["scaler"].mean_, rtol=1e-5)
    np.testing.assert_allclose(got["scaler"].std_, want["scaler"].std_, rtol=1e-5)
    assert (tmp_path / "exp_torch" / f"{dataname}.json").is_file()
    again = train_lib.build_real_data(train_lib.args_to_config(targs), targs)
    assert again["timings"]["extracted"] == 0  # the cache and the saved scaler serve
    np.testing.assert_array_equal(again["scaler"].mean_, got["scaler"].mean_)

    for split in ("train", "validation", "eval"):
        assert len(got[split]) == len(want[split]) > 0, split
    streams = got["train"].datasets if dataname == "dcase" else [got["train"]]
    jstreams = want["train"].datasets if dataname == "dcase" else [want["train"]]
    for ts, js in zip(streams, jstreams):
        assert type(ts).__name__ == type(js).__name__
        assert ts.filenames == list(js.filenames)
    if dataname == "dcase":
        assert len(streams[0]) == 2  # --max_strong_clips
    for k in ("ref_valid", "ref_eval"):
        assert list(want[k].columns) == ["filename", "onset", "offset", "event_label"]
        assert got[k] == [tuple(r.values()) for r in jax_rows(want[k])]
    if "--from_wavs" in extra:
        fe, jfe = got["frontend"], want["frontend"]
        assert fe.keys() == jfe.keys()
        for k in fe:
            np.testing.assert_allclose(fe[k], jfe[k], rtol=1e-5)
        items_equal(got["train"][0], want["train"][0])
    else:
        assert "frontend" not in got
        for i in range(len(got["eval"])):
            (dt, yt), (dj, yj) = got["eval"][i], want["eval"][i]
            np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)
            for k in yt:
                np.testing.assert_array_equal(yt[k], yj[k])
