"""The predict slice of the PyTorch port as a whole against the JAX package:
the same seeded waveforms and the same weights (one flax init through
``weights.from_flax``) through the JAX frontend + ``model.apply`` +
``postprocess`` and through the port's ``make_infer``, f32 at the tiny test
geometry; then the CLI around it, its flag surface and the checkpoint format.

Tolerances: features 1e-3 dB (the DFT and mel products sum in another order),
scores and boxes 1e-4 (f32 convolution and matmul sums in another order on
top of that), labels equal wherever the best two class scores of a query
differ by more than that tolerance."""
import csv
import dataclasses
from functools import partial

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sound_event_detection_transformer_tpu import train_lib as jtrain_lib
from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.models import postprocess as jpostprocess
from sound_event_detection_transformer_tpu.ops import frontend as jfrontend
from sound_event_detection_transformer_tpu_torch import predict_cli, train_lib
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.data.scaler import Scaler
from sound_event_detection_transformer_tpu_torch.models import build_model as tbuild
from sound_event_detection_transformer_tpu_torch.models import transformer as ttransformer
from sound_event_detection_transformer_tpu_torch.ops.attention import scaled_dot_attention
from sound_event_detection_transformer_tpu_torch.ops.frontend import make_frontend_fn
from sound_event_detection_transformer_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
B = 3


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


def _frontend_kw(cfg, scaler):
    fc = cfg.features
    return dict(sr=fc.sample_rate, n_fft=fc.n_fft, n_window=fc.n_window, hop=fc.hop_size,
                n_mels=fc.n_mels, max_frames=cfg.model.max_frames, scaler_mean=scaler.mean_,
                scaler_std=scaler.std_, compute_log=fc.compute_log)


@pytest.fixture(scope="module")
def slice_pair():
    """Waveforms, a scaler, the JAX side's features and model output, and the
    port's model with the same weights."""
    jcfg, tcfg = JConfig.tiny_test(), TConfig.tiny_test()
    fc = jcfg.features
    rng = np.random.RandomState(0)
    n = int(fc.max_len_seconds * fc.sample_rate)
    waves = (rng.randn(B, n) * 0.05).astype(np.float32)
    t = np.arange(n) / fc.sample_rate
    waves[0, 2000:9000] += 0.4 * np.sin(2 * np.pi * 440.0 * t[2000:9000]).astype(np.float32)
    waves[2, n // 3:] = 0.0  # a short clip, zero-padded
    scaler = Scaler()
    mean = rng.uniform(-50, -30, fc.n_mels)
    scaler.load_state_dict({"mean_": mean.tolist(),
                            "mean_of_square_": (mean**2 + rng.uniform(25, 200, fc.n_mels)).tolist()})

    jmodel, _ = jbuild(jcfg)
    feats = jfrontend.make_frontend_fn(**_frontend_kw(jcfg, scaler))(jnp.asarray(waves))
    pad = jnp.zeros(feats.shape[:2], bool)
    v = jax.jit(lambda r: jmodel.init({"params": r}, feats, pad, True))(jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, flax.core.unfreeze(v["params"]))
    frozen = _random_frozen(jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"])), rng)
    out = jmodel.apply({"params": params, "frozen": frozen}, feats, pad, True)

    tmodel, _ = tbuild(tcfg, device="cpu")
    tmodel.load_state_dict(from_flax(params, frozen), strict=True)
    return tcfg, waves, scaler, np.asarray(feats), out, tmodel


def _jax_predictions(cfg, out, at_m):
    tags = (out["at"] > 0.5).astype(jnp.float32)
    sizes = jnp.full((B,), cfg.features.max_len_seconds)
    pp = jpostprocess(out, sizes, audio_tags=tags, at_m=at_m)
    return tuple(np.asarray(x) for x in (pp.scores, pp.labels, pp.boxes))


def _compare(got, want):
    scores, labels, boxes = (x.numpy() for x in got)
    jscores, jlabels, jboxes = want
    np.testing.assert_allclose(scores, jscores, **TOL)
    np.testing.assert_allclose(boxes, jboxes, **TOL)
    assert labels.dtype == np.int32 and labels.shape == jlabels.shape
    return labels, jlabels


def test_features_match_jax(slice_pair):
    cfg, waves, scaler, jfeats, _, _ = slice_pair
    feats = make_frontend_fn(**_frontend_kw(cfg, scaler))(torch.from_numpy(waves))
    assert feats.shape == jfeats.shape == (B, cfg.model.max_frames, cfg.model.n_mels, 1)
    np.testing.assert_allclose(feats.numpy(), jfeats, atol=1e-3, rtol=0)


@pytest.mark.parametrize("at_m", [1, 2, 3])
def test_infer_matches_jax(slice_pair, at_m):
    cfg, waves, scaler, _, out, tmodel = slice_pair
    got = predict_cli.make_infer(cfg, tmodel, scaler, at_m=at_m, device="cpu")(waves)
    labels, jlabels = _compare(got, _jax_predictions(cfg, out, at_m))
    # the class scores behind the labels, as fusion strategy 1 gates them
    probs = np.asarray(jax.nn.softmax(out["pred_logits"], -1))[..., :-1]
    if at_m == 1:
        probs = probs * np.asarray(out["at"] > 0.5)[:, None, :]
        top2 = np.sort(probs, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > TOL["atol"]
        assert clear.any()
        np.testing.assert_array_equal(labels[clear], jlabels[clear])
    # no audio tag sits within the tolerance of its threshold
    assert (np.abs(np.asarray(out["at"]) - 0.5) > 1e-3).all()


def test_infer_through_the_flash_wrapper_matches_jax(slice_pair, monkeypatch):
    """Every attention of the model forced through K4's wrapper, which on the
    CPU runs the kernel's plain blockwise version."""
    cfg, waves, scaler, _, out, tmodel = slice_pair
    calls = []
    def flash(q, k, v, bias=None):
        calls.append(k.shape[-2])
        return scaled_dot_attention(q, k, v, bias, use_flash=True)
    monkeypatch.setattr(ttransformer, "scaled_dot_attention", flash)
    got = predict_cli.make_infer(cfg, tmodel, scaler, at_m=1, device="cpu")(torch.from_numpy(waves))
    m = cfg.model
    assert len(calls) == m.enc_layers + 2 * m.dec_layers
    _compare(got, _jax_predictions(cfg, out, 1))


def test_infer_needs_a_device_without_cuda(slice_pair, monkeypatch):
    cfg, _, _, _, _, tmodel = slice_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_cli.make_infer(cfg, tmodel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_cli.main(["--checkpoint", "x", "--wav_dir", "y"])


# ------------------------------------------------------------------- CLI

FLAGS = [
    "--dataname", "urbansed", "--backbone", "resnet18",
    "--enc_layers", "1", "--dec_layers", "1", "--num_queries", "5",
    "--batch_size", "2", "--dec_at",
]


def test_predict_cli_writes_tsv(tmp_path, capsys):
    """``run`` is ``main`` after argument parsing, on the CPU here: three 1 s
    wavs (a ragged last batch), a checkpoint in the port's format, a scaler
    found at its default place."""
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        wavfile.write(str(wav_dir / f"c{i}.wav"), 44100, (rng.randn(44100) * 3000).astype(np.int16))
    out_path = tmp_path / "pred.tsv"
    argv = ["--checkpoint", str(tmp_path / "ckpt"), "--wav_dir", str(wav_dir),
            "--out", str(out_path), "--threshold", "0.0", "--exp_root", str(tmp_path)] + FLAGS
    args = predict_cli.build_parser().parse_args(argv)
    cfg = train_lib.args_to_config(args)
    model, _ = tbuild(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    save_checkpoint(args.checkpoint, {"model": model.state_dict(), "epoch": 3})
    sc = Scaler()
    sc.calculate_scaler([rng.randn(50, cfg.features.n_mels) * 15 - 40 for _ in range(3)])
    sc.save(str(tmp_path / "urbansed.json"))

    n_events = predict_cli.run(args, device="cpu")
    printed = capsys.readouterr().out
    assert "using training scaler" in printed and f"wrote {n_events} events for 3 files" in printed
    with open(out_path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    assert rows[0] == ["filename", "onset", "offset", "event_label", "score"]
    assert len(rows) == n_events + 1
    seconds = cfg.features.max_len_seconds
    for name, onset, offset, label, score in rows[1:]:
        assert name in {"c0.wav", "c1.wav", "c2.wav"} and label in cfg.data.classes
        assert 0.0 <= float(onset) <= float(offset) <= seconds and 0.0 <= float(score) <= 1.0
    # the rows are what the inner functions give for the same files
    infer = predict_cli.make_infer(cfg, model, sc, args.at_m, device="cpu")
    wavs = sorted(str(p) for p in wav_dir.glob("*.wav"))
    again = predict_cli.predict_files(cfg, infer, wavs, args.batch_size, args.threshold)
    assert [r[0] for r in again] == [r[0] for r in rows[1:]]
    np.testing.assert_allclose([r[1] for r in again], [float(r[1]) for r in rows[1:]], atol=1e-5)
    with pytest.raises(FileNotFoundError):
        predict_cli.run(predict_cli.build_parser().parse_args(
            argv[:3] + [str(tmp_path / "empty")] + argv[4:]), device="cpu")


FLAG_SETS = [
    [],
    FLAGS + ["--compute_dtype", "float32", "--fusion_strategy", "1", "2", "--lr", "3e-4"],
    ["--dataname", "dcase", "--num_queries", "7", "--n_weak", "8", "--focal_loss", "--fine_tune",
     "--pooling", "attn", "--mix_up_ratio", "0.5", "--time_mask", "--checkpoint_epochs", "5",
     "--max_strong_clips", "100", "--info", "run1", "--dilation", "--pre_norm"],
    ["--dataname", "urbansed", "--synthetic_smoke", "--num_queries", "20", "--num_classes", "4",
     "--position_embedding", "learned", "--no_aux_loss", "--epsilon", "0.5"],
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["defaults", "predict", "dcase", "smoke"])
def test_args_to_config_matches_jax_field_by_field(flags):
    """The same command line gives the same configuration on both sides."""
    targs = train_lib.get_parser().parse_args(flags)
    jargs = jtrain_lib.get_parser().parse_args(flags)
    assert vars(targs) == vars(jargs)
    tcfg, jcfg = train_lib.args_to_config(targs), jtrain_lib.args_to_config(jargs)
    for part in ("features", "model", "loss", "data", "augment", "train"):
        assert dataclasses.asdict(getattr(tcfg, part)) == dataclasses.asdict(getattr(jcfg, part)), part


def test_presets_match_jax_field_by_field():
    for preset in ("urbansed_supervised", "tiny_test"):
        tcfg, jcfg = getattr(TConfig, preset)(), getattr(JConfig, preset)()
        for part in ("features", "model", "loss", "data", "augment", "train"):
            assert dataclasses.asdict(getattr(tcfg, part)) == dataclasses.asdict(
                getattr(jcfg, part)), (preset, part)


def test_checkpoint_round_trip_is_atomic(tmp_path):
    model, _ = tbuild(TConfig.tiny_test(), device="cpu", generator=torch.Generator().manual_seed(1))
    path = tmp_path / "deep" / "dir" / "best"
    save_checkpoint(str(path), {"model": model.state_dict(), "epoch": 7, "metrics": {"f1": 0.5}})
    save_checkpoint(str(path), {"model": model.state_dict(), "epoch": 8, "metrics": {"f1": 0.6}})
    assert [p.name for p in path.parent.iterdir()] == ["best"]  # no temporary file left
    state = load_checkpoint(str(path))
    assert state["epoch"] == 8 and state["metrics"] == {"f1": 0.6}
    fresh, _ = tbuild(TConfig.tiny_test(), device="cpu")
    fresh.load_state_dict(state["model"], strict=True)
    for a, b in zip(fresh.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
