"""The port's frontend (ops/frontend.py, data/features.py, data/scaler.py)
against the JAX package's on the same seeded waveforms, and the JAX package's
own frontend tests mirrored on the port.

Tolerance 1e-3 dB absolute for the log-mel features in f32: the DFT and mel
products sum in another order on the two sides.  The rFFT branch against the
matmul branch, and the numpy mirror against the device path, keep the JAX
tests' looser dB bounds (0.1 and 0.05)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.config import FeatureConfig as JFeatureConfig
from sound_event_detection_transformer_tpu.data import features as jfeatures
from sound_event_detection_transformer_tpu.data import scaler as jscaler
from sound_event_detection_transformer_tpu.ops import frontend as jfrontend
from sound_event_detection_transformer_tpu_torch.config import FeatureConfig
from sound_event_detection_transformer_tpu_torch.data import features, scaler
from sound_event_detection_transformer_tpu_torch.ops import frontend

torch.set_num_threads(2)
DB_TOL = 1e-3
TINY = dict(sr=8000, n_fft=256, n_window=256, hop=128, n_mels=32)
URBAN_LIKE = dict(sr=8000, n_fft=512, n_window=440, hop=220, n_mels=40)  # window < n_fft


def _wave(seed, n, scale=0.05):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def test_frame_count_matches_librosa_center_mode():
    # DCASE: 10 s @ 16 kHz, hop 323 -> 1 + 160000 // 323 = 496
    mel = frontend.waveform_to_logmel(torch.zeros(160000), sr=16000, n_fft=1024, n_window=1024,
                                      hop=323, n_mels=64)
    assert mel.shape == (496, 64)
    # URBAN-SED at 10 s: 501 frames (cropped to 500 by make_frontend_fn)
    frames = frontend.frame_signal(torch.zeros(2, 441000), 2048, 882)
    assert frames.shape == (2, 501, 2048)


def test_matmul_dft_equals_rfft():
    y = torch.from_numpy(_wave(0, 32000, 0.1))
    kw = dict(sr=16000, n_fft=512, n_window=512, hop=160, n_mels=40)
    a = frontend.waveform_to_logmel(y, use_matmul_dft=True, **kw).numpy()
    b = frontend.waveform_to_logmel(y, use_matmul_dft=False, **kw).numpy()
    assert np.abs(a - b).max() < 0.1  # dB scale


def test_host_numpy_mirror_agrees_with_device():
    fc = FeatureConfig(sample_rate=8000, n_window=256, n_fft=256, hop_size=128, n_mels=32,
                       max_len_seconds=2.0)
    y = _wave(1, 16000)
    host = features.logmel_numpy(y, fc)
    dev = frontend.waveform_to_logmel(
        torch.from_numpy(y), sr=fc.sample_rate, n_fft=fc.n_fft, n_window=fc.n_window,
        hop=fc.hop_size, n_mels=fc.n_mels, use_matmul_dft=False).numpy()
    assert host.shape == dev.shape
    assert np.abs(host - dev).max() < 0.05
    # and the two packages' numpy mirrors are the same computation
    jfc = JFeatureConfig(sample_rate=8000, n_window=256, n_fft=256, hop_size=128, n_mels=32,
                         max_len_seconds=2.0)
    np.testing.assert_allclose(host, jfeatures.logmel_numpy(y, jfc), atol=1e-5)


def test_mel_filterbank_structure():
    fb = frontend.mel_filterbank(16000, 1024, 64)
    assert fb.shape == (64, 513)
    assert (fb >= 0).all()
    assert (fb.sum(1) > 0).all()
    assert (np.diff(fb.argmax(1)) >= 0).all()


def test_slaney_mel_scale_invertible():
    f = np.array([0.0, 500.0, 1000.0, 4000.0, 8000.0])
    np.testing.assert_allclose(frontend.mel_to_hz(frontend.hz_to_mel(f)), f, rtol=1e-6)
    np.testing.assert_allclose(frontend.hz_to_mel(np.array(500.0)), 7.5)


def test_amplitude_to_db_semantics():
    s = torch.tensor([1.0, 0.1, 1e-8])
    np.testing.assert_allclose(frontend.amplitude_to_db(s, top_db=None).numpy(),
                               [0.0, -20.0, -100.0], atol=1e-3)
    np.testing.assert_allclose(frontend.amplitude_to_db(s, top_db=80.0).numpy(),
                               [0.0, -20.0, -80.0], atol=1e-3)


def test_amplitude_to_db_clips_against_each_clips_own_maximum():
    s = torch.tensor([[1.0, 1e-8], [1e-3, 1e-8]])
    db = frontend.amplitude_to_db(s, batch_dims=1).numpy()
    np.testing.assert_allclose(db, [[0.0, -80.0], [-60.0, -100.0]], atol=1e-3)


def test_constants_are_the_jax_packages():
    """Window, mel weights and DFT basis come from the same numpy code."""
    np.testing.assert_array_equal(frontend.hamming_window(1764), jfrontend.hamming_window(1764))
    np.testing.assert_array_equal(frontend.mel_filterbank(44100, 2048, 64),
                                  jfrontend.mel_filterbank(44100, 2048, 64))
    win = frontend.padded_window(440, 512)
    assert win.shape == (512,) and win[:36].max() == 0.0 and win[36] > 0.0
    np.testing.assert_array_equal(frontend.dft_basis(512, win), jfrontend.dft_basis(512, win))
    w, m = features._stft_constants(8000, 512, 440, 40)
    jw, jm = jfeatures._stft_constants(8000, 512, 440, 40)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(m, jm)


@pytest.mark.parametrize("use_matmul_dft", [True, False], ids=["matmul", "rfft"])
@pytest.mark.parametrize("kw", [TINY, URBAN_LIKE], ids=["tiny", "padded_window"])
def test_waveform_to_logmel_matches_jax(kw, use_matmul_dft):
    y = _wave(2, 16000)
    y[9000:] *= 1e-4  # a quiet tail, so top_db clips
    want = np.asarray(jfrontend.waveform_to_logmel(jnp.asarray(y), use_matmul_dft=use_matmul_dft,
                                                   **kw))
    got = frontend.waveform_to_logmel(torch.from_numpy(y), use_matmul_dft=use_matmul_dft, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=DB_TOL, rtol=0)
    mag = frontend.stft_magnitude(torch.from_numpy(y), kw["n_fft"], kw["hop"],
                                  frontend.padded_window(kw["n_window"], kw["n_fft"]),
                                  use_matmul_dft)
    jmag = jfrontend.stft_magnitude(jnp.asarray(y), kw["n_fft"], kw["hop"],
                                    frontend.padded_window(kw["n_window"], kw["n_fft"]),
                                    use_matmul_dft)
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), atol=1e-4, rtol=1e-4)


def test_no_log_branch_matches_jax():
    y = _wave(3, 8000)
    want = np.asarray(jfrontend.waveform_to_logmel(jnp.asarray(y), compute_log=False, **TINY))
    got = frontend.waveform_to_logmel(torch.from_numpy(y), compute_log=False, **TINY)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _scaler_stats(n_mels):
    rs = np.random.RandomState(4)
    return rs.uniform(-50, -30, n_mels).astype(np.float32), rs.uniform(5, 20, n_mels).astype(
        np.float32)


@pytest.mark.parametrize("with_scaler", [False, True], ids=["raw", "scaled"])
@pytest.mark.parametrize("n_samples,max_frames", [(8000, 128), (16000, 100)],
                         ids=["short_padded", "long_cropped"])
def test_make_frontend_fn_matches_jax(n_samples, max_frames, with_scaler):
    """A batch whose last clip has a zero-padded tail: its top_db clip must be
    its own, not the batch's."""
    waves = np.stack([_wave(5, n_samples), _wave(6, n_samples, 0.5), _wave(7, n_samples)])
    waves[2, n_samples // 3:] = 0.0
    mean, std = _scaler_stats(TINY["n_mels"]) if with_scaler else (None, None)
    kw = dict(max_frames=max_frames, scaler_mean=mean, scaler_std=std, **TINY)
    want = np.asarray(jfrontend.make_frontend_fn(**kw)(jnp.asarray(waves)))
    got = frontend.make_frontend_fn(**kw)(torch.from_numpy(waves))
    assert got.shape == want.shape == (3, max_frames, TINY["n_mels"], 1)
    # after the scaler a dB difference shrinks by std >= 5
    np.testing.assert_allclose(got.numpy(), want, atol=DB_TOL, rtol=0)
    # collated wav batches carry a trailing axis
    got3 = frontend.make_frontend_fn(**kw)(torch.from_numpy(waves)[..., None])
    np.testing.assert_array_equal(got3.numpy(), got.numpy())


def test_scaler_matches_jax_and_round_trips(tmp_path):
    rs = np.random.RandomState(8)
    data = [rs.randn(20, 6).astype(np.float32) * 3 - 1 for _ in range(5)]
    sc, jsc = scaler.Scaler(), jscaler.Scaler()
    mean, std = sc.calculate_scaler(data)
    jmean, jstd = jsc.calculate_scaler(data)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    np.testing.assert_array_equal(sc.normalize(data[0]), jsc.normalize(data[0]))
    sc.save(str(tmp_path / "scaler.json"))
    loaded = scaler.Scaler()
    loaded.load(str(tmp_path / "scaler.json"))
    np.testing.assert_allclose(loaded.mean_, mean)
    np.testing.assert_allclose(loaded.std_, std)
    jloaded = jscaler.Scaler()
    jloaded.load(str(tmp_path / "scaler.json"))  # one file format on both sides
    np.testing.assert_allclose(jloaded.std_, loaded.std_)
    assert loaded.state_dict().keys() == jsc.state_dict().keys()
    for norm, kind in [("global", "standard"), ("per_band", "max"), ("per_band", "mean")]:
        np.testing.assert_allclose(scaler.ScalerPerAudio(norm, kind).normalize(data[1]),
                                   jscaler.ScalerPerAudio(norm, kind).normalize(data[1]))


def test_read_audio_matches_jax(tmp_path):
    from scipy.io import wavfile

    rs = np.random.RandomState(9)
    stereo = (rs.randn(4000, 2) * 3000).astype(np.int16)
    path = str(tmp_path / "clip.wav")
    wavfile.write(path, 16000, stereo)
    audio, fs = features.read_audio(path, 8000)  # int16 stereo, resampled to mono 8 kHz
    jaudio, jfs = jfeatures.read_audio(path, 8000)
    assert fs == jfs == 8000 and audio.dtype == np.float32 and audio.shape == (2000,)
    np.testing.assert_array_equal(audio, jaudio)
    audio, fs = features.read_audio(path)
    assert fs == 16000 and audio.shape == (4000,) and np.abs(audio).max() <= 1.0
