"""The rest of DSP on the port against the JAX package's, on the CPU:
``wav_to_mel`` (the STFT magnitude, the mel product, the log floor) held to
the JAX package's and to tests/resources/golden_mel.npy within the JAX
package's own golden tolerance (rtol 1e-5, atol 1e-5); YIN held to
golden_pitch.npy (rtol 1e-5, atol 1e-3, as tests/test_dsp.py) and, like
the trims, the resampler, ``load_wav`` and the attention scores, equal to
the JAX package's (the same numpy code: exact); the factory's fallbacks to
YIN; the preprocessing keys the constructor keeps."""

from pathlib import Path

import numpy as np
import pytest
import torch

from forwardtacotron_torch.dsp.dsp import DSP, LOG_MEL_FLOOR, resample
from forwardtacotron_torch.dsp.pitch import (YinPitchExtractor,
                                             new_pitch_extractor_from_config)
from forwardtacotron_torch.ops.stft import stft_magnitude
from forwardtacotron_torch.utils.files import read_config
from forwardtacotron_torch.utils.metrics import attention_score

REPO = Path(__file__).resolve().parent.parent
RESOURCES = REPO / 'tests' / 'resources'


@pytest.fixture(scope='module')
def config():
    return read_config(REPO / 'configs' / 'singlespeaker.yaml')


@pytest.fixture(scope='module')
def dsps(config):
    from forwardtacotron_tpu.dsp.dsp import DSP as JaxDSP
    return DSP.from_config(config, device='cpu'), JaxDSP.from_config(config)


def speech_like(seed, seconds=1.5, sr=22050):
    """A voiced tone with a pause and quiet noise: something for the trims
    and the VAD to cut."""
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.5 * np.sin(2 * np.pi * 180 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    wav[int(0.4 * sr):int(1.0 * sr)] = 0.0
    wav = np.concatenate([np.zeros(sr // 4), wav, np.zeros(sr // 3)])
    return (wav + 1e-4 * rs.randn(len(wav))).astype(np.float32)


def test_wav_to_mel_matches_jax_and_golden(dsps):
    port, jax_dsp = dsps
    y = np.load(RESOURCES / 'golden_wav.npy')
    golden = np.load(RESOURCES / 'golden_mel.npy')
    mel = port.wav_to_mel(y)
    assert mel.shape == golden.shape == (80, 130) and mel.dtype == np.float32
    np.testing.assert_allclose(mel, golden, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mel, np.asarray(jax_dsp.wav_to_mel(y)),
                               rtol=1e-5, atol=1e-5)
    assert mel.min() == np.float32(np.log(LOG_MEL_FLOOR))
    raw = port.wav_to_mel(y, normalize=False)
    np.testing.assert_allclose(raw, np.asarray(jax_dsp.wav_to_mel(
        y, normalize=False)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.normalize(raw), mel, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(port.denormalize(mel),
                               jax_dsp.denormalize(mel), rtol=0, atol=0)


def test_stft_magnitude_matches_jax():
    from forwardtacotron_tpu.ops.stft import stft_magnitude as jax_mag

    y = np.random.RandomState(0).randn(3001).astype(np.float32)
    got = stft_magnitude(torch.from_numpy(y), 512, 128, 400).numpy()
    want = np.asarray(jax_mag(y, 512, 128, 400))
    assert got.shape == want.shape == (257, 1 + 3001 // 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_pitch_matches_golden_and_jax(config):
    from forwardtacotron_tpu.dsp.pitch import YinPitchExtractor as JaxYin

    y = np.load(RESOURCES / 'golden_wav.npy')
    golden = np.load(RESOURCES / 'golden_pitch.npy')
    pitch = YinPitchExtractor(sample_rate=22050, hop_length=256,
                              fmin=30.0, fmax=600.0)(y)
    np.testing.assert_allclose(pitch, golden, rtol=1e-5, atol=1e-3)
    wav = speech_like(1)
    np.testing.assert_array_equal(
        new_pitch_extractor_from_config(config)(wav),
        JaxYin(22050, 256, 30.0, 600.0)(wav))


@pytest.mark.parametrize('kind', ['pyworld', 'librosa'])
def test_pitch_factory_falls_back_to_yin(config, kind):
    pre = dict(config['preprocessing'], pitch_extractor=kind)
    extractor = new_pitch_extractor_from_config(dict(config,
                                                     preprocessing=pre))
    try:
        __import__(kind)
    except ImportError:
        assert isinstance(extractor, YinPitchExtractor)
    with pytest.raises(ValueError, match='Unknown pitch extractor'):
        new_pitch_extractor_from_config(dict(config, preprocessing=dict(
            pre, pitch_extractor='crepe')))


def test_trims_and_resample_match_jax(dsps):
    from forwardtacotron_tpu.dsp.dsp import resample as jax_resample

    port, jax_dsp = dsps
    for seed in (0, 1):
        wav = speech_like(seed)
        trimmed = port.trim_silence(wav)
        assert 0 < len(trimmed) < len(wav)
        np.testing.assert_array_equal(trimmed, jax_dsp.trim_silence(wav))
        shortened = port.trim_long_silences(wav)
        assert len(shortened) < len(wav)
        np.testing.assert_array_equal(shortened,
                                      jax_dsp.trim_long_silences(wav))
        for sr in (16000, 44100):
            np.testing.assert_array_equal(resample(wav, 22050, sr),
                                          jax_resample(wav, 22050, sr))
    assert len(port.trim_silence(np.zeros(100, np.float32))) == 100
    assert resample(wav, 22050, 22050) is wav


def test_load_wav_round_trip_matches_jax(dsps, tmp_path):
    from scipy.io import wavfile

    port, jax_dsp = dsps
    wav = speech_like(2)
    port.save_wav(wav, tmp_path / 'a.wav')
    got = port.load_wav(tmp_path / 'a.wav')
    np.testing.assert_array_equal(got, jax_dsp.load_wav(tmp_path / 'a.wav'))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, wav, rtol=0, atol=2 / 32768)
    # stereo 16-bit at another rate: channels averaged, resampled
    pcm = (np.stack([wav, 0.5 * wav], 1) * 32767).astype(np.int16)
    wavfile.write(str(tmp_path / 'b.wav'), 16000, pcm)
    got = port.load_wav(tmp_path / 'b.wav')
    np.testing.assert_array_equal(got, jax_dsp.load_wav(tmp_path / 'b.wav'))
    assert abs(len(got) - len(wav) * 22050 / 16000) <= 1
    # float and uint8 files
    wavfile.write(str(tmp_path / 'c.wav'), 22050, wav)
    wavfile.write(str(tmp_path / 'd.wav'), 22050,
                  (wav * 127 + 128).astype(np.uint8))
    for name in ('c.wav', 'd.wav'):
        np.testing.assert_array_equal(port.load_wav(tmp_path / name),
                                      jax_dsp.load_wav(tmp_path / name))
    try:
        import soundfile  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match='soundfile'):
            port.load_wav(tmp_path / 'e.flac')


def test_dsp_keeps_the_preprocessing_keys(config, dsps):
    port, jax_dsp = dsps
    for attr in ('n_mels', 'sample_rate', 'hop_length', 'win_length',
                 'n_fft', 'fmin', 'fmax', 'should_peak_norm',
                 'should_trim_start_end_silence',
                 'should_trim_long_silences', 'trim_silence_top_db',
                 'vad_sample_rate', 'vad_window_length',
                 'vad_moving_average_width', 'vad_max_silence_length'):
        assert getattr(port, attr) == getattr(jax_dsp, attr), attr
    assert port.device.type == 'cpu'


def test_attention_score_matches_jax():
    from forwardtacotron_tpu.utils.metrics import \
        attention_score as jax_score

    rs = np.random.RandomState(4)
    att = rs.rand(4, 15, 9)
    att /= att.sum(-1, keepdims=True)
    for r in (1, 3):
        lens = np.array([15, 12, 7, 3]) * r
        for got, want in zip(attention_score(att, lens, r),
                             jax_score(att, lens, r)):
            np.testing.assert_array_equal(got, want)
