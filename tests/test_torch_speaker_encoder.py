"""The speaker encoder on the port against the JAX package's, on the CPU.

- the module's ``state_dict`` is the published layout (``nn.LSTM(40, 256,
  3)`` + ``nn.Linear(256, 256)``); ``init_voice_encoder_params`` draws from
  a seeded torch generator;
- with the JAX package's parameters: the forward on mel partials within
  1e-5, ``embed_utterance`` (22,050 Hz in, resampled, 4 partials) within
  1e-4, the 40-mel power spectrogram within 1e-5 of its scale;
- ``compute_partial_slices`` on the JAX test's lengths: equal slices;
- ``load_resemblyzer_weights`` on a seeded ``torch.save``, plain and under
  ``model_state`` with the published extra keys: the same arrays as the
  JAX loader; an unrelated checkpoint and wrong shapes raise
  ``ValueError`` in both;
- ``preprocess_for_embedding``: equal to the JAX package's;
- ``make_speaker_encoder``: the VoiceEncoder with ``$RESEMBLYZER_WEIGHTS``
  (embedding within 1e-4 of the JAX package's), the mel-statistics
  fallback for an unrelated file and for none.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from forwardtacotron_torch.data.preprocess import (MelStatsSpeakerEncoder,
                                                   make_speaker_encoder)
from forwardtacotron_torch.models import speaker_encoder as se

SR = 22050
# 82,688 samples at 22,050 Hz resample to 60,001 at 16 kHz: 4 partials
N_SAMPLES = 82688


@pytest.fixture(scope='module')
def jax_params():
    from forwardtacotron_tpu.models.speaker_encoder import \
        init_voice_encoder_params
    return init_voice_encoder_params(seed=3)


@pytest.fixture(scope='module')
def jax_encoder(jax_params):
    from forwardtacotron_tpu.models.speaker_encoder import VoiceEncoder
    return VoiceEncoder(jax_params)


def voiced_wav(seed=1, n=N_SAMPLES):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 140 * t) * (1 + 0.3 * np.sin(3 * t))
            + 0.05 * rs.randn(n)).astype(np.float32)


def test_published_layout_and_seeded_init(jax_params):
    enc = se.VoiceEncoder(device='cpu')
    state = enc.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in jax_params.items()}
    a, b = se.init_voice_encoder_params(1), se.init_voice_encoder_params(2)
    for k, v in se.init_voice_encoder_params(1).items():
        np.testing.assert_array_equal(v, a[k])
        assert np.abs(v).max() <= 1 / 16 and not np.array_equal(v, b[k])


def test_forward_and_embed_utterance_match_jax(jax_params, jax_encoder):
    from forwardtacotron_tpu.models.speaker_encoder import \
        wav_to_mel_spectrogram as jax_mel

    enc = se.VoiceEncoder(jax_params, device='cpu')
    mels = np.random.RandomState(0).rand(4, se.PARTIAL_N_FRAMES,
                                         se.MEL_N_CHANNELS).astype(np.float32)
    got = enc.embed_frames_batch(mels)
    np.testing.assert_allclose(got, jax_encoder.embed_frames_batch(mels),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    wav = voiced_wav()
    emb = enc.embed_utterance(wav, source_sr=SR)
    assert emb.shape == (se.MODEL_EMB,)
    np.testing.assert_allclose(emb, jax_encoder.embed_utterance(
        wav, source_sr=SR), rtol=0, atol=1e-4)
    wav16 = voiced_wav(2, 16000)
    mel = se.wav_to_mel_spectrogram(torch.from_numpy(wav16)).numpy()
    want = jax_mel(wav16)
    assert mel.shape == want.shape == (101, se.MEL_N_CHANNELS)
    np.testing.assert_allclose(mel, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('n_samples', [160 * 160, 160 * 240, 160 * 80,
                                       60001, 1])
def test_partial_slices_match_jax(n_samples):
    from forwardtacotron_tpu.models.speaker_encoder import \
        compute_partial_slices as jax_slices
    got = se.compute_partial_slices(n_samples)
    assert got == jax_slices(n_samples)
    assert len(got[1]) == {60001: 4, 160 * 240: 2}.get(n_samples, 1)


def _write_checkpoint(path: Path, kind: str, params) -> Path:
    state = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    if kind == 'model_state':      # the published release's layout
        state = {'model_state': {**state,
                                 'similarity_weight': torch.tensor([10.0]),
                                 'similarity_bias': torch.tensor([-5.0])},
                 'step': 1_560_000}
    elif kind == 'unrelated':
        state = {'model': {'conv.weight': torch.zeros(3, 3)}, 'step': 1}
    elif kind == 'wrong_shapes':
        state['linear.weight'] = torch.zeros(128, 256)
    torch.save(state, path)
    return path


@pytest.mark.parametrize('kind', ['plain', 'model_state', 'unrelated',
                                  'wrong_shapes'])
def test_load_weights_like_jax(tmp_path, kind, jax_params):
    from forwardtacotron_tpu.models.speaker_encoder import \
        load_resemblyzer_weights as jax_load

    path = _write_checkpoint(tmp_path / 'pretrained.pt', kind, jax_params)
    if kind in ('unrelated', 'wrong_shapes'):
        for fn in (se.load_resemblyzer_weights, jax_load):
            with pytest.raises(ValueError):
                fn(str(path))
        with pytest.raises(ValueError):
            se.VoiceEncoder(weights_path=str(path), device='cpu')
        return
    got = se.load_resemblyzer_weights(str(path))
    want = jax_load(str(path))
    assert sorted(got) == sorted(want) == sorted(jax_params)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    enc = se.VoiceEncoder(weights_path=str(path), device='cpu')
    for k, v in enc.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jax_params[k])


def test_preprocess_for_embedding_matches_jax():
    from forwardtacotron_tpu.models.speaker_encoder import \
        preprocess_for_embedding as jax_pre

    wav = voiced_wav(3)
    wav[20000:60000] *= 1e-3                     # a long quiet stretch
    got = se.preprocess_for_embedding(wav, SR)
    want = jax_pre(wav, SR)
    assert len(got) < N_SAMPLES * 16000 / SR - 16000   # trimmed
    np.testing.assert_array_equal(got, want)


def test_make_speaker_encoder_order(tmp_path, monkeypatch, jax_params):
    from forwardtacotron_tpu.data.preprocess import \
        make_speaker_encoder as jax_make

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    monkeypatch.delenv('RESEMBLYZER_WEIGHTS', raising=False)
    assert isinstance(make_speaker_encoder(16, 'cpu'),
                      MelStatsSpeakerEncoder)
    bad = _write_checkpoint(tmp_path / 'bad.pt', 'unrelated', jax_params)
    monkeypatch.setenv('RESEMBLYZER_WEIGHTS', str(bad))
    assert isinstance(make_speaker_encoder(16, 'cpu'),
                      MelStatsSpeakerEncoder)
    good = _write_checkpoint(tmp_path / 'pretrained.pt', 'model_state',
                             jax_params)
    monkeypatch.setenv('RESEMBLYZER_WEIGHTS', str(good))
    enc = make_speaker_encoder(16, 'cpu')
    assert not isinstance(enc, MelStatsSpeakerEncoder)
    wav = voiced_wav(4)
    mel = np.zeros((16, 5), np.float32)
    got = enc.embed(mel, wav=wav, sample_rate=SR)
    want = jax_make(16).embed(mel, wav=wav, sample_rate=SR)
    assert got.shape == (se.MODEL_EMB,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
