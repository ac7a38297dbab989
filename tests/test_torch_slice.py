"""The PyTorch port's float32 text -> mel -> Griffin-Lim path against the JAX
package on one small model with the same weights.

The JAX side runs with FTT_PALLAS_INTERPRET=1, so its Pallas kernels (CBHG
front, highway stack, fused Griffin-Lim) run in interpret mode on the CPU;
the port runs on the CPU, where its kernel wrappers take the plain twins.
Tolerance (float32, different summation orders): atol 1e-5 / rtol 1e-4 on
the series, atol 1e-4 on mel / mel_post, atol 1e-4 / rtol 1e-3 on the
waveform after 4 Griffin-Lim iterations.
"""

import numpy as np
import pytest
import torch
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.dsp.dsp import DSP as TorchDSP
from forwardtacotron_torch.models.registry import \
    init_tts_model as torch_init_tts_model
from forwardtacotron_torch.models.synthesis import TTSInference
from forwardtacotron_torch.utils.convert import from_jax_variables
from forwardtacotron_torch.utils.files import read_config

SMALL_DSP = dict(num_mels=16, sample_rate=8000, n_fft=64, hop_length=16,
                 win_length=64, fmin=0, fmax=4000)
# postnet_dims 128 so the highway-stack route (channels % 128 == 0) runs
SMALL_MODEL = dict(embed_dims=32, series_embed_dims=16, durpred_conv_dims=32,
                   durpred_rnn_dims=16, pitch_conv_dims=32, pitch_rnn_dims=16,
                   energy_conv_dims=32, energy_rnn_dims=16, rnn_dims=32,
                   prenet_dims=32, prenet_k=4, prenet_num_highways=2,
                   postnet_dims=128, postnet_k=4, postnet_num_highways=2)


def small_config():
    config = read_config('configs/singlespeaker.yaml')
    config['dsp'].update(SMALL_DSP)
    config['forward_tacotron']['model'].update(SMALL_MODEL)
    return config


def randomize(variables, seed):
    """Numpy copy of a flax variable tree with random BatchNorm affine and
    running statistics (init leaves them at 1/0, which hides mistakes)."""
    rs = np.random.RandomState(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, 'items'):
                out[k] = walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32).copy()
            if 'bnorm' in path:
                if k in ('scale', 'var'):
                    a = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
                else:
                    a = (0.1 * rs.randn(*a.shape)).astype(np.float32)
            out[k] = a
        return out
    return {col: walk(tree, ()) for col, tree in variables.items()}


@pytest.fixture()
def interp(monkeypatch):
    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')


def test_generate_and_griffinlim_match_jax(interp):
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.dsp.dsp import DSP as JaxDSP
    from forwardtacotron_tpu.models.registry import init_tts_model
    from forwardtacotron_tpu.models.synthesis import TTSInference as JaxTTS

    config = small_config()
    jmodel = init_tts_model(config)
    n = 9
    batch = {'x': np.ones((1, n), np.int64),
             'dur': np.ones((1, n), np.float32),
             'mel_len': np.array([n]),
             'pitch': np.zeros((1, n), np.float32),
             'energy': np.zeros((1, n), np.float32),
             'mel': np.zeros((1, n, SMALL_DSP['num_mels']), np.float32)}
    variables = randomize(jmodel.init({'params': jax.random.PRNGKey(0),
                                       'dropout': jax.random.PRNGKey(1)},
                                      batch, train=False), seed=3)
    # ~3 frames per token, so every CBHG and RNN sees a real sequence
    variables['params']['dur_pred']['lin']['bias'][:] = 3.0

    tmodel = torch_init_tts_model(config)
    missing, unexpected = tmodel.load_state_dict(
        from_jax_variables(variables), strict=False)
    assert missing == ['step'] and unexpected == []

    x = np.array([[5, 17, 33, 2, 48, 12, 9, 60, 21, 7, 30, 3, 44]], np.int64)
    ref = JaxTTS(jmodel, jax.tree.map(jnp.asarray, variables),
                 dtype='float32').generate(x)
    got = TTSInference(tmodel, device='cpu').generate(x)

    assert int(got['mel_len'][0]) == int(ref['mel_len'][0]) > 30
    for key in ('dur', 'pitch', 'energy'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, rtol=1e-4, err_msg=key)
    for key in ('mel', 'mel_post'):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=0, err_msg=key)

    # Griffin-Lim on the same mel with the JAX package's phase draw
    length = int(ref['mel_len'][0])
    mel = np.asarray(ref['mel_post'])[0, :length].T
    jdsp = JaxDSP.from_config(config)
    assert jdsp._gl_fused_usable(length)
    wav_ref = jdsp.griffinlim(mel, n_iter=4, seed=0)
    bins = SMALL_DSP['n_fft'] // 2 + 1
    phase = np.asarray(2.0 * jnp.pi * jax.random.uniform(
        jax.random.PRNGKey(0), (bins, length)))
    wav = TorchDSP.from_config(config, device='cpu').griffinlim(
        mel, n_iter=4, phase=phase)
    assert wav.shape == wav_ref.shape
    np.testing.assert_allclose(wav, wav_ref, atol=1e-4, rtol=1e-3)


def test_griffinlim_non_dividing_hop_matches_jax():
    """A hop that does not divide n_fft (2048/275, the reference config's):
    ``DSP.griffinlim`` takes the rfft form (plain torch, no kernel), as the
    JAX package's does, and matches it with the JAX phase draw injected.
    Tolerance atol 1e-4 of the waveform's scale, rtol 1e-3: float32 FFTs of
    2048 points in another library, through 4 momentum iterations."""
    import jax

    from forwardtacotron_tpu.dsp.dsp import DSP as JaxDSP
    from forwardtacotron_tpu.ops import stft as jstft

    from forwardtacotron_torch.ops import stft as tstft

    cfg = dict(num_mels=80, sample_rate=22050, n_fft=2048, hop_length=275,
               win_length=1100, fmin=40, fmax=11025)
    rs = np.random.RandomState(7)
    mel = np.log(np.abs(rs.randn(80, 24)).astype(np.float32) + 1e-2)
    jdsp = JaxDSP(**cfg)
    wav_ref = jdsp.griffinlim(mel, n_iter=4, seed=3)
    phase = np.asarray(2.0 * np.pi * jax.random.uniform(
        jax.random.PRNGKey(3), (1025, 24)))
    wav = TorchDSP(**cfg, device='cpu').griffinlim(mel, n_iter=4,
                                                    phase=phase)
    assert wav.shape == wav_ref.shape == (23 * 275,)
    scale = float(np.abs(wav_ref).max())
    np.testing.assert_allclose(wav, wav_ref, atol=1e-4 * scale, rtol=1e-3)
    # the transforms alone: framing, STFT and ISTFT against the JAX rfft form
    y = rs.randn(3000).astype(np.float32)
    spec = tstft.stft(torch.from_numpy(y), 2048, 275, 1100)
    jspec = np.asarray(jstft.stft(y, 2048, 275, 1100))
    np.testing.assert_allclose(spec.numpy(), jspec, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(
        tstft.istft(spec, 2048, 275, 1100).numpy(),
        np.asarray(jstft.istft(jspec, 2048, 275, 1100)), atol=1e-5)


def test_griffinlim_seeded_phase_is_deterministic():
    """Without an injected phase the draw comes from a seeded
    torch.Generator: the same seed gives the same waveform, another seed
    another one (the JAX draw is not reproducible in PyTorch)."""
    dsp = TorchDSP(**SMALL_DSP, device='cpu')
    mel = np.log(np.abs(np.random.RandomState(0).randn(16, 20))
                 .astype(np.float32) + 1e-3)
    a = dsp.griffinlim(mel, n_iter=2, seed=1)
    b = dsp.griffinlim(mel, n_iter=2, seed=1)
    c = dsp.griffinlim(mel, n_iter=2, seed=2)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert torch.isfinite(torch.from_numpy(a)).all()


def test_gen_forward_cli_writes_wavs(tmp_path):
    """A reference-format .pt (state_dict + config) loads with
    load_state_dict and the CLI writes one wav per sentence (CPU)."""
    from scipy.io import wavfile

    from forwardtacotron_torch import gen_forward
    from forwardtacotron_torch.utils.checkpoints import \
        init_tts_model_from_checkpoint

    config = small_config()
    torch.manual_seed(0)
    model = torch_init_tts_model(config)
    with torch.no_grad():
        model.step.fill_(12000)
    path = tmp_path / 'forward_step12k.pt'
    torch.save({'model': model.state_dict(), 'config': config}, str(path))

    loaded, checkpoint = init_tts_model_from_checkpoint(path)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    text = tmp_path / 'text.txt'
    text.write_text('hello there.\nthe second one!\n', encoding='utf-8')
    out = tmp_path / 'out'
    gen_forward.main(['--checkpoint', str(path), '--text_file', str(text),
                      '--output', str(out), '--device', 'cpu'])
    wavs = sorted(out.glob('*.wav'))
    assert [w.name for w in wavs] == ['1_forward_12k_alpha1.0.wav',
                                      '2_forward_12k_alpha1.0.wav']
    rate, wav = wavfile.read(str(wavs[0]))
    assert rate == SMALL_DSP['sample_rate'] and len(wav) > 0
