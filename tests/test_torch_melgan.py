"""The port's MelGAN against the JAX package's and seungwonpark/melgan's
generator (tests/test_vocoder.py's ``TorchMelGAN``): the residual stack,
the generator and ``inference`` (10 frames of -11.5129 added, their
samples cropped), ``load_melgan`` on a seeded checkpoint in the published
format (weight-normed, ``Sequential`` indices, under 'model_g') against the
JAX ``load_melgan``, ``Vocoder`` in float32 and bfloat16 against the JAX
``JittedVocoder``, and ``gen_forward melgan --vocoder_checkpoint`` on the
CPU.

Tolerances: float32 atol 2e-5, rtol 1e-4 (tests/test_vocoder.py's); bf16
atol 5e-2 at the output's scale (the JAX package's bf16 tolerance). MelGAN
runs no Pallas kernel in JAX and no hand-written kernel in the port.
"""

import numpy as np
import pytest
import torch
from test_torch_slice import SMALL_DSP
from test_vocoder import TorchMelGAN, TorchMelGANResStack
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.models import vocoder as vocoder_mod
from forwardtacotron_torch.models.synthesis import Vocoder
from forwardtacotron_torch.models.vocoder import (MelGANGenerator,
                                                  MelGANResStack)
from forwardtacotron_torch.utils.vocoder_checkpoints import (
    convert_melgan_state_dict, fold_weight_norm, load_melgan)

F32_ATOL, F32_RTOL, BF16_ATOL = 2e-5, 1e-4, 5e-2


def _close_at_scale(got, want, atol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=atol * scale)


def _published(mel_channels=80, seed=0):
    """seungwonpark/melgan's generator with weight-normed convs, seeded."""
    torch.manual_seed(seed)
    return TorchMelGAN(mel_channels).eval()


def _write(path, oracle):
    torch.save({'model_g': oracle.state_dict(), 'epoch': 6400}, str(path))


def test_res_stack_matches_published():
    """The residual stack against seungwonpark's (reflection padding, leaky
    0.2, 1x1 shortcuts), its weights folded and renamed."""
    torch.manual_seed(3)
    oracle = TorchMelGANResStack(16).eval()
    sd = fold_weight_norm({k: v.numpy() for k, v in
                           oracle.state_dict().items()})
    names = {f'blocks.{u}.{i}': f'{n}.{u}' for u in range(3)
             for i, n in ((2, 'blocks_conv1'), (4, 'blocks_conv2'))}
    names.update({f'shortcuts.{u}': f'shortcuts.{u}' for u in range(3)})
    stack = MelGANResStack(16).eval()
    stack.load_state_dict({
        f'{names[k.rsplit(".", 1)[0]]}.{k.rsplit(".", 1)[1]}':
            torch.from_numpy(v) for k, v in sd.items()})
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 16, 30)
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(stack(x).numpy(), oracle(x).numpy(),
                                   atol=F32_ATOL, rtol=F32_RTOL)


@pytest.fixture(scope='module')
def published(tmp_path_factory):
    """A seeded full-width checkpoint in the published format, and the JAX
    package's generator and variables loaded from it."""
    from forwardtacotron_tpu.utils.vocoder_checkpoints import \
        load_melgan as jax_load_melgan
    path = tmp_path_factory.mktemp('melgan') / 'nvidia_tacotron2_LJ11.pt'
    oracle = _published()
    _write(path, oracle)
    jmodel, variables = jax_load_melgan(str(path))
    return path, oracle, jmodel, variables


def test_load_melgan_matches_jax_and_published(published):
    """``load_melgan`` on the published format: the folded, renamed
    weights give the JAX package's and seungwonpark's outputs; the
    generator, ``inference`` (tail pad and crop) and the widths read from
    the checkpoint."""
    from forwardtacotron_tpu.models.vocoder import \
        MelGANGenerator as JaxMelGAN
    path, oracle, jmodel, variables = published
    gen = load_melgan(str(path), device='cpu')
    assert isinstance(gen, MelGANGenerator) and not gen.training
    assert (gen.mel_channels, gen.base_channels, gen.hop_length) == \
        (80, 512, 256)
    mel = np.random.RandomState(5).randn(2, 7, 80).astype(np.float32)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
        got_inf = gen.inference(torch.from_numpy(mel)).numpy()
        want_pub = oracle.generator(
            torch.from_numpy(mel.transpose(0, 2, 1)))[:, 0].numpy()
    want = np.asarray(jmodel.apply(variables, mel))
    want_inf = np.asarray(jmodel.apply(variables, mel,
                                       method=JaxMelGAN.inference))
    assert got.shape == want.shape == (2, 7 * 256)
    assert got_inf.shape == want_inf.shape == (2, 7 * 256)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    np.testing.assert_allclose(got, want_pub, atol=F32_ATOL, rtol=F32_RTOL)
    np.testing.assert_allclose(got_inf, want_inf, atol=F32_ATOL,
                               rtol=F32_RTOL)
    assert not np.allclose(got_inf, got)     # the tail pad reaches back
    sd = convert_melgan_state_dict({k: v.numpy() for k, v in
                                    oracle.state_dict().items()})
    assert set(sd) == set(gen.state_dict())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_vocoder_melgan_matches_jitted_vocoder(published, dtype):
    """``Vocoder.from_checkpoint(vocoder_type='melgan')`` runs the plain
    forward in ``dtype`` (bf16 weights and activations), as the JAX
    ``JittedVocoder`` does."""
    from forwardtacotron_tpu.models.synthesis import JittedVocoder
    path = published[0]
    voc = Vocoder.from_checkpoint(str(path), vocoder_type='melgan',
                                  dtype=dtype, device='cpu')
    jvoc = JittedVocoder.from_checkpoint(str(path), vocoder_type='melgan',
                                         dtype=dtype)
    assert voc.hop_length == jvoc.hop_length == 256
    assert voc.model.conv_pre.weight.dtype == getattr(torch, dtype)
    mel = np.random.RandomState(6).randn(2, 6, 80).astype(np.float32)
    got = voc(mel).float().numpy()
    want = np.asarray(jvoc(mel), np.float32)
    assert got.shape == want.shape == (2, 6 * 256)
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    else:
        _close_at_scale(got, want, BF16_ATOL)


def test_melgan_polyphase_matches_direct(monkeypatch):
    """The JAX package's POLYPHASE switch on MelGAN's upsamplers (k = 2s,
    p = s/2): the same outputs as the transposed convolutions."""
    torch.manual_seed(7)
    gen = MelGANGenerator(mel_channels=8, base_channels=64).eval()
    mel = torch.randn(2, 5, 8)
    with torch.no_grad():
        want = gen(mel)
        monkeypatch.setattr(vocoder_mod, 'POLYPHASE', True)
        got = gen(mel)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL,
                               rtol=F32_RTOL)


def test_gen_forward_melgan_writes_wavs(tmp_path):
    """``gen_forward melgan --vocoder_checkpoint`` on the CPU, with a
    FastPitch checkpoint: one .wav per sentence, 256 samples a frame,
    equal to the MelGAN forward of the exported mel."""
    from scipy.io import wavfile
    from test_torch_fast_pitch import narrow_config

    from forwardtacotron_torch import gen_forward
    from forwardtacotron_torch.models.registry import init_tts_model
    config = narrow_config()
    config['dsp'].update(SMALL_DSP)
    torch.manual_seed(8)
    model = init_tts_model(config)
    with torch.no_grad():
        model.dur_pred.lin.weight.zero_()
        model.dur_pred.lin.bias.fill_(2.0)
    ckpt = tmp_path / 'fp.pt'
    torch.save({'model': model.state_dict(), 'config': config}, str(ckpt))
    voc = tmp_path / 'melgan.pt'
    _write(voc, _published(mel_channels=SMALL_DSP['num_mels'], seed=9))
    text = tmp_path / 'text.txt'
    text.write_text('hello there.\nthe second one!\n', encoding='utf-8')
    out = tmp_path / 'out'
    gen_forward.main(['--device', 'cpu', '--checkpoint', str(ckpt),
                      '--text_file', str(text), '--output', str(out),
                      '--vocoder_checkpoint', str(voc), 'melgan'])
    wavs = sorted(out.glob('*.wav'))
    assert [w.name for w in wavs] == ['1_forward_0k_alpha1.0.wav',
                                      '2_forward_0k_alpha1.0.wav']
    assert not list(out.glob('*.mel'))
    mels = tmp_path / 'mels'
    gen_forward.main(['--device', 'cpu', '--checkpoint', str(ckpt),
                      '--text_file', str(text), '--output', str(mels),
                      'melgan'])
    gen = load_melgan(str(voc), device='cpu')
    for w, m in zip(wavs, sorted(mels.glob('*.mel'))):
        rate, wav = wavfile.read(str(w))
        mel = torch.load(str(m))                  # [1, n_mels, T]
        assert rate == SMALL_DSP['sample_rate']
        assert len(wav) == mel.shape[-1] * 256
        with torch.no_grad():
            want = gen(mel.transpose(1, 2))[0].numpy()
        # the wav is written as 16-bit PCM
        np.testing.assert_allclose(
            wav, (np.clip(want, -1.0, 1.0) * 32767).astype(np.int16),
            atol=1, rtol=0)

