"""The port's HiFi-GAN vocoding against the JAX package's: the MRF twin
against the Pallas kernel (interpret mode), the generator (per-convolution
and fused paths), the checkpoint loader, ``generate_routed(vocoder=)`` and
the vocoder options of the CLI.

Inputs are made from seeds with numpy; the JAX generator's weights are
carried into the port by ``hifigan_from_jax_params``. Tolerances: float32
atol 2e-5 (rtol 1e-4 for whole generators), as tests/test_mrf.py and
tests/test_vocoder.py hold the JAX package; bfloat16 atol 5e-2 at the
output's scale, the JAX package's bf16 kernel tolerance (both sides round
at the same points, but a float32 sum taken in another order can land on
the neighbouring bf16 value and a residual chain carries it on).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_slice import SMALL_DSP, small_config
from test_vocoder import TorchHiFiGAN
from torch_training_setup import _random_variables

from forwardtacotron_torch.models import vocoder as vocoder_mod
from forwardtacotron_torch.models.registry import \
    init_tts_model as torch_init_tts_model
from forwardtacotron_torch.models.synthesis import TTSInference, Vocoder
from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
from forwardtacotron_torch.ops.hopper import mrf
from forwardtacotron_torch.utils.convert import (from_jax_variables,
                                                 hifigan_from_jax_params)
from forwardtacotron_torch.utils.vocoder_checkpoints import (fold_weight_norm,
                                                             load_hifigan)

REPO = Path(__file__).resolve().parent.parent
KRS, DILS = (3, 7, 11), (1, 3, 5)
F32_ATOL, BF16_ATOL = 2e-5, 5e-2
HIFI_V1_NARROW = dict(upsample_initial_channel=64)
HIFI_V3ISH = dict(resblock='2', upsample_rates=(8, 8, 4),
                  upsample_kernel_sizes=(16, 16, 8),
                  upsample_initial_channel=64,
                  resblock_kernel_sizes=(3, 5, 7),
                  resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


def _close_at_scale(got, want, atol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=atol * scale)


def _mrf_inputs(c, t, seed, krs=KRS, n_units=len(DILS)):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, c, t).astype(np.float32)
    weights = []
    for kr in krs:
        for _ in range(2):
            weights.append((rs.randn(n_units, c, kr * c) / np.sqrt(kr * c))
                           .astype(np.float32))
            weights.append((0.1 * rs.randn(n_units, c, 1))
                           .astype(np.float32))
    return x, weights


def _check_mrf_twin(dtype, c, t, t_tile, krs, dils):
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.mrf import mrf_pallas

    x, weights = _mrf_inputs(c, t, seed=c, krs=krs, n_units=len(dils))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = mrf_pallas(jnp.asarray(x, jdt),
                     tuple(jnp.asarray(w, jdt) for w in weights), krs, dils,
                     t_tile=t_tile, interpret=True)
    got = mrf.mrf_plain(torch.from_numpy(x).to(tdt),
                        tuple(torch.from_numpy(w).to(tdt) for w in weights),
                        krs, dils)
    assert got.dtype == tdt and got.shape == x.shape
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=F32_ATOL)
    else:
        _close_at_scale(got.float().numpy(), np.asarray(ref, np.float32),
                        BF16_ATOL)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('c,t,t_tile', [(32, 300, 1024), (16, 413, 128)])
def test_mrf_twin_matches_pallas(dtype, c, t, t_tile):
    """One tile (C=32), and several tiles with a ragged edge (C=16)."""
    _check_mrf_twin(dtype, c, t, t_tile, KRS, DILS)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_mrf_twin_matches_pallas_even_kr(dtype):
    """Even kernel sizes, which the JAX gate admits and the card's kernel
    takes: the twin's convolution yields d samples more than T at an even
    kr and crops them, which must give the Pallas kernel's taps
    (j - kr // 2) * d. Several tiles with a ragged edge."""
    _check_mrf_twin(dtype, 16, 413, 128, (4, 6), (1, 2))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('krs,dils', [(tuple(range(2, 12)), DILS),
                                      ((3, 5), (1, 2) * 4 + (1,))],
                         ids=['10_kernel_sizes', '9_dilations'])
def test_mrf_twin_matches_pallas_long_lists(dtype, krs, dils):
    """More kernel sizes or dilations than HiFi-GAN's three, within the
    halo, which the JAX gate admits and the card's kernel now takes: 10
    kernel sizes (odd and even), 9 dilations; several tiles with a ragged
    edge."""
    _check_mrf_twin(dtype, 16, 300, 128, krs, dils)


def test_mrf_wrapper_takes_the_twin_on_cpu(monkeypatch):
    x, weights = _mrf_inputs(16, 50, seed=3)
    args = (torch.from_numpy(x), tuple(map(torch.from_numpy, weights)),
            KRS, DILS)
    calls = []
    plain = mrf.mrf_plain
    monkeypatch.setattr(mrf, 'mrf_plain',
                        lambda *a: (calls.append(1), plain(*a))[1])
    before = mrf.launches
    got = mrf.mrf(*args)
    assert calls == [1] and mrf.launches == before
    assert torch.equal(got, plain(*args))


def _jax_generator(cfg, seed, n_mels=80, **kw):
    """The JAX generator with seeded numpy weights on the shapes of its
    init (``eval_shape``: nothing is compiled for the init), and the port's
    generator carrying the same weights."""
    import jax

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    model = JaxHiFiGAN.from_config(dict(cfg, num_mels=n_mels))
    model = model.clone(**kw) if kw else model
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            np.zeros((1, 8, n_mels), np.float32))
    variables = _random_variables(shapes, seed)
    port = HiFiGANGenerator.from_config(dict(cfg, num_mels=n_mels), **kw)
    port.load_state_dict(hifigan_from_jax_params(variables['params']))
    return model, variables, port.eval()


@pytest.mark.parametrize('cfg', [HIFI_V1_NARROW, HIFI_V3ISH],
                         ids=['v1_narrow', 'v3ish'])
def test_hifigan_matches_jax(cfg):
    jmodel, variables, port = _jax_generator(cfg, seed=0)
    mel = np.random.RandomState(1).randn(2, 17, 80).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 17 * port.hop_length)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=1e-4)


FUSED_CFG = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 upsample_initial_channel=64)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_mrf_path_matches_jax(dtype, monkeypatch):
    """fuse_mrf_max_ch=16 on levels of 32 and 16 channels: only level 1
    takes the fused path, on both sides. The JAX side runs mrf_pallas in
    interpret mode (its TPU-backend clause patched, as tests/test_mrf.py
    does); the port's device clause is patched, so its CPU tensors reach
    ``mrf``, which runs the twin. Without the patch the port's CPU path
    stays per-convolution."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN

    jmodel, variables, port = _jax_generator(FUSED_CFG, seed=2, n_mels=8,
                                             fuse_mrf_max_ch=16)
    mel = np.random.RandomState(2).randn(2, 40, 8).astype(np.float32)
    tdt = getattr(torch, dtype)
    port = port.to(tdt)
    if dtype == 'bfloat16':
        jmodel = jmodel.clone(dtype=jnp.bfloat16)
        variables = jax.tree.map(lambda a: a.astype(jnp.bfloat16), variables)

    port_calls = []
    orig = HiFiGANGenerator._mrf_fused
    monkeypatch.setattr(HiFiGANGenerator, '_mrf_fused',
                        lambda self, x, level: (port_calls.append(level),
                                                orig(self, x, level))[1])
    with torch.no_grad():
        plain = port(torch.from_numpy(mel)).float().numpy()
    assert port_calls == []               # CPU tensors: per-convolution

    monkeypatch.setattr(JaxHiFiGAN, '_mrf_fusable',
                        lambda self, ch: not self.is_initializing()
                        and 0 < ch <= self.fuse_mrf_max_ch)
    jax_calls = []
    jorig = JaxHiFiGAN._mrf_fused
    monkeypatch.setattr(JaxHiFiGAN, '_mrf_fused',
                        lambda self, x, level: (jax_calls.append(level),
                                                jorig(self, x, level))[1])
    want = np.asarray(jmodel.apply(variables, mel), np.float32)
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).float().numpy()
    assert jax_calls == port_calls == [1]
    assert got.shape == want.shape == (2, 40 * 16)
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        np.testing.assert_allclose(got, plain, rtol=0, atol=F32_ATOL)
    else:
        _close_at_scale(got, want, BF16_ATOL)


def test_fused_every_level_matches_jax(monkeypatch):
    """fuse_mrf_max_ch=256, which the JAX package accepts: on a card every
    level of a narrow v1 (64 to 8 channels) takes the fused path, on both
    sides (the JAX side in interpret mode, its backend clause patched; the
    port's device clause patched, so its CPU tensors reach ``mrf``, which
    runs the twin). float32, tolerance atol F32_ATOL (2e-5)."""
    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN

    cfg = dict(upsample_initial_channel=128)
    jmodel, variables, port = _jax_generator(cfg, seed=4, n_mels=8,
                                             fuse_mrf_max_ch=256)
    mel = np.random.RandomState(4).randn(2, 9, 8).astype(np.float32)
    monkeypatch.setattr(JaxHiFiGAN, '_mrf_fusable',
                        lambda self, ch: not self.is_initializing()
                        and 0 < ch <= self.fuse_mrf_max_ch)
    port_calls, jax_calls = [], []
    orig = HiFiGANGenerator._mrf_fused
    monkeypatch.setattr(HiFiGANGenerator, '_mrf_fused',
                        lambda self, x, level: (port_calls.append(level),
                                                orig(self, x, level))[1])
    jorig = JaxHiFiGAN._mrf_fused
    monkeypatch.setattr(JaxHiFiGAN, '_mrf_fused',
                        lambda self, x, level: (jax_calls.append(level),
                                                jorig(self, x, level))[1])
    want = np.asarray(jmodel.apply(variables, mel), np.float32)
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert jax_calls == port_calls == [0, 1, 2, 3]
    assert got.shape == want.shape == (2, 9 * port.hop_length)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_fused_levels_keep_their_launch_weights(monkeypatch):
    """The fused path stacks and casts a level's weights once per state of
    the weights, not per call; an in-place write to a parameter (as
    load_state_dict makes) is seen, and the output follows it (f32, against
    the per-convolution path, atol F32_ATOL at the output's scale)."""
    gen = HiFiGANGenerator(num_mels=8, upsample_initial_channel=32,
                           fuse_mrf_max_ch=256).eval()
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    made = []
    orig = HiFiGANGenerator.mrf_weights
    monkeypatch.setattr(HiFiGANGenerator, 'mrf_weights',
                        lambda self, level, *a: (made.append(level),
                                                 orig(self, level, *a))[1])
    mel = torch.from_numpy(np.random.RandomState(8).randn(1, 6, 8)
                           .astype(np.float32))
    with torch.no_grad():
        first = gen(mel)
        assert torch.equal(gen(mel), first) and made == [0, 1, 2, 3]
        gen.resblocks[3].convs1[0].weight.mul_(2.0)    # level 1, kr 3
        got = gen(mel)
        assert made == [0, 1, 2, 3, 1]
        gen.fuse_mrf_max_ch = 0
        want = gen(mel)
    assert not torch.equal(got, first)
    _close_at_scale(got.numpy(), want.numpy(), F32_ATOL)


def test_tails_not_ported_raise():
    """Both tails are ported: the channels-major and the phase-stacked tail
    construct, from the constructor and from a config, and default off as
    in JAX."""
    for name in ('fuse_tail_max_ch', 'fuse_ups_tail_max_ch'):
        assert HiFiGANGenerator(upsample_initial_channel=16,
                                **{name: 0}) is not None
        gen = HiFiGANGenerator(upsample_initial_channel=16, **{name: 32})
        assert getattr(gen, name) == 32
        assert getattr(HiFiGANGenerator.from_config({}, **{name: 64}),
                       name) == 64
        assert getattr(HiFiGANGenerator(), name) == 0


@pytest.mark.parametrize('form', ['weight_norm', 'parametrizations'])
def test_load_hifigan_matches_jax(form, tmp_path):
    """A jik876-format checkpoint (weight-normed, under 'generator') loads
    into both packages with the same result; the fold equals torch's."""
    from forwardtacotron_tpu.utils.vocoder_checkpoints import \
        load_hifigan as jax_load_hifigan

    cfg = dict(upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
               resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
    torch.manual_seed(0)
    oracle = TorchHiFiGAN(**cfg).eval()
    if form == 'parametrizations':
        for m in oracle.modules():
            if hasattr(m, 'weight_g'):
                torch.nn.utils.remove_weight_norm(m)
                torch.nn.utils.parametrizations.weight_norm(m)
    sd = oracle.state_dict()
    assert any(k.endswith('weight_g' if form == 'weight_norm'
                          else 'original0') for k in sd)
    path = tmp_path / 'g_02500000'
    torch.save({'generator': sd}, str(path))

    port = load_hifigan(str(path), config=cfg, device='cpu')
    jmodel, jvars = jax_load_hifigan(str(path), config=cfg)
    mel = np.random.RandomState(4).randn(1, 11, 80).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
        want = oracle(torch.from_numpy(mel.transpose(0, 2, 1)))[:, 0].numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jvars, mel)),
                               atol=F32_ATOL, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=1e-4)

    conv = torch.nn.utils.weight_norm(torch.nn.Conv1d(8, 16, 5))
    folded = fold_weight_norm({f'c.{k}': v.numpy()
                               for k, v in conv.state_dict().items()})
    with torch.no_grad():
        ref = torch.nn.utils.remove_weight_norm(conv).weight.numpy()
    np.testing.assert_allclose(folded['c.weight'], ref, atol=1e-6)


ROUTED_VOCODER = dict(upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
                      upsample_initial_channel=16, resblock_kernel_sizes=[3],
                      resblock_dilation_sizes=[[1, 2]], resblock='2')


def test_generate_routed_with_vocoder_matches_jax():
    """Requests over two frame buckets: 'wav' and 'wav_len' match the JAX
    package's, and each request's wav equals vocoding its own
    bucket-cropped mel."""
    import jax

    from forwardtacotron_tpu.models.registry import init_tts_model
    from forwardtacotron_tpu.models.synthesis import (JittedVocoder,
                                                      TTSInference as JaxTTS)
    config = small_config()
    jmodel = init_tts_model(config)
    n = 9
    batch = {'x': np.ones((1, n), np.int64),
             'dur': np.ones((1, n), np.float32),
             'mel_len': np.array([n]), 'pitch': np.zeros((1, n), np.float32),
             'energy': np.zeros((1, n), np.float32),
             'mel': np.zeros((1, n, SMALL_DSP['num_mels']), np.float32)}
    variables = _random_variables(jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        batch, train=False)), seed=3)
    # every token 2.2 frames, scaled per request to 1.1 / 3.3 / 1.1 (none
    # near a .5 rounding point): 9, 27 and 9 frames, buckets 16 and 32
    lin = variables['params']['dur_pred']['lin']
    lin['kernel'] *= 0.0
    lin['bias'][:] = 2.2
    scale = np.array([[0.5], [1.5], [0.5]], np.float32)
    tmodel = torch_init_tts_model(config)
    tmodel.load_state_dict(from_jax_variables(variables), strict=False)
    x = np.random.RandomState(2).randint(1, 60, (3, n)).astype(np.int64)

    voc_cfg = dict(ROUTED_VOCODER, num_mels=SMALL_DSP['num_mels'])
    jvoc, jvoc_vars, port_voc = _jax_generator(
        voc_cfg, seed=1, n_mels=SMALL_DSP['num_mels'])
    jvocoder = JittedVocoder(jvoc, jvoc_vars, dtype='float32')
    vocoder = Vocoder(port_voc, dtype='float32', device='cpu')
    assert vocoder.hop_length == jvocoder.hop_length == 8

    jinf = JaxTTS(jmodel, jax.tree.map(np.asarray, variables))
    jpredict = jinf._predict
    jinf._predict = lambda v, xq, alpha: dict(
        jpredict(v, xq, alpha), dur=jpredict(v, xq, alpha)['dur'] * scale)
    ref = jinf.generate_routed(x, frame_bucket=16, vocoder=jvocoder)
    tinf = TTSInference(tmodel, device='cpu')
    tpredict = tinf.model.predict_series
    tinf.model.predict_series = lambda xq, alpha: dict(
        tpredict(xq, alpha), dur=tpredict(xq, alpha)['dur']
        * torch.from_numpy(scale))
    out = tinf.generate_routed(x, frame_bucket=16, vocoder=vocoder)
    lens = out['mel_len'].numpy()
    np.testing.assert_array_equal(lens, np.asarray(ref['mel_len']))
    buckets = [-(-max(int(v), 1) // 16) * 16 for v in lens]
    assert len(set(buckets)) > 1, 'requests must span several buckets'
    assert out['wav'].shape == ref['wav'].shape == (3, max(buckets) * 8)
    np.testing.assert_array_equal(out['wav_len'].numpy(), lens * 8)
    np.testing.assert_array_equal(np.asarray(ref['wav_len']), lens * 8)
    wav = out['wav'].numpy()
    for i, (n_i, b_i) in enumerate(zip(lens, buckets)):
        np.testing.assert_allclose(wav[i, :n_i * 8],
                                   np.asarray(ref['wav'])[i, :n_i * 8],
                                   rtol=0, atol=1e-4, err_msg=f'wav[{i}]')
        direct = vocoder(out['mel_post'][i:i + 1, :b_i])[0].numpy()
        np.testing.assert_allclose(wav[i, :b_i * 8], direct, rtol=0,
                                   atol=1e-5, err_msg=f'wav[{i}] direct')


def _write_checkpoints(tmp_path):
    config = small_config()
    torch.manual_seed(0)
    model = torch_init_tts_model(config)
    ckpt = tmp_path / 'forward.pt'
    torch.save({'model': model.state_dict(), 'config': config}, str(ckpt))
    voc_cfg = dict(ROUTED_VOCODER, num_mels=config['dsp']['num_mels'])
    oracle = TorchHiFiGAN(**{k: tuple(tuple(i) if isinstance(i, list) else i
                                      for i in v)
                             if isinstance(v, list) else v
                             for k, v in voc_cfg.items()})
    voc = tmp_path / 'g_tiny'
    torch.save({'generator': oracle.state_dict()}, str(voc))
    voc_json = tmp_path / 'config.json'
    voc_json.write_text(json.dumps(voc_cfg))
    return ckpt, voc, voc_json


def test_gen_forward_cli_hifigan(tmp_path):
    """`python -m forwardtacotron_torch.gen_forward ... hifigan` with a
    generator checkpoint writes wavs (two sentences, routed); without a
    checkpoint it exports .npy mels, as the reference does."""
    from scipy.io import wavfile

    from forwardtacotron_torch import gen_forward

    ckpt, voc, voc_json = _write_checkpoints(tmp_path)
    text = tmp_path / 'text.txt'
    text.write_text('hello there.\nthe second, longer one!\n',
                    encoding='utf-8')
    out = tmp_path / 'wavs'
    proc = subprocess.run(
        [sys.executable, '-m', 'forwardtacotron_torch.gen_forward',
         '--device', 'cpu', '--checkpoint', str(ckpt), '--text_file',
         str(text), '--output', str(out), '--batched',
         '--vocoder_checkpoint', str(voc), '--vocoder_config', str(voc_json),
         'hifigan'], cwd=str(REPO), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    wavs = sorted(out.glob('*.wav'))
    assert [w.name for w in wavs] == ['1_forward_0k_alpha1.0.wav',
                                      '2_forward_0k_alpha1.0.wav']
    for w in wavs:
        rate, wav = wavfile.read(str(w))
        assert rate == SMALL_DSP['sample_rate'] and len(wav) % 8 == 0 \
            and len(wav) > 0
    assert not list(out.glob('*.npy'))

    out1 = tmp_path / 'one'
    gen_forward.main(['--device', 'cpu', '--checkpoint', str(ckpt),
                      '--input_text', 'hello there.', '--output', str(out1),
                      '--vocoder_checkpoint', str(voc), '--vocoder_config',
                      str(voc_json), 'hifigan'])
    rate, one = wavfile.read(str(out1 / '1_forward_0k_alpha1.0.wav'))
    assert rate == SMALL_DSP['sample_rate'] and len(one) % 8 == 0 \
        and len(one) > 0

    exported = tmp_path / 'mels'
    gen_forward.main(['--device', 'cpu', '--checkpoint', str(ckpt),
                      '--input_text', 'hello there.', '--output',
                      str(exported), 'hifigan'])
    mels = sorted(exported.glob('*.npy'))
    assert len(mels) == 1 and not list(exported.glob('*.wav'))
    assert np.load(str(mels[0])).shape == (SMALL_DSP['num_mels'],
                                           len(one) // 8)
    # melgan with a published-format generator checkpoint vocodes too
    from test_torch_melgan import _published, _write
    melgan = tmp_path / 'melgan.pt'
    _write(melgan, _published(mel_channels=SMALL_DSP['num_mels']))
    out2 = tmp_path / 'melgan_wavs'
    gen_forward.main(['--device', 'cpu', '--checkpoint', str(ckpt),
                      '--input_text', 'hello there.', '--output', str(out2),
                      '--vocoder_checkpoint', str(melgan), 'melgan'])
    rate, wav = wavfile.read(str(out2 / '1_forward_0k_alpha1.0.wav'))
    assert rate == SMALL_DSP['sample_rate']
    assert len(wav) == len(one) // 8 * 256
    assert not list(out2.glob('*.mel'))


# ------------------------------------------------- the channels-major tail

@pytest.mark.parametrize('k,s,p', [(16, 8, 4), (4, 2, 1), (8, 4, 2),
                                   (9, 3, 3), (24, 2, 11), (6, 2, 2)])
def test_polyphase_comb_matches_jax(k, s, p):
    """``polyphase_comb`` of the port's upsampler weight (in the JAX
    layout, ``flax_kernel``) equals the JAX package's, exactly."""
    from forwardtacotron_tpu.models.vocoder import \
        polyphase_comb as jax_comb
    torch.manual_seed(k * s)
    up = vocoder_mod.TransposedConv1d(5, 3, k, s, padding=p)
    kernel = up.flax_kernel().detach()
    comb, dmin, dmax = vocoder_mod.polyphase_comb(kernel, k, s, p)
    want, wmin, wmax = jax_comb(kernel.numpy(), k, s, p)
    assert (dmin, dmax) == (wmin, wmax)
    np.testing.assert_array_equal(comb.numpy(), np.asarray(want))


@pytest.mark.parametrize('cfg', [HIFI_V1_NARROW, FUSED_CFG],
                         ids=['v1_narrow', 'two_levels'])
def test_polyphase_switch_matches_jax(cfg, monkeypatch):
    """``POLYPHASE`` on in both packages: the generator against the JAX
    generator, and against its own transposed convolutions (off, the
    default)."""
    from forwardtacotron_tpu.models import vocoder as jax_vocoder
    assert vocoder_mod.POLYPHASE is False and jax_vocoder.POLYPHASE is False
    jmodel, variables, port = _jax_generator(cfg, seed=6, n_mels=8)
    mel = np.random.RandomState(6).randn(2, 11, 8).astype(np.float32)
    with torch.no_grad():
        direct = port(torch.from_numpy(mel)).numpy()
    monkeypatch.setattr(vocoder_mod, 'POLYPHASE', True)
    monkeypatch.setattr(jax_vocoder, 'POLYPHASE', True)
    calls = []
    orig = vocoder_mod.TransposedConv1d._polyphase
    monkeypatch.setattr(vocoder_mod.TransposedConv1d, '_polyphase',
                        lambda self, x: (calls.append(1), orig(self, x))[1])
    want = np.asarray(jmodel.apply(variables, mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert len(calls) == len(port.ups)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=1e-4)
    np.testing.assert_allclose(got, direct, atol=F32_ATOL, rtol=1e-4)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_up_cm_matches_jax(dtype):
    """``_up_cm`` (one polyphase GEMM over shifted copies, phases
    interleaved) against the JAX package's on the same channels-major
    input, and in float32 against the transposed convolution."""
    import jax
    import jax.numpy as jnp
    cfg = dict(upsample_rates=(4, 3, 2), upsample_kernel_sizes=(8, 5, 4),
               upsample_initial_channel=32)
    jmodel, variables, port = _jax_generator(cfg, seed=8, n_mels=8)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    port = port.to(tdt)
    bound = jmodel.bind(jax.tree.map(lambda a: jnp.asarray(a, jdt),
                                     variables))
    rs = np.random.RandomState(8)
    for level, up in enumerate(port.ups):
        x = rs.randn(2, up.in_channels, 13).astype(np.float32)
        want = np.asarray(bound._up_cm(jnp.asarray(x, jdt), level),
                          np.float32)
        with torch.no_grad():
            xt = torch.from_numpy(x).to(tdt)
            got = port._up_cm(xt, level)
            direct = up(xt)
        assert got.shape == direct.shape == want.shape
        if dtype == 'float32':
            np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(got.numpy(), direct.numpy(),
                                       atol=F32_ATOL, rtol=0)
        else:
            _close_at_scale(got.float().numpy(), want, BF16_ATOL)


# (config, fuse_tail_max_ch, frames, the levels of the tail)
CM_TAIL_CFGS = {
    'v1_narrow': (dict(upsample_initial_channel=64), 16, 12, [1, 2, 3]),
    'rate3': (dict(upsample_rates=(4, 3, 2), upsample_kernel_sizes=(8, 5, 4),
                   upsample_initial_channel=32), 8, 9, [1, 2])}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', list(CM_TAIL_CFGS))
def test_channels_major_tail_matches_jax(name, dtype, monkeypatch):
    """``fuse_tail_max_ch``: the port's generator with its device clause
    patched (CPU tensors reach ``mrf``, which runs the twin) against the
    JAX generator under FTT_PALLAS_INTERPRET=1 (``mrf_pallas`` in
    interpret mode): the same levels take the tail, one ``_up_cm`` and one
    ``mrf`` call each; in float32 also against the port's per-convolution
    path."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.vocoder import \
        HiFiGANGenerator as JaxHiFiGAN
    cfg, max_ch, t, levels = CM_TAIL_CFGS[name]
    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')
    jmodel, variables, port = _jax_generator(cfg, seed=9, n_mels=8,
                                             fuse_tail_max_ch=max_ch)
    mel = np.random.RandomState(9).randn(2, t, 8).astype(np.float32)
    port = port.to(getattr(torch, dtype))
    if dtype == 'bfloat16':
        jmodel = jmodel.clone(dtype=jnp.bfloat16)
        variables = jax.tree.map(lambda a: a.astype(jnp.bfloat16), variables)
    with torch.no_grad():
        plain = port(torch.from_numpy(mel)).float().numpy()
    port_up, port_mrf, jax_up, twin = [], [], [], []
    orig_up, orig_mrf = HiFiGANGenerator._up_cm, HiFiGANGenerator._mrf_fused
    monkeypatch.setattr(HiFiGANGenerator, '_up_cm', lambda self, x, level: (
        port_up.append(level), orig_up(self, x, level))[1])
    monkeypatch.setattr(HiFiGANGenerator, '_mrf_fused',
                        lambda self, x, level: (port_mrf.append(level),
                                                orig_mrf(self, x, level))[1])
    orig_twin = mrf.mrf_plain
    monkeypatch.setattr(mrf, 'mrf_plain', lambda *a: (
        twin.append(1), orig_twin(*a))[1])
    jorig = JaxHiFiGAN._up_cm
    monkeypatch.setattr(JaxHiFiGAN, '_up_cm', lambda self, x, level: (
        jax_up.append(level), jorig(self, x, level))[1])
    want = np.asarray(jax.jit(jmodel.apply)(variables, mel), np.float32)
    monkeypatch.setattr(vocoder_mod, '_on_cuda', lambda x: True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).float().numpy()
    assert jax_up == port_up == port_mrf == levels
    assert len(twin) == len(levels)
    assert got.shape == want.shape == (2, t * port.hop_length)
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
    else:
        _close_at_scale(got, want, BF16_ATOL)
