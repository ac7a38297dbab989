"""The port's bfloat16 serving path against the JAX package's: the bf16
entries of the slice-1 kernels, duration rounding, and ``generate_fused``,
``generate`` and ``generate_routed`` of one small model with the same
weights, plus the bf16 ``gen_forward`` CLI.

The JAX side runs with FTT_PALLAS_INTERPRET=1, so its Pallas kernels run in
interpret mode on the CPU; the port runs on the CPU, where its kernel
wrappers take the plain twins. The small model is sized so that the JAX
gates send every stage of the path to its kernel: token-GRU sum 256 and the
prenet and postnet GRUs at H=128 (multiples of 128), LSTM input 2 x 128,
postnet channels 128, every sequence under 512 frames.

Tolerances: bf16 kernels, atol 5e-2 at the output's scale (the JAX
package's bf16 trunk tolerance, tests/test_fused_trunk.py); the model, atol
8e-2 on valid frames for dur/pitch/energy/mel/mel_post (the JAX package's
bf16 model tolerance, tests/test_fused_trunk.py), mel_len exactly equal.
"""

import numpy as np
import pytest
import torch
from test_torch_slice import SMALL_DSP, randomize

from forwardtacotron_torch.models.registry import \
    init_tts_model as torch_init_tts_model
from forwardtacotron_torch.models.synthesis import (TTSInference,
                                                    bucket_group_size)
from forwardtacotron_torch.ops.hopper import (cbhg, highway, lr_bidir, rnn)
from forwardtacotron_torch.ops.length_regulator import round_durations
from forwardtacotron_torch.utils.convert import from_jax_variables
from forwardtacotron_torch.utils.files import read_config

BF16 = torch.bfloat16
KERNEL_ATOL, MODEL_ATOL = 5e-2, 8e-2
SERVING_MODEL = dict(embed_dims=128, series_embed_dims=16,
                     durpred_conv_dims=32, durpred_rnn_dims=32,
                     pitch_conv_dims=32, pitch_rnn_dims=64,
                     energy_conv_dims=32, energy_rnn_dims=32, rnn_dims=128,
                     prenet_dims=128, prenet_k=4, prenet_num_highways=2,
                     postnet_dims=128, postnet_k=4, postnet_num_highways=2)


@pytest.fixture()
def interp(monkeypatch):
    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _close_at_scale(got, want, atol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=atol * scale)


@pytest.mark.parametrize('c_in', [80, 256])
def test_pre_highway_bf16_twin_matches_pallas(c_in):
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.highway import \
        pre_highway_stack_pallas

    rs = np.random.RandomState(c_in)
    n, c, layers = 50, 128, 4
    a, res = (rs.randn(n, c_in).astype(np.float32) for _ in range(2))
    pre_w = (rs.randn(c_in, c) / np.sqrt(c_in)).astype(np.float32)
    w1, w2 = [(rs.randn(layers, c, c) / np.sqrt(c)).astype(np.float32)
              for _ in range(2)]
    b1, b2 = [(0.1 * rs.randn(layers, c)).astype(np.float32)
              for _ in range(2)]
    ref = pre_highway_stack_pallas(
        *(jnp.asarray(v, jnp.bfloat16) for v in (a, res, pre_w, w1, b1, w2,
                                                 b2)),
        block_rows=32, interpret=True)
    got = highway.pre_highway_stack(
        _bf16(a), _bf16(res), _bf16(pre_w),
        _bf16(np.concatenate([w1, w2], -1)),
        _bf16(np.concatenate([b1, b2], -1)).float())
    assert got.dtype == BF16
    _close_at_scale(got, ref, KERNEL_ATOL)


def test_cbhg_front_bf16_twin_matches_pallas():
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.cbhg import bank_pool_proj_pallas

    rs = np.random.RandomState(8)
    b, t, c_in, c, p, k_max = 2, 40, 16, 32, 24, 8
    x = rs.randn(b, t, c_in).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 27:] = 0.0
    x[1, 27:] = 0.0
    bank_w = [(rs.randn(k, c_in, c) / np.sqrt(k * c_in)).astype(np.float32)
              for k in range(1, k_max + 1)]
    bn_scale = rs.uniform(0.5, 1.5, (k_max, c)).astype(np.float32)
    bn_bias = (0.1 * rs.randn(k_max, c)).astype(np.float32)
    proj_w = (rs.randn(3, k_max * c, p) / np.sqrt(3 * k_max * c)) \
        .astype(np.float32)
    ps = rs.uniform(0.5, 1.5, p).astype(np.float32)
    pb = (0.1 * rs.randn(p)).astype(np.float32)

    ref = bank_pool_proj_pallas(
        jnp.asarray(x, jnp.bfloat16), mask,
        tuple(jnp.asarray(w, jnp.bfloat16) for w in bank_w), bn_scale,
        bn_bias, jnp.asarray(proj_w, jnp.bfloat16), ps, pb,
        ks=tuple(range(1, k_max + 1)), interpret=True)
    got = cbhg.bank_pool_proj(
        _bf16(x), torch.from_numpy(mask), [_bf16(w) for w in bank_w],
        torch.from_numpy(bn_scale), torch.from_numpy(bn_bias), _bf16(proj_w),
        torch.from_numpy(ps), torch.from_numpy(pb))
    assert got.dtype == BF16
    _close_at_scale(got, ref, KERNEL_ATOL)


def test_duration_rounding_matches_jax():
    """In bf16 both frameworks round d + 0.5 to bf16 before the floor, so
    from 128 frames up half rounds to even (129 -> 130); the port keeps
    that, and float32 rounds half up everywhere."""
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.length_regulator import \
        round_durations as jax_round

    d = np.concatenate([np.arange(-3, 3, 1 / 16),
                        np.arange(0, 300, 0.25)]).astype(np.float32)[None]
    for jdt, tdt in ((jnp.bfloat16, BF16), (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(
            round_durations(torch.from_numpy(d).to(tdt)).numpy(),
            np.asarray(jax_round(jnp.asarray(d, jdt))))
    assert int(round_durations(torch.tensor([129.0], dtype=BF16))) == 130


def test_bucket_group_size_matches_jax():
    from forwardtacotron_tpu.models.synthesis import \
        bucket_group_size as jax_bucket_group_size
    for n, cap in ((1, 8), (3, 8), (5, 8), (9, 8), (17, 64), (64, 64)):
        assert bucket_group_size(n, cap) == jax_bucket_group_size(n, cap)


def serving_config():
    config = read_config('configs/singlespeaker.yaml')
    config['dsp'].update(SMALL_DSP)
    config['forward_tacotron']['model'].update(SERVING_MODEL)
    return config


@pytest.fixture(scope='module')
def models():
    """The JAX model and its variables, the port's float32 model with the
    same weights, and request tokens of three lengths."""
    import jax

    from forwardtacotron_tpu.models.registry import init_tts_model

    config = serving_config()
    jmodel = init_tts_model(config)
    n = 13
    batch = {'x': np.ones((1, n), np.int64),
             'dur': np.ones((1, n), np.float32),
             'mel_len': np.array([n]),
             'pitch': np.zeros((1, n), np.float32),
             'energy': np.zeros((1, n), np.float32),
             'mel': np.zeros((1, n, SMALL_DSP['num_mels']), np.float32)}
    variables = randomize(jmodel.init({'params': jax.random.PRNGKey(0),
                                       'dropout': jax.random.PRNGKey(1)},
                                      batch, train=False), seed=5)
    # durations of 0.8-2.3 frames, none within 0.05 of a .5 rounding point
    # (bf16 rounding between the frameworks must not move a frame count):
    # the three requests expand to 25, 21 and 16 frames
    lin = variables['params']['dur_pred']['lin']
    lin['kernel'] *= 14.0
    lin['bias'][:] = 3.0
    tmodel = torch_init_tts_model(config)
    missing, unexpected = tmodel.load_state_dict(
        from_jax_variables(variables), strict=False)
    assert missing == ['step'] and unexpected == []
    rs = np.random.RandomState(2)
    x = rs.randint(1, 60, (3, n)).astype(np.int64)
    x[1, 9:] = 0              # padded requests expand to other lengths
    x[2, 5:] = 0
    return jmodel, variables, tmodel, x


def _spy(monkeypatch, module, names, calls):
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])


def _jax_serving(jmodel, variables, monkeypatch):
    """The JAX package's bf16 TTSInference, with its serving kernels
    recorded as they are traced."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.models.synthesis import TTSInference as JaxTTS
    from forwardtacotron_tpu.ops.pallas import cbhg as jcbhg
    from forwardtacotron_tpu.ops.pallas import highway as jhighway
    from forwardtacotron_tpu.ops.pallas import rnn as jrnn

    calls = []
    _spy(monkeypatch, jrnn, ['gru_from_xp_pallas_sharded',
                             'lstm_lr_mel_sharded',
                             'bidir_rnn_pallas_sharded'], calls)
    _spy(monkeypatch, jhighway, ['pre_highway_stack_pallas'], calls)
    _spy(monkeypatch, jcbhg, ['bank_pool_proj_pallas'], calls)
    inf = JaxTTS(jmodel, jax.tree.map(jnp.asarray, variables),
                 dtype='bfloat16')
    return inf, calls


def _port_serving(tmodel, monkeypatch):
    import copy
    calls = []
    _spy(monkeypatch, rnn, ['gru_xp_plain', 'gru_plain', 'lstm_mel_plain'],
         calls)
    _spy(monkeypatch, lr_bidir, ['length_regulator_bidir_plain'], calls)
    _spy(monkeypatch, highway, ['pre_highway_stack_plain'], calls)
    _spy(monkeypatch, cbhg, ['bank_pool_proj_plain'], calls)
    inf = TTSInference(copy.deepcopy(tmodel), dtype='bfloat16', device='cpu')
    assert all(p.dtype == BF16 for p in inf.model.parameters())
    return inf, calls


def _compare(got, ref, lengths):
    for key in ('dur', 'pitch', 'energy'):
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(ref[key], np.float32),
                                   rtol=0, atol=MODEL_ATOL, err_msg=key)
    for key in ('mel', 'mel_post'):
        assert got[key].shape == ref[key].shape, key
        g = got[key].float().numpy()
        r = np.asarray(ref[key], np.float32)
        for i, n in enumerate(lengths):
            np.testing.assert_allclose(g[i, :n], r[i, :n], rtol=0,
                                       atol=MODEL_ATOL, err_msg=key)


def test_generate_fused_matches_jax(interp, monkeypatch, models):
    jmodel, variables, tmodel, x = models
    jinf, jcalls = _jax_serving(jmodel, variables, monkeypatch)
    tinf, tcalls = _port_serving(tmodel, monkeypatch)
    max_len = 24                        # item 0 runs over the budget
    ref = jinf.generate_fused(x, max_len=max_len)
    got = tinf.generate_fused(x, max_len=max_len)
    np.testing.assert_array_equal(got['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    lengths = np.minimum(got['mel_len'].numpy(), max_len)
    assert lengths.min() < lengths.max() == max_len
    _compare(got, ref, lengths)
    # every kernel of the serving path, on both sides: one multi-GRU, one
    # LR + LSTM-mel, the postnet GRU, two highway stacks, two fronts (the
    # small prenet front fits the JAX package's one-dispatch budget)
    assert sorted(set(jcalls)) == sorted(
        ['gru_from_xp_pallas_sharded', 'lstm_lr_mel_sharded',
         'bidir_rnn_pallas_sharded', 'pre_highway_stack_pallas',
         'bank_pool_proj_pallas'])
    assert sorted(tcalls) == sorted(
        ['gru_xp_plain', 'length_regulator_bidir_plain', 'lstm_mel_plain',
         'gru_plain', 'pre_highway_stack_plain', 'pre_highway_stack_plain',
         'bank_pool_proj_plain', 'bank_pool_proj_plain'])


def test_generate_and_routed_match_jax(interp, monkeypatch, models):
    jmodel, variables, tmodel, x = models
    jinf, _ = _jax_serving(jmodel, variables, monkeypatch)
    tinf, tcalls = _port_serving(tmodel, monkeypatch)

    ref = jinf.generate(x)
    got = tinf.generate(x)
    np.testing.assert_array_equal(got['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    _compare(got, ref, got['mel_len'].numpy())
    # two-phase: prenet and postnet GRUs take the kernel, the H=32/64
    # predictor GRUs stay per-step loops (as in the JAX package)
    assert tcalls.count('gru_plain') == 2
    assert 'gru_xp_plain' not in tcalls

    ref = jinf.generate_routed(x, frame_bucket=16)
    got = tinf.generate_routed(x, frame_bucket=16)
    np.testing.assert_array_equal(got['mel_len'].numpy(),
                                  np.asarray(ref['mel_len']))
    assert len(set((got['mel_len'].numpy() + 15) // 16)) > 1
    _compare(got, ref, got['mel_len'].numpy())


def test_gen_forward_bf16_batched_cli_writes_wavs(tmp_path):
    from scipy.io import wavfile

    from forwardtacotron_torch import gen_forward

    config = serving_config()
    torch.manual_seed(0)
    model = torch_init_tts_model(config)
    path = tmp_path / 'forward.pt'
    torch.save({'model': model.state_dict(), 'config': config}, str(path))
    text = tmp_path / 'text.txt'
    text.write_text('hello there.\nthe second, longer one!\n',
                    encoding='utf-8')
    out = tmp_path / 'out'
    gen_forward.main(['--checkpoint', str(path), '--text_file', str(text),
                      '--output', str(out), '--device', 'cpu',
                      '--dtype', 'bfloat16', '--batched'])
    wavs = sorted(out.glob('*.wav'))
    assert [w.name for w in wavs] == ['1_forward_0k_alpha1.0.wav',
                                      '2_forward_0k_alpha1.0.wav']
    for w in wavs:
        rate, wav = wavfile.read(str(w))
        assert rate == SMALL_DSP['sample_rate'] and len(wav) > 0
