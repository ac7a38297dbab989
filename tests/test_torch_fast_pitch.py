"""The port's FastPitch and its transformer layers against the JAX
package's, with the same weights carried across by ``from_jax_variables``:
each layer (the blockwise attention forced by a low FTT_ATTN_BLOCK_T, a row
whose keys are all padding, one narrow case above 2048 frames), the model's
methods, ``TTSInference``'s four entry points in float32 and bfloat16, the
reference state_dict schema, both directions of the weight bridge, and
``gen_forward`` on a FastPitch checkpoint.

FastPitch has no Pallas kernel of its own: the JAX side runs its plain
layers on the CPU, the port its modules and the ``lr`` twin. Tolerances:
float32 atol 1e-5 at the output's scale (attention and layer norms sum in
other orders); bfloat16 the JAX package's bf16 model tolerance, 8e-2 at
the output's scale on valid frames (tests/test_fused_trunk.py). In bfloat16
both packages compute the transformers in float32 with bfloat16 weights:
the float32 positional table promotes the activations.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from forwardtacotron_torch.models import layers as L
from forwardtacotron_torch.models.fast_pitch import FastPitch
from forwardtacotron_torch.models.registry import init_tts_model
from forwardtacotron_torch.models.synthesis import TTSInference
from forwardtacotron_torch.ops.hopper import lr
from forwardtacotron_torch.utils.convert import (from_jax_variables,
                                                 to_jax_variables)
from forwardtacotron_torch.utils.files import read_config

from torch_training_setup import no_tensorboard  # noqa: F401 (a fixture)

SCHEMA = Path('tests/resources/reference_state_dict_schema.json')
F32_ATOL, BF16_ATOL = 1e-5, 8e-2
N_MELS = 16
NARROW = dict(durpred_d_model=16, durpred_n_heads=2, durpred_layers=1,
              durpred_d_fft=16, durpred_dropout=0.0,
              pitch_d_model=16, pitch_n_heads=2, pitch_layers=1,
              pitch_d_fft=16, pitch_dropout=0.0,
              energy_d_model=16, energy_n_heads=2, energy_layers=1,
              energy_d_fft=16, energy_dropout=0.0,
              d_model=32, conv1_kernel=9, conv2_kernel=1,
              prenet_layers=2, prenet_heads=2, prenet_fft=48,
              prenet_dropout=0.0, postnet_layers=2, postnet_heads=2,
              postnet_fft=48, postnet_dropout=0.0)


def _close(got, want, atol, mask=None):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)


def _random_params(shapes, seed, weight_scale):
    """Numpy params on a flax tree of shapes: weights and embeddings
    normal at ``weight_scale``, norm gains and positional scales in
    [0.5, 1.5] and biases at 0.1 (init leaves them at 1 and 0, which hides
    mistakes in carrying them across)."""
    rs = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if hasattr(v, 'items'):
                out[k] = walk(v)
                continue
            if k == 'scale':
                a = rs.uniform(0.5, 1.5, v.shape)
            elif k == 'bias':
                a = 0.1 * rs.randn(*v.shape)
            else:
                a = weight_scale * rs.randn(*v.shape)
            out[k] = a.astype(np.float32)
        return out
    return walk(shapes)


def _load(module, params):
    missing, unexpected = module.load_state_dict(
        from_jax_variables({'params': params}), strict=False)
    assert unexpected == []
    assert all(k == 'step' or k.endswith('pos_encoder.pe') for k in missing)
    return module.eval()


# ------------------------------------------------------------------ layers

def test_sinusoidal_table_and_positional_encoding_match_jax():
    """The table at the call's length, past the reference's 5000 frames;
    the ``pe`` buffer is the table's first 5000 rows."""
    from forwardtacotron_tpu.models import layers as JL
    np.testing.assert_array_equal(L.sinusoidal_table(300, 12),
                                  JL.sinusoidal_table(300, 12))
    pe = L.PositionalEncoding(8, dropout=0.0)
    np.testing.assert_array_equal(pe.pe[:, 0].numpy(),
                                  JL.sinusoidal_table(5000, 8))
    x = np.random.RandomState(0).randn(2, 5100, 8).astype(np.float32)
    jpe = JL.PositionalEncoding(8, dropout=0.0)
    want = jpe.apply({'params': {'scale': np.array([0.7], np.float32)}}, x)
    with torch.no_grad():
        pe.scale.fill_(0.7)
        got = pe(torch.from_numpy(x))
    _close(got, want, F32_ATOL)


def _attention_inputs(t, seed=0, b=3, h=2, d=16):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, t), bool)
    mask[0, t // 2:] = True
    mask[2, :] = True                 # every key padding: zeros
    return q, k, v, mask


@pytest.mark.parametrize('t,block', [(300, 64), (130, 128)])
def test_blockwise_attention_matches_jax_and_full(t, block):
    from forwardtacotron_tpu.models import layers as JL
    q, k, v, mask = _attention_inputs(t)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    for m, tmask in ((mask, tm), (None, None)):
        want = JL.blockwise_attention(q, k, v, m, block_q=block,
                                      block_k=block)
        got = L.blockwise_attention(tq, tk, tv, tmask, block_q=block,
                                    block_k=block)
        _close(got, want, 2e-5)
        _close(got, L.full_attention(tq, tk, tv, tmask), 2e-5)
    got = L.blockwise_attention(tq, tk, tv, tm, block_q=block, block_k=block)
    assert torch.count_nonzero(got[2]) == 0
    assert torch.count_nonzero(L.full_attention(tq, tk, tv, tm)[2]) == 0


def _mha_pair(t, d=32, heads=2, seed=1):
    import jax

    from forwardtacotron_tpu.models import layers as JL
    jmha = JL.MultiHeadAttention(d_model=d, n_heads=heads)
    x = np.random.RandomState(seed).randn(3, t, d).astype(np.float32)
    params = _random_params(jax.eval_shape(
        lambda: jmha.init(jax.random.PRNGKey(0), x[:, :4]))['params'], seed,
        1 / np.sqrt(d))
    mask = np.zeros((3, t), bool)
    mask[0, t - t // 3:] = True
    mask[2, :] = True
    return jmha, params, _load(L.MultiHeadAttention(d, heads), params), x, \
        mask


def test_multi_head_attention_matches_jax(monkeypatch):
    """The full path, then the blockwise path forced by a low threshold in
    both packages (the port's taken, checked with a spy), with a ragged and
    an all-padding item."""
    jmha, params, mha, x, mask = _mha_pair(96)
    want = jmha.apply({'params': params}, x, mask)
    with torch.no_grad():
        got = mha(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, want, F32_ATOL)
    monkeypatch.setenv('FTT_ATTN_BLOCK_T', '64')
    calls = []
    orig = L.blockwise_attention
    monkeypatch.setattr(L, 'blockwise_attention',
                        lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    want_blk = jmha.apply({'params': params}, x, mask)
    with torch.no_grad():
        got_blk = mha(torch.from_numpy(x), torch.from_numpy(mask))
    assert calls
    _close(got_blk, want_blk, F32_ATOL)
    _close(got_blk, got.numpy(), 2e-5)
    # training keeps the full path at any length
    calls.clear()
    mha.train()
    mha(torch.from_numpy(x), torch.from_numpy(mask))
    assert calls == []


def test_multi_head_attention_above_2048_frames_matches_jax(monkeypatch):
    """A narrow case past the default threshold: both packages take the
    blockwise schedule, and the port's never holds a [B, H, T, T]
    tensor."""
    monkeypatch.delenv('FTT_ATTN_BLOCK_T', raising=False)
    assert L.attn_blockwise_threshold() == 2048
    jmha, params, mha, x, mask = _mha_pair(2100, d=8)
    x, mask = x[:2], mask[:2]
    want = jmha.apply({'params': params}, x, mask)
    seen = []
    orig = torch.matmul
    monkeypatch.setattr(torch, 'matmul', lambda a, b: (
        seen.append(tuple(a.shape[:-1]) + (b.shape[-1],)), orig(a, b))[1])
    with torch.no_grad():
        got = mha(torch.from_numpy(x), torch.from_numpy(mask))
    assert seen and max(s[-1] * s[-2] for s in seen) <= 512 * 512
    _close(got, want, F32_ATOL)


@pytest.mark.parametrize('kernels', [(9, 1), (4, 2)], ids=['9_1', 'even'])
def test_fft_block_and_transformer_match_jax(kernels):
    """FFTBlock with and without ``conv_zero_mask`` (also with even kernels,
    whose T + 1 outputs are cropped) and the whole ForwardTransformer."""
    import jax

    from forwardtacotron_tpu.models import layers as JL
    d, t = 32, 40
    rs = np.random.RandomState(3)
    x = rs.randn(2, t, d).astype(np.float32)
    key_mask = np.arange(t)[None, :] >= np.array([[t], [29]])
    zero = np.arange(t)[None, :] >= np.array([[35], [29]])
    jblock = JL.FFTBlock(d, 2, 48, *kernels, dropout=0.0)
    params = _random_params(jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), x, key_mask))['params'], 4, 0.15)
    block = _load(L.FFTBlock(d, 2, 48, *kernels, dropout=0.0), params)
    for cz in (None, zero):
        want = jblock.apply({'params': params}, x, key_mask, False, cz)
        with torch.no_grad():
            got = block(torch.from_numpy(x), torch.from_numpy(key_mask),
                        None if cz is None else torch.from_numpy(cz))
        _close(got, want, F32_ATOL)
    jtr = JL.ForwardTransformer(d, 48, 2, 2, *kernels, dropout=0.0)
    params = _random_params(jax.eval_shape(lambda: jtr.init(
        jax.random.PRNGKey(0), x, key_mask))['params'], 5, 0.15)
    tr = _load(L.ForwardTransformer(d, 48, 2, 2, *kernels, dropout=0.0),
               params)
    want = jtr.apply({'params': params}, x, key_mask, False, zero)
    with torch.no_grad():
        got = tr(torch.from_numpy(x), torch.from_numpy(key_mask),
                 torch.from_numpy(zero))
    _close(got, want, F32_ATOL)
    toks = torch.tensor([[3, 4, 0], [0, 1, 2]])
    assert L.make_token_pad_mask(toks).tolist() == [[False, False, True],
                                                    [True, False, False]]


# ------------------------------------------------------------------- model

def narrow_config():
    config = read_config('configs/singlespeaker.yaml')
    config['tts_model'] = 'fast_pitch'
    config['dsp']['num_mels'] = N_MELS
    config['fast_pitch']['model'].update(NARROW)
    return config


def _jax_variables(jmodel, seed):
    import jax
    n = 6
    batch = {'x': np.ones((1, n), np.int64),
             'dur': np.ones((1, n), np.float32), 'mel_len': np.array([n]),
             'pitch': np.zeros((1, n), np.float32),
             'energy': np.zeros((1, n), np.float32),
             'mel': np.zeros((1, n, N_MELS), np.float32)}
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        batch, train=False))['params']
    params = _random_params(shapes, seed, 0.15)
    # durations of 0-3.5 frames a token that depend on the token (the
    # three requests expand to 18, 16 and 24 frames), none within 0.04 of
    # a .5 rounding point
    params['dur_pred']['embedding']['embedding'] *= 8.0
    lin = params['dur_pred']['lin']
    lin['kernel'] *= 4.0
    lin['bias'][:] = 2.2
    return params


@pytest.fixture(scope='module')
def models():
    """The JAX FastPitch and its params, the port's float32 model with the
    same weights, and three requests of other lengths."""
    from forwardtacotron_tpu.models.registry import \
        init_tts_model as jax_init_tts_model
    config = narrow_config()
    jmodel = jax_init_tts_model(config)
    params = _jax_variables(jmodel, 7)
    tmodel = _load(init_tts_model(config), params)
    rs = np.random.RandomState(8)
    x = rs.randint(1, 60, (3, 12)).astype(np.int64)
    x[1, 9:] = 0
    x[2, 5:] = 0
    return jmodel, params, tmodel, x


def test_forward_teacher_forced_matches_jax(models):
    """``forward(batch)`` (the JAX ``__call__``, eval): series heads with
    the token padding mask, the postnet over the batch's longest mel_len,
    ``padding_value`` past it."""
    jmodel, params, tmodel, x = models
    rs = np.random.RandomState(9)
    dur = np.where(x > 0, rs.randint(1, 4, x.shape), 0).astype(np.float32)
    mel_len = dur.sum(1).astype(np.int64)
    batch = {'x': x, 'dur': dur, 'mel_len': mel_len,
             'pitch': rs.randn(*x.shape).astype(np.float32),
             'energy': rs.rand(*x.shape).astype(np.float32),
             'mel': np.zeros((3, int(mel_len.max()) + 5, N_MELS),
                             np.float32)}
    want = jmodel.apply({'params': params}, batch, train=False)
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got['mel'] is got['mel_post']
    for key in ('mel', 'dur', 'pitch', 'energy'):
        _close(got[key], want[key], F32_ATOL)
    assert (got['mel'][:, int(mel_len.max()):] == -11.5129).all()


def test_predict_series_and_generate_match_jax(models):
    """``predict_series`` without a padding mask, then ``generate`` at a
    padded budget: frames past each item's expanded length are zero."""
    from forwardtacotron_tpu.models.fast_pitch import FastPitch as JFP
    jmodel, params, tmodel, x = models
    want = jmodel.apply({'params': params}, x, method=JFP.predict_series)
    with torch.no_grad():
        got = tmodel.predict_series(torch.from_numpy(x))
    for key in ('dur', 'pitch', 'energy'):
        _close(got[key], want[key], F32_ATOL)
    dur, pitch, energy = (np.asarray(want[k]) for k in ('dur', 'pitch',
                                                        'energy'))
    budget = 48
    want = jmodel.apply({'params': params}, x, dur, pitch, energy, budget,
                        method=JFP.generate)
    lr.launches = 0
    with torch.no_grad():
        got = tmodel.generate(*map(torch.from_numpy, (x, dur, pitch, energy)),
                              budget)
    assert lr.launches == 0        # the CPU runs the lr twin
    assert got['mel'] is got['mel_post']
    _close(got['mel'], want['mel'], F32_ATOL)
    lens = np.floor(np.clip(dur, 0, None) + 0.5).sum(1).astype(int)
    assert 0 < lens.min() and lens.max() < budget
    for i, n in enumerate(lens):
        assert torch.count_nonzero(got['mel'][i, n:]) == 0


def test_predict_series_fallback_is_batch_wide(models, monkeypatch):
    """The 2-frame fallback fires where the truncated durations of the
    whole batch sum to <= 0, as in JAX (a head of -40 frames fires it, one
    of 0.6 too: every duration truncates to 0, one of 2.2 does not); an
    item whose own durations truncate to 0 keeps them when another item's
    do not."""
    from forwardtacotron_tpu.models.fast_pitch import FastPitch as JFP
    jmodel, params, _, x = models
    for bias, fires in ((-40.0, True), (0.6, True), (2.2, False)):
        lin = {'kernel': np.zeros_like(params['dur_pred']['lin']['kernel']),
               'bias': np.full((1,), bias, np.float32)}
        p = {**params, 'dur_pred': {**params['dur_pred'], 'lin': lin}}
        tmodel = _load(init_tts_model(narrow_config()), p)
        want = jmodel.apply({'params': p}, x, method=JFP.predict_series)
        with torch.no_grad():
            got = tmodel.predict_series(torch.from_numpy(x))
        _close(got['dur'], want['dur'], F32_ATOL)
        assert bool((got['dur'] == 2.0).all()) == fires
    dur = torch.tensor([[0.4, 0.3], [1.2, 0.0]])
    monkeypatch.setattr(tmodel.dur_pred, 'forward',
                        lambda x, pad_mask=None, alpha=1.0: dur[..., None])
    with torch.no_grad():
        got = tmodel.predict_series(torch.ones(2, 2, dtype=torch.long))
    assert torch.equal(got['dur'], dur)


# ------------------------------------------------------------- TTSInference

@pytest.fixture(scope='module')
def jax_inference(models):
    from forwardtacotron_tpu.models.synthesis import TTSInference as JTTS
    jmodel, params, _, _ = models
    return {dt: JTTS(jmodel, {'params': params}, dtype=dt)
            for dt in ('float32', 'bfloat16')}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_tts_inference_entry_points_match_jax(models, jax_inference, dtype,
                                              monkeypatch):
    """generate, generate_cropped, generate_routed and generate_fused (for
    FastPitch: predict_series then generate at the budget) against the
    JAX TTSInference, one ``lr`` twin call per decode."""
    import copy
    _, _, tmodel, x = models
    jtts = jax_inference[dtype]
    tts = TTSInference(copy.deepcopy(tmodel), dtype=dtype, device='cpu')
    atol = F32_ATOL if dtype == 'float32' else BF16_ATOL
    calls = []
    orig = lr.length_regulator_plain
    monkeypatch.setattr(lr, 'length_regulator_plain',
                        lambda *a: (calls.append(1), orig(*a))[1])
    want = jtts.generate(x)
    got = tts.generate(x)
    assert len(calls) == 1
    lens = np.asarray(want['mel_len'])
    np.testing.assert_array_equal(got['mel_len'].numpy(), lens)
    for key in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        assert got[key].dtype == torch.float32
        _close(got[key], want[key], atol)

    want = jtts.generate_cropped(x[0])
    got = tts.generate_cropped(x[0])
    for key in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        assert got[key].shape == want[key].shape
        _close(torch.from_numpy(got[key]), want[key], atol)

    calls.clear()
    want = jtts.generate_routed(x, frame_bucket=16)
    got = tts.generate_routed(x, frame_bucket=16)
    groups = len(np.unique(-(-lens // 16)))
    assert groups > 1 and len(calls) == groups
    np.testing.assert_array_equal(got['mel_len'].numpy(),
                                  np.asarray(want['mel_len']))
    for key in ('mel', 'mel_post', 'dur'):
        _close(got[key], want[key], atol)

    calls.clear()
    want = jtts.generate_fused(x, max_len=32)
    got = tts.generate_fused(x, max_len=32)
    assert len(calls) == 1 and got['mel'].shape[1] == 32
    np.testing.assert_array_equal(got['mel_len'].numpy(),
                                  np.asarray(want['mel_len']))
    for key in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        _close(got[key], want[key], atol)


def test_generate_blockwise_matches_full_and_jax(models, monkeypatch):
    """``generate`` with the post-regulator attention forced onto the
    blockwise schedule (a low FTT_ATTN_BLOCK_T, in both packages) against
    the JAX package's and the port's full path."""
    from forwardtacotron_tpu.models.fast_pitch import FastPitch as JFP
    jmodel, params, tmodel, x = models
    with torch.no_grad():
        s = tmodel.predict_series(torch.from_numpy(x))
        args = [s[k] for k in ('dur', 'pitch', 'energy')]
        full = tmodel.generate(torch.from_numpy(x), *args, 64)
        monkeypatch.setenv('FTT_ATTN_BLOCK_T', '16')
        blk = tmodel.generate(torch.from_numpy(x), *args, 64)
    want = jmodel.apply({'params': params}, x,
                        *[a.numpy() for a in args], 64, method=JFP.generate)
    _close(blk['mel'], want['mel'], F32_ATOL)
    _close(blk['mel'], full['mel'].numpy(), F32_ATOL)


# --------------------------------------------------- weights and registry

def _full_model():
    torch.manual_seed(0)
    config = read_config('configs/singlespeaker.yaml')
    config['tts_model'] = 'fast_pitch'
    return init_tts_model(config)


def test_state_dict_matches_reference_schema():
    schema = json.loads(SCHEMA.read_text())['models']['fast_pitch']
    got = {k: list(v.shape) for k, v in _full_model().state_dict().items()}
    assert len(got) == 277
    assert got == schema


def test_weight_bridge_both_ways():
    """The JAX converter accepts the port's state_dict (validated against
    the JAX init's tree); ``to_jax_variables`` gives the converter's tree
    exactly and ``from_jax_variables`` inverts it (every key but ``step``
    and the positional tables)."""
    import jax

    from forwardtacotron_tpu.models.registry import \
        init_tts_model as jax_init_tts_model
    from forwardtacotron_tpu.utils.convert import (convert_state_dict,
                                                   validate_against)
    model = _full_model()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.uniform_(0.5, 1.5)
    sd = model.state_dict()
    variables, _ = convert_state_dict(sd)
    config = read_config('configs/singlespeaker.yaml')
    config['tts_model'] = 'fast_pitch'
    n = 4
    batch = {'x': np.ones((1, n), np.int64),
             'dur': np.ones((1, n), np.float32), 'mel_len': np.array([n]),
             'pitch': np.zeros((1, n), np.float32),
             'energy': np.zeros((1, n), np.float32),
             'mel': np.zeros((1, n, 80), np.float32)}
    jmodel = jax_init_tts_model(config)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        batch, train=False))
    validate_against(variables, shapes)

    mine = to_jax_variables(sd)
    assert mine['batch_stats'] == {}
    flat_a = dict(jax.tree_util.tree_flatten_with_path(mine['params'])[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(
        variables['params'])[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=str(k))

    back = from_jax_variables(variables)
    skipped = {k for k in sd if k == 'step' or k.endswith('.pe')}
    assert set(back) == set(sd) - skipped and len(skipped) == 6
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    fresh = _full_model()
    missing, unexpected = fresh.load_state_dict(back, strict=False)
    assert set(missing) == skipped and unexpected == []


def test_registry_and_checkpoint_load(tmp_path):
    """``init_tts_model`` builds FastPitch (eval mode); a reference-format
    .pt loads into it with ``load_state_dict`` as it is."""
    from forwardtacotron_torch.utils.checkpoints import \
        init_tts_model_from_checkpoint
    config = narrow_config()
    torch.manual_seed(1)
    model = init_tts_model(config)
    assert isinstance(model, FastPitch) and not model.training
    with torch.no_grad():
        model.step.fill_(3000)
    path = tmp_path / 'fast_pitch.pt'
    torch.save({'model': model.state_dict(), 'config': config}, str(path))
    loaded, checkpoint = init_tts_model_from_checkpoint(path)
    assert isinstance(loaded, FastPitch)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize('batched', [False, True], ids=['one', 'batched'])
def test_gen_forward_fast_pitch_checkpoint(tmp_path, batched):
    """``python -m forwardtacotron_torch.gen_forward --device cpu`` on a
    FastPitch checkpoint: one wav per sentence, one by one and
    ``--batched``; the mel export matches ``TTSInference`` directly."""
    from scipy.io import wavfile

    from forwardtacotron_torch import gen_forward
    from forwardtacotron_torch.text.cleaners import Cleaner
    from forwardtacotron_torch.text.tokenizer import Tokenizer
    config = narrow_config()
    config['dsp'].update(sample_rate=8000, n_fft=64, hop_length=16,
                         win_length=64, fmin=0, fmax=4000)
    torch.manual_seed(2)
    model = init_tts_model(config)
    with torch.no_grad():
        model.dur_pred.lin.weight.zero_()
        model.dur_pred.lin.bias.fill_(2.0)
        model.step.fill_(5000)
    path = tmp_path / 'fp.pt'
    torch.save({'model': model.state_dict(), 'config': config}, str(path))
    text = tmp_path / 'text.txt'
    text.write_text('hello there.\nthe second one!\n', encoding='utf-8')
    out = tmp_path / 'out'
    gen_forward.main(['--checkpoint', str(path), '--text_file', str(text),
                      '--output', str(out), '--device', 'cpu']
                     + (['--batched'] if batched else []))
    wavs = sorted(out.glob('*.wav'))
    assert [w.name for w in wavs] == ['1_forward_5k_alpha1.0.wav',
                                      '2_forward_5k_alpha1.0.wav']
    pre = config['preprocessing']
    cleaner = Cleaner(pre['cleaner_name'], use_phonemes=False,
                      lang=pre['language'])
    lens = []
    for w in wavs:
        rate, wav = wavfile.read(str(w))
        assert rate == 8000 and len(wav) > 0
        lens.append(len(wav))
    # 2 frames a token (Griffin-Lim's samples follow the frames); batched,
    # FastPitch's duration head also expands the padding tokens (its
    # predict_series takes no padding mask, as in JAX)
    n_tok = [len(Tokenizer()(cleaner(s)))
             for s in ('hello there.', 'the second one!')]
    assert (lens[1] - lens[0]) == (0 if batched else
                                   2 * (n_tok[1] - n_tok[0]) * 16)
    mels = tmp_path / 'mels'
    gen_forward.main(['--checkpoint', str(path), '--input_text',
                      'hello there.', '--output', str(mels), '--device',
                      'cpu', 'hifigan'])
    got = np.load(str(mels / '1_forward_5k_alpha1.0.npy'))
    want = TTSInference(model, device='cpu').generate_cropped(
        Tokenizer()(cleaner('hello there.')))['mel_post']
    assert got.shape == (N_MELS, 2 * n_tok[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.usefixtures('no_tensorboard')
def test_train_forward_refuses_fast_pitch(tmp_path):
    """FastPitch trains on the CPU: ``train_forward`` on a FastPitch config
    reads its ``fast_pitch`` section (the name is kept from the slice
    before, when it refused), runs its schedule and writes reference-format
    checkpoints of the FastPitch schema, which ``gen_forward`` serves."""
    import yaml
    from torch_training_setup import write_dataset

    from forwardtacotron_torch import gen_forward, train_forward
    from forwardtacotron_torch.utils.checkpoints import (
        checkpoint_step, init_tts_model_from_checkpoint, restore_checkpoint)
    config = narrow_config()
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    train = config['fast_pitch']['training']
    train.update(schedule=['1e-3, 3, 2'], checkpoint_every=2,
                 bucket_multiple=8)
    train['filter'].update(max_mel_len=200, filter_duration_stats=False)
    paths = write_dataset(config)
    path = tmp_path / 'fp.yaml'
    path.write_text(yaml.safe_dump(config))
    train_forward.main(['--config', str(path), '--device', 'cpu'])
    ckpt = restore_checkpoint(paths.forward_checkpoints)
    assert checkpoint_step(ckpt) == 3 and int(ckpt['optim']['count']) == 3
    model, _ = init_tts_model_from_checkpoint(
        paths.forward_checkpoints / 'latest_model.pt')
    assert isinstance(model, FastPitch)
    metrics = (paths.forward_log / 'metrics.csv').read_text().splitlines()
    losses = [float(line.split(',')[2]) for line in metrics
              if ',Mel_Loss/train,' in line]
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = tmp_path / 'out'
    gen_forward.main(['--checkpoint',
                      str(paths.forward_checkpoints / 'latest_model.pt'),
                      '--input_text', 'hello there.', '--output', str(out),
                      '--device', 'cpu'])
    assert len(list(out.glob('*.wav'))) == 1
