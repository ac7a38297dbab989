"""Shared setup of tests/test_torch_training.py and
tests/test_torch_trainer.py: one narrow ForwardTacotron (128-wide
recurrences, dropout 0) in both packages with the same variables, a
collated batch, the JAX package's trainable RNN kernels in interpret mode
on the CPU, and the synthetic dataset of tests/test_forward_trainer.py."""

import functools
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from forwardtacotron_torch.models.registry import \
    init_tts_model as torch_init_tts_model
from forwardtacotron_torch.utils.convert import from_jax_variables
from forwardtacotron_torch.utils.files import read_config
from forwardtacotron_torch.utils.paths import Paths

N_MELS = 16
NARROW = dict(embed_dims=32, series_embed_dims=16, durpred_conv_dims=32,
              durpred_rnn_dims=16, pitch_conv_dims=32, pitch_rnn_dims=128,
              energy_conv_dims=32, energy_rnn_dims=16, rnn_dims=128,
              prenet_dims=128, prenet_k=4, prenet_num_highways=2,
              postnet_dims=128, postnet_k=4, postnet_num_highways=2,
              durpred_dropout=0.0, pitch_dropout=0.0, energy_dropout=0.0,
              prenet_dropout=0.0, postnet_dropout=0.0)
LOSSES = ('m1_loss', 'm2_loss', 'dur_loss', 'pitch_loss', 'energy_loss')


def narrow_config(precision, tmp_path):
    config = read_config('configs/singlespeaker.yaml')
    config['dsp']['num_mels'] = N_MELS
    config['forward_tacotron']['model'].update(NARROW)
    train = config['forward_tacotron']['training']
    train['precision'] = precision
    train['schedule'] = ['1e-3, 10, 3']
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    return config


def make_batch(seed=0):
    """A collated batch of 3 items with ragged tokens and frames, padded as
    ForwardCollator pads (mels with the log floor)."""
    rs = np.random.RandomState(seed)
    x_len = np.array([12, 9, 7])
    b, n = len(x_len), 16
    x = np.zeros((b, n), np.int64)
    dur, pitch, energy = (np.zeros((b, n), np.float32) for _ in range(3))
    for i, ln in enumerate(x_len):
        x[i, :ln] = rs.randint(1, 40, ln)
        dur[i, :ln] = rs.randint(1, 4, ln)
        pitch[i, :ln] = rs.randn(ln)
        energy[i, :ln] = rs.rand(ln)
    mel_len = dur.sum(1).astype(np.int64)
    t = -(-(int(mel_len.max()) + 1) // 8) * 8
    mel = np.full((b, t, N_MELS), -11.5129, np.float32)
    for i, ln in enumerate(mel_len):
        mel[i, :ln] = rs.randn(ln, N_MELS)
    return {'x': x, 'dur': dur, 'mel_len': mel_len, 'x_len': x_len,
            'pitch': pitch, 'energy': energy, 'pitch_target': pitch.copy(),
            'energy_target': energy.copy(), 'mel': mel}


@pytest.fixture()
def jax_kernels(monkeypatch):
    """The JAX package's trainable RNN kernels on the CPU: eligible under
    FTT_PALLAS_INTERPRET=1, run in interpret mode."""
    from forwardtacotron_tpu.ops.pallas import rnn_train as jax_rnn_train
    monkeypatch.setenv('FTT_PALLAS_INTERPRET', '1')
    monkeypatch.setattr(
        jax_rnn_train, 'bidir_rnn_trainable_sharded',
        functools.partial(jax_rnn_train.bidir_rnn_trainable_sharded,
                          interpret=True))


@pytest.fixture()
def no_tensorboard(monkeypatch, tmp_path_factory):
    """TensorBoard made unimportable in this process and in the processes
    the test starts (a ``tensorboard`` package first on PYTHONPATH that
    raises ImportError), so the trainers' ``make_writer`` takes the CSV
    writer and writes ``metrics.csv``."""
    shim = tmp_path_factory.mktemp('no_tensorboard')
    (shim / 'tensorboard').mkdir()
    (shim / 'tensorboard' / '__init__.py').write_text(
        "raise ImportError('tensorboard is hidden from this test')\n")
    monkeypatch.setenv('PYTHONPATH', os.pathsep.join(
        [str(shim)] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    for name in list(sys.modules):
        if name.split('.')[0] == 'tensorboard' \
                or name.startswith('torch.utils.tensorboard'):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, 'tensorboard', None)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)


def _random_variables(shapes, seed):
    """Numpy variables for a flax tree of shapes, drawn from ``seed`` at
    the scales of the model's initializers: kernels N(0, 1/fan_in),
    embeddings N(0, 1), the recurrences' wi/wh/bi/bh U(-1/sqrt(H),
    1/sqrt(H)); biases N(0, 0.01) and the BatchNorm affine and running
    statistics random too (init leaves them at 0/1, which hides
    mistakes)."""
    rs = np.random.RandomState(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, 'items'):
                out[k] = walk(v, path + (k,))
                continue
            shape = v.shape
            if 'bnorm' in path:
                a = (rs.uniform(0.5, 1.5, shape) if k in ('scale', 'var')
                     else 0.1 * rs.randn(*shape))
            elif k in ('wi', 'wh', 'bi', 'bh'):
                bound = tree['wh'].shape[0] ** -0.5
                a = rs.uniform(-bound, bound, shape)
            elif k == 'kernel':
                a = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            elif k == 'embedding':
                a = rs.randn(*shape)
            elif k == 'bias':
                a = 0.1 * rs.randn(*shape)
            else:
                a = np.ones(shape)
            out[k] = a.astype(np.float32)
        return out
    return {col: walk(tree, ()) for col, tree in shapes.items()}


@functools.lru_cache(maxsize=1)
def _jax_model_and_variables():
    """The narrow JAX model and its seeded random variables, made once per
    process: the model part of the config does not depend on the
    precision. Only the variables' shapes come from the JAX init
    (``eval_shape``: nothing is compiled)."""
    import jax

    from forwardtacotron_tpu.models.registry import init_tts_model

    jmodel = init_tts_model(narrow_config('float32', Path('unused')))
    batch = make_batch()
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        {k: batch[k] for k in ('x', 'dur', 'mel_len', 'pitch', 'energy',
                               'mel')}, train=False))
    return jmodel, _random_variables(shapes, seed=3)


def both_models(config):
    """The JAX model with its variables and a fresh port model with the
    same weights."""
    jmodel, variables = _jax_model_and_variables()
    tmodel = torch_init_tts_model(config)
    missing, unexpected = tmodel.load_state_dict(
        from_jax_variables(variables), strict=False)
    assert missing == ['step'] and unexpected == []
    return jmodel, variables, tmodel


def scaled_close(got, want, tol, floor, name):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, name
    scale = max(floor, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f'{name}: {err:.3e} > {tol:g} x {scale:.3e}'


def paths_of(config):
    return Paths.from_config(config)


def write_dataset(config, n_items=8):
    """The synthetic dataset of tests/test_forward_trainer.py: 8 items of
    4-6 phonemes, 1-3 frames each, random mels, pitch and energy."""
    from forwardtacotron_torch.text.symbols import phonemes

    paths = Paths.from_config(config)
    n_mels = config['dsp']['num_mels']
    rs = np.random.RandomState(0)
    text_dict, speaker_dict, dataset = {}, {}, []
    for i in range(n_items):
        item_id = f'item{i}'
        n_tok = 4 + i % 3
        text = ''.join(phonemes[20 + j] for j in range(n_tok))
        dur = rs.randint(1, 4, n_tok).astype(np.float32)
        mel_len = int(dur.sum())
        np.save(paths.mel / f'{item_id}.npy',
                rs.randn(n_mels, mel_len).astype(np.float32))
        np.save(paths.speaker_emb / f'{item_id}.npy', np.zeros(256, np.float32))
        np.save(paths.alg / f'{item_id}.npy', dur)
        np.save(paths.phon_pitch / f'{item_id}.npy',
                rs.randn(n_tok).astype(np.float32))
        np.save(paths.phon_energy / f'{item_id}.npy',
                rs.rand(n_tok).astype(np.float32))
        text_dict[item_id] = text
        speaker_dict[item_id] = 'spk'
        dataset.append((item_id, mel_len))
    for path, obj in ((paths.text_dict, text_dict),
                      (paths.speaker_dict, speaker_dict),
                      (paths.train_dataset, dataset[:6]),
                      (paths.val_dataset, dataset[6:])):
        with open(path, 'wb') as f:
            pickle.dump(obj, f)
    return paths


# ------------------------------------------------------------ multispeaker
#
# Narrow multispeaker models: the trunk LSTM takes 2 * 32 + 64 = 128
# inputs and the pitch predictor's GRU is 128 wide, so in bfloat16 the JAX
# gates send them to their kernels (the fused trunk in serving, the
# trainable cores in training), as at the published widths.

MULTI_NARROW = dict(speaker_emb_dims=64, embed_dims=32, series_embed_dims=16,
                    durpred_conv_dims=32, durpred_rnn_dims=16,
                    pitch_conv_dims=32, pitch_rnn_dims=128,
                    energy_conv_dims=32, energy_rnn_dims=16,
                    pitch_cond_conv_dims=32, pitch_cond_rnn_dims=16,
                    pitch_cond_emb_dims=4, prenet_dims=32, prenet_k=2,
                    prenet_num_highways=1, rnn_dims=128, postnet_dims=32,
                    postnet_k=2, postnet_num_highways=1,
                    durpred_dropout=0.0, pitch_dropout=0.0,
                    energy_dropout=0.0, pitch_cond_dropout=0.0,
                    prenet_dropout=0.0, postnet_dropout=0.0)
MULTI_FP_NARROW = dict(speaker_emb_dims=32, durpred_d_model=16,
                       durpred_n_heads=2, durpred_layers=1,
                       durpred_d_fft=16, pitch_d_model=16, pitch_n_heads=2,
                       pitch_layers=1, pitch_d_fft=16, energy_d_model=16,
                       energy_n_heads=2, energy_layers=1, energy_d_fft=16,
                       pitch_cond_d_model=16, pitch_cond_n_heads=2,
                       pitch_cond_layers=1, pitch_cond_d_fft=16, d_model=32,
                       conv1_kernel=9, conv2_kernel=1, prenet_layers=1,
                       prenet_heads=2, prenet_fft=48, postnet_layers=1,
                       postnet_heads=2, postnet_fft=48,
                       durpred_dropout=0.0, pitch_dropout=0.0,
                       energy_dropout=0.0, pitch_cond_dropout=0.0,
                       prenet_dropout=0.0, postnet_dropout=0.0)
FP_NARROW = {k: v for k, v in MULTI_FP_NARROW.items()
             if not k.startswith(('speaker', 'pitch_cond'))}
NARROW_OF = {'multi_forward_tacotron': MULTI_NARROW,
             'multi_fast_pitch': MULTI_FP_NARROW, 'fast_pitch': FP_NARROW}
SPEAKERS = ('spk0', 'spk1', 'spk2')


def family_config(family, precision, tmp_path):
    """configs/multispeaker.yaml (configs/singlespeaker.yaml for
    fast_pitch) with ``family``'s model narrowed, ``precision`` in its
    training section, a 10-step schedule at batch 3 and the data and
    checkpoints under ``tmp_path``."""
    source = 'singlespeaker' if family == 'fast_pitch' else 'multispeaker'
    config = read_config(f'configs/{source}.yaml')
    config['tts_model'] = family
    config['dsp']['num_mels'] = N_MELS
    config[family]['model'].update(NARROW_OF[family])
    train = config[family]['training']
    train['precision'] = precision
    train['schedule'] = ['1e-3, 10, 3']
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    return config


def speaker_table(n, dims, seed):
    """``n`` speaker embeddings [n, dims] like resemblyzer's: non-negative
    and of unit norm."""
    e = np.abs(np.random.RandomState(seed).randn(n, dims)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def make_multi_batch(dims, seed=0):
    """``make_batch`` plus a speaker embedding per item and the pitch
    condition (0 at padding, 1 where the pitch is 0, else 2; the first
    token of every item is unvoiced)."""
    batch = make_batch(seed)
    batch['pitch'][:, 0] = 0.0
    batch['pitch_target'] = batch['pitch'].copy()
    valid = np.arange(batch['x'].shape[1])[None] < batch['x_len'][:, None]
    batch['pitch_cond'] = np.where(
        valid, np.where(batch['pitch'] == 0, 1, 2), 0).astype(np.int64)
    batch['speaker_emb'] = speaker_table(len(batch['x']), dims, seed + 1)
    return batch


_MODEL_KEYS = ('x', 'dur', 'mel_len', 'pitch', 'energy', 'mel',
               'speaker_emb', 'pitch_cond')


@functools.lru_cache(maxsize=4)
def _family_model_and_variables(family):
    import jax

    from forwardtacotron_tpu.models.registry import init_tts_model

    jmodel = init_tts_model(family_config(family, 'float32', Path('unused')))
    batch = make_multi_batch(NARROW_OF[family].get('speaker_emb_dims', 1))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        {k: batch[k] for k in _MODEL_KEYS}, train=False))
    return jmodel, _random_variables(shapes, seed=5)


def family_models(config):
    """The JAX model of ``config['tts_model']`` with seeded variables, and
    a fresh port model with the same weights (missing: only the ``step``
    buffer and the transformers' positional tables)."""
    jmodel, variables = _family_model_and_variables(config['tts_model'])
    tmodel = torch_init_tts_model(config)
    missing, unexpected = tmodel.load_state_dict(
        from_jax_variables(variables), strict=False)
    assert unexpected == [] and all(k == 'step' or k.endswith('.pe')
                                    for k in missing)
    return jmodel, variables, tmodel


def write_multi_dataset(config, n_items=8):
    """``write_dataset`` with three speakers: each item's speaker embedding
    and each speaker's mean embedding, and unvoiced tokens (pitch 0)."""
    paths = write_dataset(config, n_items)
    dims = config[config['tts_model']]['model']['speaker_emb_dims']
    table = speaker_table(len(SPEAKERS), dims, 11)
    speaker_dict = {}
    for i in range(n_items):
        item_id = f'item{i}'
        speaker_dict[item_id] = SPEAKERS[i % len(SPEAKERS)]
        np.save(paths.speaker_emb / f'{item_id}.npy', table[i % len(SPEAKERS)])
        pitch = np.load(paths.phon_pitch / f'{item_id}.npy')
        pitch[::2] = 0.0
        np.save(paths.phon_pitch / f'{item_id}.npy', pitch)
    for s, emb in zip(SPEAKERS, table):
        np.save(paths.mean_speaker_emb / f'{s}.npy', emb)
    with open(paths.speaker_dict, 'wb') as f:
        pickle.dump(speaker_dict, f)
    return paths


def close_at_scale(got, want, atol, mask=None):
    """|got - want| <= atol x max(1, max |want|), over ``mask`` if given."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)


def rounding_margin(dur):
    """The smallest distance of a duration from a rounding point (d + 0.5
    an integer; negatives clamp to 0)."""
    frac = np.clip(np.asarray(dur, np.float64), 0, None) % 1.0
    return float(np.abs(frac - 0.5).min())


def teacher_batch(x, semb, seed=9):
    """A teacher-forced batch for tokens ``x`` (0 = padding) and speakers
    ``semb``: 1-3 frames a token, every third token unvoiced."""
    rs = np.random.RandomState(seed)
    dur = np.where(x > 0, rs.randint(1, 4, x.shape), 0).astype(np.float32)
    mel_len = dur.sum(1).astype(np.int64)
    pitch = rs.randn(*x.shape).astype(np.float32)
    pitch[:, ::3] = 0.0
    return {'x': x, 'dur': dur, 'mel_len': mel_len, 'pitch': pitch,
            'energy': rs.rand(*x.shape).astype(np.float32),
            'pitch_cond': np.where(x > 0, np.where(pitch == 0, 1, 2), 0),
            'speaker_emb': semb,
            'mel': np.zeros((len(x), int(mel_len.max()) + 5, N_MELS),
                            np.float32)}


@functools.lru_cache(maxsize=2)
def full_width_model(family):
    """``family`` at the full width of configs/multispeaker.yaml from seed
    0, and its config; made once per process, so a test that changes the
    model changes a copy."""
    torch.manual_seed(0)
    config = read_config('configs/multispeaker.yaml')
    config['tts_model'] = family
    return torch_init_tts_model(config), config


def jax_forward(jmodel, variables, batch):
    """The JAX model's teacher-forced ``__call__`` in eval and in training
    mode, both under one jit: ``{False: outputs, True: (outputs, updated
    variables)}``."""
    import jax

    def both(v, b):
        return (jmodel.apply(v, b, train=False),
                jmodel.apply(v, b, train=True, mutable=['batch_stats']))
    want_eval, want_train = jax.jit(both)(variables, batch)
    return {False: want_eval, True: want_train}


# XLA's least optimizing CPU compile: the JAX train steps compile in about
# two thirds of the time (the computation and its float32 results are the
# same; only the generated code is less tuned)
QUICK_COMPILE = {'xla_backend_optimization_level': 0,
                 'xla_llvm_disable_expensive_passes': True}


def run_jax_step(step, *args):
    """One call of the jitted JAX ``step``, compiled with QUICK_COMPILE."""
    return step.lower(*args).compile(QUICK_COMPILE)(*args)
