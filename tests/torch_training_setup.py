"""Shared setup of tests/test_torch_training.py and
tests/test_torch_trainer.py: one narrow ForwardTacotron (128-wide
recurrences, dropout 0) in both packages with the same variables, a
collated batch, the JAX package's trainable RNN kernels in interpret mode
on the CPU, and the synthetic dataset of tests/test_forward_trainer.py."""

import functools
import pickle
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
