"""The JAX package's native ``.ckpt`` on the port (forwardtacotron_torch/
utils/checkpoints.py), against the JAX package's own
``save_checkpoint`` / ``load_checkpoint`` / ``restore_opt_state``, on the
CPU at narrow widths:

- the port's ``convert_state_dict`` gives the JAX converter's tree and aux
  buffers on the five models of the pinned reference schema, and its
  ``validate_against`` accepts and refuses what the JAX one does;
- JAX -> port: a ``.ckpt`` that the JAX ``ForwardTrainer`` saved after one
  step resumes in the port (``restore_checkpoint`` takes a lone
  ``latest_model.ckpt``) with the JAX variables and Adam state exactly; the
  loaded model serves the JAX eval forward within the f32 parity
  tolerance, and one port step from it matches one JAX step from it within
  tests/test_torch_trainer.py's one-step tolerance. ``.ckpt`` files of
  FastPitch, MultiFastPitch (with its speaker table in the meta) and the
  teacher, with an optax state after one update, load with their step,
  config, speaker table, optimizer state and the teacher's r, and serve
  the JAX eval forward; ``gen_forward --speaker`` reads a ``.ckpt``'s
  speaker table and ``train_tacotron`` resumes a lone ``.ckpt``;
- port -> JAX: ``save_native_checkpoint`` writes the very bytes the JAX
  package's ``save_checkpoint`` writes for the same state, which its
  ``load_checkpoint`` and ``restore_opt_state`` read back into the
  same tree.

Tolerances: eval forwards 1e-4 of max(1, max |JAX|) (the f32 parity
tests'); the resumed step as tests/test_torch_trainer.py's f32 step.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from forwardtacotron_torch.models.registry import \
    init_tts_model as torch_init_tts_model
from forwardtacotron_torch.models.tacotron import Tacotron
from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
from forwardtacotron_torch.train.state import (create_train_state,
                                               state_from_checkpoint)
from forwardtacotron_torch.utils import checkpoints as tckpt
from forwardtacotron_torch.utils.convert import (convert_state_dict,
                                                 from_jax_variables,
                                                 validate_against)
from forwardtacotron_torch.utils.files import read_config

from torch_training_setup import (  # noqa: F401 (no_tensorboard: a fixture)
    LOSSES, N_MELS, QUICK_COMPILE, _random_variables, both_models,
    family_config, family_models, make_batch, make_multi_batch, narrow_config,
    no_tensorboard, paths_of, scaled_close, speaker_table, write_dataset)

SCHEMA = Path('tests/resources/reference_state_dict_schema.json')
TEACHER_NARROW = dict(embed_dims=16, encoder_dims=128, decoder_dims=32,
                      lstm_dims=32, postnet_dims=16, encoder_k=4,
                      postnet_k=3, num_highways=2, speaker_emb_dim=16)
F32_TOL = 1e-4


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def jax_eval(fn, variables, batch):
    """``fn(variables, batch)`` jitted, compiled with QUICK_COMPILE."""
    import jax
    return jax.jit(fn).lower(variables, batch).compile(QUICK_COMPILE)(
        variables, batch)


def assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg='/'.join(k))


@pytest.mark.parametrize('model', json.loads(SCHEMA.read_text())['models'])
def test_convert_state_dict_matches_jax(model):
    from forwardtacotron_tpu.utils import convert as jconvert

    rs = np.random.RandomState(0)
    sd = {k: torch.from_numpy(np.asarray(rs.randn(*shape), np.float32))
          for k, shape in json.loads(SCHEMA.read_text())['models'][
              model].items()}
    got, got_aux = convert_state_dict(sd)
    want, want_aux = jconvert.convert_state_dict(sd)
    assert_trees_equal(got, want)
    assert_trees_equal(got_aux, want_aux)
    validate_against(got, want)
    wrong = {col: dict(tree) for col, tree in want.items()}
    first = next(iter(wrong['params']))
    wrong['params'][first] = {'extra': np.zeros(3)}
    with pytest.raises(ValueError) as mine:
        validate_against(got, wrong)
    with pytest.raises(ValueError) as theirs:
        jconvert.validate_against(got, wrong)
    assert str(mine.value) == str(theirs.value)


# ------------------------------------------------------------ JAX -> port

@pytest.mark.usefixtures('no_tensorboard')    # the JAX trainer's writer
def test_resume_from_jax_ckpt_matches_jax_step(tmp_path):
    """One JAX ForwardTrainer step, its ``latest_model.ckpt``; the port
    resumes from it alone, serves the JAX eval forward and takes the next
    step as the JAX trainer does."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.parallel.mesh import make_mesh
    from forwardtacotron_tpu.train.forward_trainer import \
        ForwardTrainer as JaxTrainer
    from forwardtacotron_tpu.train.state import \
        create_train_state as jax_train_state
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    config = narrow_config('float32', tmp_path)
    jmodel, variables, _ = both_models(config)
    batch = make_batch(seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    jtrainer = JaxTrainer(JaxPaths.from_config(config), None, config,
                          mesh=make_mesh(n_data=1))
    jstate = jax_train_state(jax.tree.map(jnp.asarray, variables),
                             jtrainer.tx)
    step = jtrainer._build_train_step(jmodel).lower(
        jstate, jbatch, key).compile(QUICK_COMPILE)
    jstate, _ = step(jstate, jbatch, key)
    jtrainer._save(jstate, 'latest_model.ckpt')
    saved = jax.device_get({'variables': jstate.variables(),
                            'adam': jstate.opt_state[1].inner_state[0]})

    paths = paths_of(config)
    assert [p.name for p in paths.forward_checkpoints.glob('*.*')] == [
        'latest_model.ckpt']
    ckpt = tckpt.restore_checkpoint(paths.forward_checkpoints)
    assert tckpt.checkpoint_step(ckpt) == 1 and ckpt['config'] == config
    model = torch_init_tts_model(config)
    trainer = ForwardTrainer(paths, None, config, device='cpu')
    state = state_from_checkpoint(model, trainer.tx, ckpt)
    assert state.step == 1
    for k, v in from_jax_variables(saved['variables']).items():
        assert torch.equal(model.state_dict()[k], v), k
    opt = state.opt_state
    assert int(opt['count']) == int(saved['adam'].count) == 1
    assert float(opt['learning_rate']) == np.float32(1e-3)
    for name in ('mu', 'nu'):
        want = from_jax_variables({'params': getattr(saved['adam'], name)})
        assert sorted(opt[name]) == sorted(dict(model.named_parameters()))
        for k, v in opt[name].items():
            assert torch.equal(v, want[k]), (name, k)

    # the loaded model serves the JAX eval forward
    out = jax_eval(lambda v, b: jmodel.apply(v, b, train=False),
                   saved['variables'], jbatch)
    with torch.no_grad():
        got = model.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        scaled_close(got[k], out[k], F32_TOL, 1.0, k)

    # the next step, on both sides
    jstate, jmetrics = step(jstate, jbatch, key)
    metrics = trainer.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert state.step == 2 and int(state.opt_state['count']) == 2
    for k in LOSSES + ('loss',):
        scaled_close(metrics[k], jmetrics[k], F32_TOL, 1.0, k)
    lr = 1e-3
    n_far = n_all = 0
    want = from_jax_variables({'params': jstate.params,
                               'batch_stats': jstate.batch_stats})
    for name, w in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        g, w = model.state_dict()[name].numpy(), w.numpy()
        if name.endswith(('running_mean', 'running_var')):
            scaled_close(g, w, F32_TOL, 1.0, name)
            continue
        far = ~np.isclose(g, w, rtol=1e-5, atol=1e-2 * lr)
        n_far, n_all = n_far + int(far.sum()), n_all + far.size
        assert np.abs(g - w).max() <= 2.001 * lr, name
    assert n_far <= 5e-3 * n_all, (n_far, n_all)


def _teacher_config(tmp_path):
    config = read_config('configs/singlespeaker.yaml')
    config['dsp']['num_mels'] = N_MELS
    config['tacotron']['model'].update(TEACHER_NARROW)
    config['tacotron']['training']['schedule'] = ['5, 1e-3, 4, 2',
                                                  '2, 5e-4, 10, 2']
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    return config


def _teacher_case(tmp_path):
    """(config, JAX teacher, seeded variables, eval inputs, r)."""
    import jax

    from forwardtacotron_tpu.models.tacotron import Tacotron as JaxTacotron

    config = _teacher_config(tmp_path)
    jmodel = JaxTacotron.from_config(config)
    rs = np.random.RandomState(3)
    x = rs.randint(1, 40, (2, 7))
    batch = {'x': x, 'mel': rs.randn(2, 8, N_MELS).astype(np.float32),
             'speaker_emb': rs.rand(2, 16).astype(np.float32)}
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        {k: jax.numpy.asarray(v) for k, v in batch.items()}, r=2,
        train=False))
    return config, jmodel, _random_variables(shapes, seed=4), batch


def _family_case(family, tmp_path):
    config = family_config(family, 'float32', tmp_path)
    jmodel, variables, _ = family_models(config)
    batch = make_multi_batch(
        config[family]['model'].get('speaker_emb_dims', 1))
    if family == 'fast_pitch':
        batch.pop('speaker_emb')
        batch.pop('pitch_cond')
    return config, jmodel, variables, batch


def _jax_opt_state(variables, lr, clip):
    """The JAX trainer's optax state after one update on seeded
    gradients."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.train.state import make_optimizer

    tx = make_optimizer(lr, clip)
    params = jax.tree.map(jnp.asarray, variables['params'])
    rs = np.random.RandomState(2)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rs.randn(*p.shape).astype(np.float32)), params)
    _, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    return opt_state


@pytest.mark.parametrize('family', ['fast_pitch', 'multi_fast_pitch',
                                    'tacotron'])
def test_jax_ckpt_loads_in_port(family, tmp_path, monkeypatch):
    import jax

    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint

    if family == 'tacotron':
        from forwardtacotron_tpu.models import tacotron as jax_tacotron
        monkeypatch.setattr(jax_tacotron, 'DECODER_SCAN_UNROLL', 1)
        config, jmodel, variables, batch = _teacher_case(tmp_path)
        section = config['tacotron']
    else:
        config, jmodel, variables, batch = _family_case(family, tmp_path)
        section = config[family]
    meta = None
    if family.startswith('multi'):
        table = speaker_table(3, config[family]['model']['speaker_emb_dims'],
                              8)
        meta = {'speaker_embeddings': {f'spk{i}': e
                                       for i, e in enumerate(table)}}
    clip = section['training'].get('clip_grad_norm', 1.0)
    opt_state = _jax_opt_state(variables, 5e-4, clip)
    path = tmp_path / 'model.ckpt'
    save_checkpoint(path, variables, config, opt_state=opt_state, step=7,
                    meta=meta)

    ckpt = tckpt.load_checkpoint(path)
    assert ckpt['config'] == config and tckpt.checkpoint_step(ckpt) == 7
    if meta:
        assert sorted(ckpt['speaker_embeddings']) == ['spk0', 'spk1', 'spk2']
        for name, emb in meta['speaker_embeddings'].items():
            np.testing.assert_array_equal(ckpt['speaker_embeddings'][name],
                                          emb)
    if family == 'tacotron':
        model = Tacotron.from_config(config)
        # step 7 lies in the second schedule row
        assert int(ckpt['model']['decoder.r']) == 2
    else:
        model = torch_init_tts_model(config)
    model.load_state_dict(ckpt['model'])
    for k, v in from_jax_variables(variables).items():
        assert torch.equal(ckpt['model'][k], v), k
    adam = opt_state[-1].inner_state[0]
    optim = ckpt['optim']
    assert int(optim['count']) == 1
    assert float(optim['learning_rate']) == np.float32(5e-4)
    for name in ('mu', 'nu'):
        want = from_jax_variables(
            {'params': jax.device_get(getattr(adam, name))})
        assert sorted(optim[name]) == sorted(dict(model.named_parameters()))
        for k, v in optim[name].items():
            assert torch.equal(v, want[k]), (name, k)

    # the loaded model serves the JAX eval forward
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    model.eval()
    with torch.no_grad():
        if family == 'tacotron':
            want = jax_eval(lambda v, b: jmodel.apply(v, b, r=2, train=False),
                            variables, jb)
            got = model(tb, 2)
            for name, g, w in zip(('mel', 'linear', 'attention'), got, want):
                scaled_close(g, w, F32_TOL, 1.0, name)
            return
        want = jax_eval(lambda v, b: jmodel.apply(v, b, train=False),
                        variables, jb)
        got = model(tb)
    for k in ('mel', 'mel_post', 'dur', 'pitch', 'energy'):
        scaled_close(got[k], want[k], F32_TOL, 1.0, k)


def test_clis_take_a_jax_ckpt(tmp_path, capsys):
    """``gen_forward --speaker`` on a JAX MultiFastPitch ``.ckpt`` speaks
    from its speaker table, as from the same model's ``.pt``;
    ``train_tacotron --force_gta`` resumes a lone JAX
    ``latest_model.ckpt`` and exports every item."""
    import yaml

    from forwardtacotron_tpu.utils.checkpoints import save_checkpoint

    from forwardtacotron_torch import gen_forward, train_tacotron

    family = 'multi_fast_pitch'
    config, _, variables, _ = _family_case(family, tmp_path)
    table = speaker_table(3, config[family]['model']['speaker_emb_dims'], 8)
    meta = {'speaker_embeddings': {f'spk{i}': e
                                   for i, e in enumerate(table)}}
    save_checkpoint(tmp_path / 'multi.ckpt', variables, config, step=7,
                    meta=meta)
    model = torch_init_tts_model(config)
    model.load_state_dict(tckpt.load_checkpoint(tmp_path / 'multi.ckpt')[
        'model'])
    tckpt.save_checkpoint(tmp_path / 'multi.pt', model, config, step=7,
                          meta=meta)
    mels = {}
    for kind in ('ckpt', 'pt'):
        gen_forward.main(['--checkpoint', str(tmp_path / f'multi.{kind}'),
                          '--input_text', 'hello there.', '--speaker',
                          'spk2', '--output', str(tmp_path / kind),
                          '--device', 'cpu', 'hifigan'])
        assert 'No --speaker given' not in capsys.readouterr().out
        [mels[kind]] = [np.load(f) for f in (tmp_path / kind).glob('*.npy')]
    np.testing.assert_array_equal(mels['ckpt'], mels['pt'])

    config, _, variables, _ = _teacher_case(tmp_path)
    paths = paths_of(config)
    write_dataset(config)
    rs = np.random.RandomState(5)
    for f in paths.speaker_emb.glob('*.npy'):
        np.save(f, rs.rand(16).astype(np.float32))
    save_checkpoint(paths.taco_checkpoints / 'latest_model.ckpt', variables,
                    config, step=7)
    cfg_path = tmp_path / 'teacher.yaml'
    cfg_path.write_text(yaml.dump(config))
    train_tacotron.main(['--config', str(cfg_path), '--device', 'cpu',
                         '--force_gta'])
    assert 'Restored checkpoint at step 7' in capsys.readouterr().out
    assert len(list(paths.gta.glob('*.npy'))) == 8


def test_restore_checkpoint_prefers_pt(tmp_path):
    """``latest_model.pt`` wins over ``latest_model.ckpt``; a lone
    ``.ckpt`` is taken; an empty directory gives None."""
    config = family_config('fast_pitch', 'float32', tmp_path)
    model = torch_init_tts_model(config)
    assert tckpt.restore_checkpoint(tmp_path) is None
    tckpt.save_native_checkpoint(tmp_path / 'latest_model.ckpt', model,
                                 config, step=3)
    assert tckpt.checkpoint_step(tckpt.restore_checkpoint(tmp_path)) == 3
    tckpt.save_checkpoint(tmp_path / 'latest_model.pt', model, config,
                          step=5)
    assert tckpt.checkpoint_step(tckpt.restore_checkpoint(tmp_path)) == 5


# ------------------------------------------------------------ port -> JAX

@pytest.mark.parametrize('family', ['forward_tacotron', 'multi_forward_tacotron',
                                    'tacotron'])
def test_port_ckpt_loads_in_jax(family, tmp_path):
    """A port model and its optimizer state after one port step, written
    as ``.ckpt``: the JAX package reads the variables, step, config, meta
    and optax state, and its own ``save_checkpoint`` of what it read writes
    the same bytes."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.train.state import make_optimizer
    from forwardtacotron_tpu.utils import checkpoints as jckpt

    meta = None
    if family == 'tacotron':
        config = _teacher_config(tmp_path)
        model = Tacotron.from_config(config)
        clip = None     # Adam alone: optax's state without the clip
        config['tacotron']['training']['clip_grad_norm'] = clip
    else:
        config = (narrow_config('float32', tmp_path)
                  if family == 'forward_tacotron'
                  else family_config(family, 'float32', tmp_path))
        model = torch_init_tts_model(config)
        clip = 1.0
        if family.startswith('multi'):
            table = speaker_table(
                3, config[family]['model']['speaker_emb_dims'], 8)
            meta = {'speaker_embeddings': {f'spk{i}': e
                                           for i, e in enumerate(table)}}
    from forwardtacotron_torch.train.state import make_optimizer as tmake
    tx = tmake(2e-3, clip)
    state = create_train_state(model, tx, step=4)
    params = state.params()
    rs = np.random.RandomState(1)
    tx.step(params, {k: torch.from_numpy(rs.randn(*p.shape).astype(
        np.float32)) for k, p in params.items()}, state.opt_state)
    path = tmp_path / 'port.ckpt'
    tckpt.save_native_checkpoint(path, model, config, step=5,
                                 opt_state=state.opt_state, meta=meta)

    ckpt = jckpt.load_checkpoint(path)
    assert ckpt['step'] == 5 and ckpt['config'] == config
    assert_trees_equal(ckpt['variables'],
                       convert_state_dict(model.state_dict())[0])
    if meta:
        assert_trees_equal(ckpt['meta'], meta)
    jtx = make_optimizer(1e-3, clip)
    template = jtx.init(jax.tree.map(jnp.asarray,
                                     ckpt['variables']['params']))
    opt = jckpt.restore_opt_state(ckpt, template)
    inject = opt[-1]
    adam = inject.inner_state[0]
    assert int(adam.count) == int(inject.count) == 1
    assert float(inject.hyperparams['learning_rate']) == np.float32(2e-3)
    for name in ('mu', 'nu'):
        assert_trees_equal(jax.device_get(getattr(adam, name)),
                           convert_state_dict(state.opt_state[name])[0][
                               'params'])
    again = tmp_path / 'jax.ckpt'
    jckpt.save_checkpoint(again, ckpt['variables'], ckpt['config'],
                          opt_state=opt, step=ckpt['step'],
                          meta=ckpt.get('meta'))
    assert again.read_bytes() == path.read_bytes()
