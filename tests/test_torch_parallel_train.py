"""The port's data-parallel trainers on the CPU, each rank a gloo process
of ``tests/torch_parallel_worker.py`` under a timeout (a failed or hung
rank fails its test and every rank is killed):

- a world of 2 and of 4 ranks (each its own rows of a 4-row global batch
  at its own padded shape, so that the ranks' mask counts and shapes
  differ; BatchNorm on) taking one float32 ``ForwardTrainer`` step,
  against the JAX ``ForwardTrainer`` step on a 2-device mesh over the
  global batch (the tolerances of tests/test_torch_trainer.py: losses 1e-4
  of the scale, parameters 1e-5 relative plus 1e-2 of the learning rate,
  at most 0.5% of them up to 2 learning rates apart, BatchNorm statistics
  1e-4) and against the port's one-process step on the same batch (the
  same tolerances, and the gradient norm 1e-5 relative); every rank ends
  with the same parameters and statistics, bit for bit. The JAX step
  compiles once (``QUICK_COMPILE``) for both worlds;
- 2-rank steps of the bf16 ``ForwardTrainer``, the float32
  ``MultiForwardTrainer`` and the float32 ``TacoTrainer`` against the
  port's one-process step on the global batch (which the existing tests
  hold to the JAX trainers): float32 as above, bf16 losses and BatchNorm
  statistics 5e-2 of the scale, the gradient norm 5e-2 relative and the
  updates a tenth of the learning rate on average (tests/
  test_torch_trainer.py's bf16 tolerances);
- ``python -m torch.distributed.run --nproc_per_node 2 -m
  forwardtacotron_torch.train_forward --device cpu`` on the synthetic data
  set: rank 0 alone writes the checkpoints and the log, with the
  one-process run's names and step, and one process resumes from them;
  ``train_tacotron``'s extraction modes refuse a world of 2;
- rank 0's plots (``plot_every: 1``, ``ForwardTrainer`` and
  ``MultiForwardTrainer``): 2 steps of 2 ranks with a plot after each end
  bit-equal to the same 2 steps without plots, on every rank.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from forwardtacotron_torch.utils.convert import from_jax_variables
from forwardtacotron_torch.utils.files import read_config

from torch_parallel_worker import (REPO, launch, make_items,
                                   rank_batches, run_ranks, step_difference,
                                   train_steps)
from torch_training_setup import (  # noqa: F401 (no_tensorboard: a fixture)
    LOSSES, N_MELS, both_models, family_config, family_models, narrow_config,
    no_tensorboard, run_jax_step, scaled_close, write_dataset)

LR = 1e-3
F32_TOL, BF16_TOL = 1e-4, 5e-2


def shares(items, world):
    """``rank_batches`` whose ranks differ in padded shape and mask
    counts."""
    batches, global_batch = rank_batches(items, world)
    assert len({b['mel'].shape[1] for b in batches}) > 1
    assert len({int(b['mel_len'].sum()) for b in batches}) > 1
    return batches, global_batch


def assert_step_close(got, want, mp, name):
    """tests/test_torch_trainer.py's tolerances on an optimizer step's
    parameters and BatchNorm statistics (state_dicts)."""
    stat_err, param = step_difference(got, want, LR, mp)
    assert stat_err <= (BF16_TOL if mp else F32_TOL), (name, stat_err)
    assert param <= (0.1 if mp else 5e-3), (name, param)


def assert_ranks_agree(results):
    """Every rank took the same update: parameters and statistics equal
    bit for bit, the same metrics."""
    first = results[0]
    for res in results[1:]:
        assert res['metrics'] == first['metrics']
        for key, value in first['state'].items():
            assert torch.equal(res['state'][key], value), key


def _forward_job(tmp_path, precision, world, seed=1):
    config = narrow_config(precision, tmp_path)
    _, variables, tmodel = both_models(config)
    batches, global_batch = shares(make_items(4, seed, N_MELS), world)
    job = {'trainer': 'forward', 'config': config, 'device': 'cpu',
           'state_dict': tmodel.state_dict(), 'batches': batches}
    return job, variables, global_batch


@pytest.fixture(scope='module')
def jax_mesh_step(tmp_path_factory):
    """The JAX ForwardTrainer's float32 step on a 2-device mesh over the
    global batch of ``_forward_job`` (the same for every world): (metrics,
    the updated variables under the port's names)."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.parallel.mesh import (make_mesh, replicate_tree,
                                                   shard_batch)
    from forwardtacotron_tpu.train.forward_trainer import \
        ForwardTrainer as JaxTrainer
    from forwardtacotron_tpu.train.state import \
        create_train_state as jax_train_state
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    job, variables, batch = _forward_job(tmp_path_factory.mktemp('jax'),
                                         'float32', 2)
    config = job['config']
    jmodel, _, _ = both_models(config)
    jax_mesh = make_mesh(n_data=2)
    trainer = JaxTrainer(JaxPaths.from_config(config), None, config,
                         mesh=jax_mesh)
    state = replicate_tree(jax_train_state(
        jax.tree.map(jnp.asarray, variables), trainer.tx), jax_mesh)
    batch = dict(batch, pitch_target=batch['pitch'].copy(),
                 energy_target=batch['energy'].copy())
    batch.pop('pitch_cond')
    state, metrics = run_jax_step(
        trainer._build_train_step(jmodel), state,
        shard_batch(batch, jax_mesh), jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            from_jax_variables({'params': state.params,
                                'batch_stats': state.batch_stats}))


@pytest.mark.parametrize('world', [2, 4])
def test_forward_trainer_ranks_match_jax_mesh_step(tmp_path, jax_mesh_step,
                                                   world):
    job, _, global_batch = _forward_job(tmp_path, 'float32', world)
    results = launch(job, tmp_path)
    assert_ranks_agree(results)
    got = results[0]
    # every rank padded to the global batch's shape
    assert [s[1:] for s in got['shape']] == [global_batch['x'].shape[1:],
                                             global_batch['mel'].shape[1:]]
    want_metrics, want_state = jax_mesh_step
    for key in LOSSES + ('loss',):
        scaled_close(np.float32(got['metrics'][key]), want_metrics[key], F32_TOL, 1.0,
                     key)
    assert_step_close(got['state'], want_state, False, 'jax')
    # the port's one-process step on the global batch
    (metrics,), state, _, _ = train_steps(job, global_batch, 'cpu')
    for key in LOSSES + ('loss',):
        scaled_close(np.float32(got['metrics'][key]), metrics[key], F32_TOL, 1.0, key)
    assert got['metrics']['grad_norm'] == pytest.approx(
        metrics['grad_norm'], rel=1e-5)
    assert_step_close(got['state'], state, False, 'one process')


@pytest.mark.parametrize('kind', ['forward_bf16', 'multi', 'taco'])
def test_two_ranks_match_one_process(tmp_path, kind):
    if kind == 'forward_bf16':
        job, _, global_batch = _forward_job(tmp_path, 'bfloat16', 2, seed=2)
    elif kind == 'multi':
        config = family_config('multi_forward_tacotron', 'float32', tmp_path)
        _, _, tmodel = family_models(config)
        dims = config['multi_forward_tacotron']['model']['speaker_emb_dims']
        batches, global_batch = shares(
            make_items(4, 3, N_MELS, speaker_dims=dims), 2)
        job = {'trainer': 'multi', 'config': config, 'device': 'cpu',
               'state_dict': tmodel.state_dict(), 'batches': batches}
    else:
        from forwardtacotron_torch.models.tacotron import Tacotron
        from test_torch_tacotron import teacher_config
        config = teacher_config(tmp_path)
        torch.manual_seed(4)
        keys = ('x', 'mel', 'mel_len', 'x_len')
        batches, global_batch = shares(make_items(4, 5, N_MELS), 2)
        batches = [{k: b[k] for k in keys} for b in batches]
        global_batch = {k: global_batch[k] for k in keys}
        job = {'trainer': 'taco', 'config': config, 'device': 'cpu', 'r': 2,
               'state_dict': Tacotron.from_config(config).state_dict(),
               'batches': batches}
    results = launch(job, tmp_path)
    assert_ranks_agree(results)
    got = results[0]
    (metrics,), state, _, _ = train_steps(job, global_batch, 'cpu')
    mp = kind == 'forward_bf16'
    for key in metrics:
        if key != 'grad_norm':
            scaled_close(np.float32(got['metrics'][key]), metrics[key],
                         BF16_TOL if mp else F32_TOL, 1.0, key)
    assert got['metrics']['grad_norm'] == pytest.approx(
        metrics['grad_norm'], rel=5e-2 if mp else 1e-5)
    assert_step_close(got['state'], state, mp, kind)


@pytest.mark.parametrize('kind', ['forward', 'multi'])
def test_rank_zero_plots_leave_the_ranks_alone(tmp_path, kind):
    """Only rank 0 plots, and its teacher-forced forward must issue no
    collective that the other rank would have to match: with
    ``plot_every: 1`` both ranks finish (a stray collective hangs them
    into the timeout or shifts every later one) with the parameters,
    BatchNorm statistics and metrics of the run without plots, bit for
    bit."""
    if kind == 'forward':
        job, _, _ = _forward_job(tmp_path, 'float32', 2)
    else:
        config = family_config('multi_forward_tacotron', 'float32', tmp_path)
        _, _, tmodel = family_models(config)
        dims = config['multi_forward_tacotron']['model']['speaker_emb_dims']
        batches, _ = shares(make_items(4, 3, N_MELS, speaker_dims=dims), 2)
        job = {'trainer': 'multi', 'config': config, 'device': 'cpu',
               'state_dict': tmodel.state_dict(), 'batches': batches}
    job['steps'] = 2
    results = launch({'jobs': [job, dict(job, plot_every=1)],
                      'device': 'cpu'}, tmp_path, timeout=120)
    for without, with_plots in results:
        assert with_plots['step_metrics'] == without['step_metrics']
        for key, value in without['last_state'].items():
            assert torch.equal(with_plots['last_state'][key], value), key
    assert_ranks_agree([r[1] for r in results])


def _torchrun(args, tmp_path, timeout=240):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2``
    of ``args`` in its own process group, killed whole on timeout."""
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', '2'] + args
    log = tmp_path / 'torchrun.log'
    with open(log, 'w') as out:
        proc = subprocess.Popen(cmd, cwd=str(REPO), stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True,
                                env=dict(os.environ, OMP_NUM_THREADS='1'))
        try:
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return proc.returncode, log.read_text()


@pytest.mark.usefixtures('no_tensorboard')
def test_train_forward_under_torchrun_checkpoints_once_and_resumes(
        tmp_path, capsys):
    from forwardtacotron_torch import train_forward
    from forwardtacotron_torch.utils.checkpoints import (checkpoint_step,
                                                         restore_checkpoint)

    config = read_config('tests/resources/test_config.yaml')
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    paths = write_dataset(config)
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.dump(config))
    code, log = _torchrun(['-m', 'forwardtacotron_torch.train_forward',
                           '--config', str(path), '--device', 'cpu'],
                          tmp_path)
    assert code == 0, log
    # the one-process run's files (tests/test_torch_trainer.py), once
    ckpt_dir = paths.forward_checkpoints
    assert sorted(p.name for p in ckpt_dir.glob('*.pt*')) == [
        'forward_step0k.pt', 'latest_model.pt']
    ckpt = restore_checkpoint(ckpt_dir)
    assert checkpoint_step(ckpt) == 6 and int(ckpt['optim']['count']) == 6
    metrics = (paths.forward_log / 'metrics.csv').read_text().splitlines()
    losses = [float(line.split(',')[2]) for line in metrics
              if ',Mel_Loss/train,' in line]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert log.count('Ranks: 2') == 1    # rank 0 alone prints
    # one process resumes the world's checkpoint and trains on
    config['forward_tacotron']['training']['schedule'] = ['1e-3, 8, 2']
    path.write_text(yaml.dump(config))
    train_forward.main(['--config', str(path), '--device', 'cpu'])
    assert 'Restored checkpoint at step 6' in capsys.readouterr().out
    ckpt = restore_checkpoint(ckpt_dir)
    assert checkpoint_step(ckpt) == 8 and int(ckpt['optim']['count']) == 8


def test_train_tacotron_extraction_modes_refuse_a_world(tmp_path):
    """Under a world of 2 the extraction modes stop with a usage error
    (exit code 2; the first rank to stop may see the other killed)."""
    log_dir = tmp_path / 'logs'
    log_dir.mkdir()
    with pytest.raises(RuntimeError) as err:
        run_ranks([sys.executable, '-m',
                   'forwardtacotron_torch.train_tacotron', '--config',
                   'tests/resources/test_config.yaml', '--device', 'cpu',
                   '--force_align'], 2, log_dir, timeout=120)
    codes = str(err.value).split(']')[0]
    assert codes.startswith('ranks exited [') and '2' in codes, codes
    assert set(codes[len('ranks exited ['):].split(', ')) <= {'2', '-9'}
    assert 'run in one process' in str(err.value)
