"""The port's trainer against the JAX package's (tests/torch_training_setup.py
builds the same narrow model in both):

- one full optimizer step of ``ForwardTrainer`` against the JAX package's
  ``ForwardTrainer._build_train_step`` (global-norm clip + Adam), float32
  and bf16;
- the optimizer alone against the JAX package's optax chain on the same
  gradients;
- ``ForwardTrainer.train`` on a synthetic dataset on the CPU (through
  ``python -m forwardtacotron_torch.train_forward``): checkpoints, a resume
  that is a no-op, and a ``gen_forward`` load of what it wrote.

Tolerances: float32, losses 1e-4 of the scale, the updated parameters
1e-5 relative plus 1e-2 of the learning rate absolute (Adam divides by
|g| + 1e-8, so a gradient near that scale turns a rounding difference into
a visible one). A gradient element smaller than the two packages' float32
disagreement (about 2e-5 of its tensor's largest) has no reliable sign,
which Adam's first step (about lr * sign(g)) turns into opposite moves:
56 of 1.6 million elements in this test; at most 0.5% may differ, by at
most 2 lr. The optimizer alone, on the same gradients: 1e-6. bfloat16:
losses and BatchNorm statistics within 5e-2 of the scale, and the updates
within a tenth of the learning rate on average over all parameters
(measured 0.058 lr).
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.models.registry import \
    init_tts_model as torch_init_tts_model
from forwardtacotron_torch.train.common import cast_floats, masked_l1
from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
from forwardtacotron_torch.train.state import create_train_state
from forwardtacotron_torch.utils.convert import from_jax_variables
from forwardtacotron_torch.utils.files import read_config

from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)
from torch_training_setup import (  # noqa: F401 (jax_kernels, no_tensorboard: fixtures)
    LOSSES, both_models, jax_kernels, make_batch, narrow_config,
    no_tensorboard, paths_of, scaled_close, write_dataset)


@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
def test_optimizer_step_matches_jax_trainer(jax_kernels, tmp_path,
                                            precision):
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.parallel.mesh import make_mesh
    from forwardtacotron_tpu.train.forward_trainer import \
        ForwardTrainer as JaxTrainer
    from forwardtacotron_tpu.train.state import \
        create_train_state as jax_train_state
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    config = narrow_config(precision, tmp_path)
    jmodel, variables, tmodel = both_models(config)
    batch = make_batch(seed=1)
    lr = 1e-3

    jtrainer = JaxTrainer(JaxPaths.from_config(config), None, config,
                          mesh=make_mesh(n_data=1))
    jstate = jax_train_state(jax.tree.map(jnp.asarray, variables),
                             jtrainer.tx)
    jstate, jmetrics = jtrainer._build_train_step(jmodel)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))

    trainer = ForwardTrainer(paths_of(config), None, config, device='cpu')
    state = create_train_state(tmodel, trainer.tx)
    metrics = trainer.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert state.step == 1 and int(state.opt_state['count']) == 1

    mp = precision == 'bfloat16'
    for key in LOSSES + ('loss',):
        scaled_close(metrics[key], jmetrics[key], 5e-2 if mp else 1e-4,
                      1.0, key)
    want = from_jax_variables({'params': jstate.params,
                               'batch_stats': jstate.batch_stats})
    got = tmodel.state_dict()
    diffs, n_far, n_all = [], 0, 0
    for name, w_new in want.items():
        if name.endswith('num_batches_tracked'):
            continue
        g_new = got[name].float()
        if name.endswith(('running_mean', 'running_var')):
            scaled_close(g_new, w_new.numpy(), 5e-2 if mp else 1e-4, 1.0,
                          name)
        elif mp:
            diffs.append((g_new - w_new).abs().flatten())
        else:
            g_new, w_new = g_new.numpy(), w_new.numpy()
            far = ~np.isclose(g_new, w_new, rtol=1e-5, atol=1e-2 * lr)
            n_far, n_all = n_far + int(far.sum()), n_all + far.size
            assert np.abs(g_new - w_new).max() <= 2.001 * lr, name
    if mp:
        assert float(torch.cat(diffs).mean()) <= 0.1 * lr
    else:
        assert n_far <= 5e-3 * n_all, (n_far, n_all)


@pytest.mark.usefixtures('no_tensorboard')
def test_trainer_runs_checkpoints_resumes_and_serves(tmp_path):
    import yaml

    from forwardtacotron_torch import gen_forward, train_forward
    from forwardtacotron_torch.train.state import state_from_checkpoint
    from forwardtacotron_torch.utils.checkpoints import (
        checkpoint_step, init_tts_model_from_checkpoint, restore_checkpoint)

    config = read_config('tests/resources/test_config.yaml')
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    paths = write_dataset(config)
    config_path = tmp_path / 'config.yaml'
    config_path.write_text(yaml.dump(config))

    train_forward.main(['--config', str(config_path), '--device', 'cpu'])
    ckpt_dir = paths.forward_checkpoints
    assert sorted(p.name for p in ckpt_dir.glob('*.pt')) == [
        'forward_step0k.pt', 'latest_model.pt']
    ckpt = restore_checkpoint(ckpt_dir)
    assert checkpoint_step(ckpt) == 6        # the schedule's max_step
    assert int(ckpt['optim']['count']) == 6
    assert ckpt['config']['tts_model'] == 'forward_tacotron'
    metrics = (paths.forward_log / 'metrics.csv').read_text().splitlines()
    losses = [float(line.split(',')[2]) for line in metrics
              if ',Mel_Loss/train,' in line]
    assert len(losses) == 6 and np.isfinite(losses).all()

    # resume: the schedule is complete, so training again is a no-op
    model = torch_init_tts_model(config)
    trainer = ForwardTrainer(paths, None, config, device='cpu')
    state = state_from_checkpoint(model, trainer.tx, ckpt)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    state = trainer.train(model, state=state)
    assert state.step == 6
    for k, v in model.state_dict().items():
        assert torch.equal(v, weights[k]), k

    # the checkpoint serves: gen_forward loads it and writes a wav
    loaded, _ = init_tts_model_from_checkpoint(ckpt_dir / 'latest_model.pt')
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, weights[k]), k
    text = tmp_path / 'text.txt'
    text.write_text('hello there.\n', encoding='utf-8')
    out = tmp_path / 'out'
    gen_forward.main(['--checkpoint', str(ckpt_dir / 'latest_model.pt'),
                      '--text_file', str(text), '--output', str(out),
                      '--device', 'cpu'])
    assert [w.name for w in out.glob('*.wav')] == ['1_forward_0k_alpha1.0.wav']


def test_cast_floats_and_masked_l1():
    """cast_floats leaves integer tensors alone; masked_l1 averages over
    the valid prefix only (reference MaskedL1)."""
    batch = {'x': torch.ones(2, 3, dtype=torch.long),
             'mel': torch.ones(2, 3), 'name': 'a'}
    cast = cast_floats(batch, torch.bfloat16)
    assert cast['x'].dtype == torch.long and cast['name'] == 'a'
    assert cast['mel'].dtype == torch.bfloat16
    x = torch.tensor([[1.0, 2.0, 100.0], [3.0, 100.0, 100.0]])
    loss = masked_l1(x, torch.zeros_like(x), torch.tensor([2, 1]))
    assert float(loss) == pytest.approx((1 + 2 + 3) / 3)


def test_optimizer_matches_optax():
    """The port's clip + Adam against the JAX package's optax chain
    (``make_optimizer``) on the same gradients: three steps, a learning
    rate change that keeps the moments, the clip active (global norm above
    1) and inactive."""
    import jax.numpy as jnp

    from forwardtacotron_tpu.train.state import \
        make_optimizer as jax_make_optimizer
    from forwardtacotron_tpu.train.state import \
        set_learning_rate as jax_set_lr
    from forwardtacotron_torch.train.state import (TrainState,
                                                   make_optimizer,
                                                   set_learning_rate)

    rs = np.random.RandomState(0)
    shapes = {'a': (5, 3), 'b': (7,), 'c': (2, 2, 2)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rs.randn(*s)).astype(np.float32)
              for k, s in shapes.items()} for scale in (2.0, 0.01, 1e-9)]
    tx = jax_make_optimizer(1e-3, 1.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    class _S:   # the JAX set_learning_rate acts on state.opt_state
        def __init__(self, o):
            self.opt_state = o

        def replace(self, opt_state):
            return _S(opt_state)

    jopt = tx.init(jparams)
    opt = make_optimizer(1e-3, 1.0)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = TrainState(model=None, opt_state=opt.init(tparams), step=0)
    for i, g in enumerate(grads):
        lr = 1e-3 if i < 2 else 3e-4
        jopt = jax_set_lr(_S(jopt), lr).opt_state
        set_learning_rate(state, lr)
        upd, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                              jopt, jparams)
        jparams = {k: jparams[k] + upd[k] for k in jparams}
        opt.step(tparams, {k: torch.from_numpy(v) for k, v in g.items()},
                 state.opt_state)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f'step {i} {k}')
    adam = jopt[1].inner_state[0]           # optax's ScaleByAdamState
    assert int(state.opt_state['count']) == int(adam.count) == 3
    for k in shapes:
        np.testing.assert_allclose(state.opt_state['mu'][k].numpy(),
                                   np.asarray(adam.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(state.opt_state['nu'][k].numpy(),
                                   np.asarray(adam.nu[k]), rtol=1e-6)
