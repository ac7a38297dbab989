"""Training of FastPitch and the multispeaker models on the port against the
JAX package (tests/torch_training_setup.py builds the same narrow models in
both, from the same seeded variables):

- the pitch-condition cross-entropy (``ignore_index`` 0) and accuracy
  against the JAX package's;
- one full optimizer step of ``MultiForwardTrainer`` (MultiForwardTacotron,
  MultiFastPitch) and of ``ForwardTrainer`` on FastPitch against the JAX
  package's trainers, float32 and bf16: losses (the pitch-condition CE and
  accuracy among them), updated parameters and BatchNorm statistics;
- ``python -m forwardtacotron_torch.train_forward --device cpu`` on a tiny
  multispeaker dataset: a checkpoint that holds the speaker table, a resume
  that is a no-op, and ``gen_forward --speaker`` on what it wrote.

Tolerances as tests/test_torch_trainer.py: float32 losses 1e-4 of the
scale, the updated parameters 1e-5 relative plus 1e-2 of the learning rate
absolute, at most 0.5% of the elements apart (by at most 2 lr: Adam's first
step turns a gradient below the packages' float32 disagreement into a move
of either sign); bfloat16 losses and BatchNorm statistics within 5e-2 of
the scale and the updates within a tenth of the learning rate on average.
The accuracy is a share of tokens: equal in float32, within 5e-2 in bf16.
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.train.common import (classification_accuracy,
                                                masked_cross_entropy)
from forwardtacotron_torch.train.forward_trainer import (ForwardTrainer,
                                                         MultiForwardTrainer)
from forwardtacotron_torch.train.state import create_train_state
from forwardtacotron_torch.utils.convert import from_jax_variables

from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)
from torch_training_setup import (  # noqa: F401 (jax_kernels, no_tensorboard: fixtures)
    LOSSES, NARROW_OF, SPEAKERS, family_config, family_models, jax_kernels,
    make_multi_batch, no_tensorboard, paths_of, run_jax_step, scaled_close,
    write_multi_dataset)


@pytest.mark.parametrize('case', ['mixed', 'all_ignored', 'one_valid'])
def test_cross_entropy_and_accuracy_match_jax(case):
    import jax.numpy as jnp

    from forwardtacotron_tpu.train.common import \
        classification_accuracy as jax_acc
    from forwardtacotron_tpu.train.common import \
        masked_cross_entropy as jax_ce
    rs = np.random.RandomState(len(case))
    logits = (3 * rs.randn(4, 9, 3)).astype(np.float32)
    targets = rs.randint(0, 3, (4, 9))
    if case == 'all_ignored':
        targets[:] = 0
    elif case == 'one_valid':
        targets[:] = 0
        targets[2, 4] = 2
    got_ce = masked_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(targets))
    got_acc = classification_accuracy(torch.from_numpy(logits),
                                      torch.from_numpy(targets))
    want_ce = jax_ce(jnp.asarray(logits), jnp.asarray(targets))
    want_acc = jax_acc(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(got_ce), float(want_ce), rtol=1e-6)
    assert float(got_acc) == pytest.approx(float(want_acc), abs=1e-7)
    if case == 'all_ignored':
        assert float(got_ce) == 0.0 and float(got_acc) == 0.0
    # the ignored class changes nothing: CE over the valid tokens alone
    valid = targets != 0
    if valid.any():
        lp = torch.log_softmax(torch.from_numpy(logits[valid]), -1)
        want = -lp[torch.arange(int(valid.sum())),
                   torch.from_numpy(targets[valid])].mean()
        assert float(got_ce) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize('family', ['multi_forward_tacotron', 'fast_pitch',
                                    'multi_fast_pitch'])
@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
def test_optimizer_step_matches_jax_trainer(jax_kernels, tmp_path, family,
                                            precision, monkeypatch):
    """One train step, clip + Adam, of the port's trainer against the JAX
    package's (``MultiForwardTrainer`` for the multispeaker models, whose
    loss adds 0.1 x the pitch-condition CE). The JAX trainer gets no
    metrics writer: the step does not write, and TensorBoard's would
    import TensorFlow."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.parallel.mesh import make_mesh
    from forwardtacotron_tpu.train import forward_trainer as jax_ft
    from forwardtacotron_tpu.train.forward_trainer import \
        ForwardTrainer as JaxForward
    from forwardtacotron_tpu.train.forward_trainer import \
        MultiForwardTrainer as JaxMulti
    from forwardtacotron_tpu.train.state import \
        create_train_state as jax_train_state
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    multi = family.startswith('multi')
    config = family_config(family, precision, tmp_path)
    jmodel, variables, tmodel = family_models(config)
    batch = make_multi_batch(NARROW_OF[family].get('speaker_emb_dims', 1),
                             seed=1)
    lr = 1e-3
    jcls, tcls = (JaxMulti, MultiForwardTrainer) if multi \
        else (JaxForward, ForwardTrainer)
    monkeypatch.setattr(jax_ft, 'make_writer', lambda log_dir: None)
    jtrainer = jcls(JaxPaths.from_config(config), None, config,
                    mesh=make_mesh(n_data=1))
    jstate = jax_train_state(jax.tree.map(jnp.asarray, variables),
                             jtrainer.tx)
    jstate, jmetrics = run_jax_step(
        jtrainer._build_train_step(jmodel), jstate,
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    trainer = tcls(paths_of(config), None, config, device='cpu')
    assert trainer.train_cfg is config[family]['training']
    state = create_train_state(tmodel, trainer.tx)
    metrics = trainer.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert state.step == 1

    mp = precision == 'bfloat16'
    keys = LOSSES + ('loss',) + (('pitch_cond_loss',) if multi else ())
    assert ('pitch_cond_loss' in metrics) == multi
    for key in keys:
        scaled_close(metrics[key], jmetrics[key], 5e-2 if mp else 1e-4,
                     1.0, key)
    if multi:
        assert float(metrics['pitch_cond_acc']) == pytest.approx(
            float(jmetrics['pitch_cond_acc']), abs=5e-2 if mp else 1e-6)
    want = from_jax_variables({'params': jstate.params,
                               'batch_stats': jstate.batch_stats or {}})
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
@pytest.mark.parametrize('family', ['multi_forward_tacotron',
                                    'multi_fast_pitch'])
def test_multispeaker_train_forward_runs_resumes_and_serves(tmp_path, family):
    """``train_forward`` on a multispeaker config picks
    ``MultiForwardTrainer``: its checkpoints hold the speaker table (each
    speaker's mean embedding) at the top level, as the reference's do; a
    resume at the schedule's end is a no-op, and ``gen_forward --speaker``
    speaks from the checkpoint."""
    import yaml

    from forwardtacotron_torch import gen_forward, train_forward
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.train.state import state_from_checkpoint
    from forwardtacotron_torch.utils.checkpoints import (checkpoint_step,
                                                         restore_checkpoint)
    config = family_config(family, 'float32', tmp_path)
    config['dsp'].update(sample_rate=8000, n_fft=64, hop_length=16,
                         win_length=64, fmin=0, fmax=4000)
    train = config[family]['training']
    train.update(schedule=['1e-3, 4, 2'], checkpoint_every=2,
                 bucket_multiple=8)
    train['filter'].update(max_mel_len=200, filter_duration_stats=False)
    paths = write_multi_dataset(config)
    config_path = tmp_path / 'config.yaml'
    config_path.write_text(yaml.dump(config))

    train_forward.main(['--config', str(config_path), '--device', 'cpu'])
    ckpt_dir = paths.forward_checkpoints
    assert sorted(p.name for p in ckpt_dir.glob('*.pt')) == [
        'forward_step0k.pt', 'latest_model.pt']
    ckpt = restore_checkpoint(ckpt_dir)
    assert checkpoint_step(ckpt) == 4
    table = ckpt['speaker_embeddings']
    assert sorted(table) == list(SPEAKERS)
    for name, emb in table.items():
        np.testing.assert_array_equal(
            emb, np.load(paths.mean_speaker_emb / f'{name}.npy'))
    metrics = (paths.forward_log / 'metrics.csv').read_text().splitlines()
    cond = [float(line.split(',')[2]) for line in metrics
            if ',Pitch_Cond_Loss/train,' in line]
    assert len(cond) == 4 and np.isfinite(cond).all()

    model = init_tts_model(config)
    trainer = MultiForwardTrainer(paths, None, config, device='cpu')
    state = state_from_checkpoint(model, trainer.tx, ckpt)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    assert trainer.train(model, state=state).step == 4
    for k, v in model.state_dict().items():
        assert torch.equal(v, weights[k]), k

    out = tmp_path / 'out'
    gen_forward.main(['--checkpoint', str(ckpt_dir / 'latest_model.pt'),
                      '--input_text', 'hello there.', '--output', str(out),
                      '--speaker', SPEAKERS[1], '--device', 'cpu'])
    assert [w.name for w in out.glob('*.wav')] == [
        '1_forward_0k_alpha1.0.wav']


def test_positional_table_cached_by_inference_serves_training():
    """The positional table is cached per length: one first made by an
    inference call (serving, then training in one process, as
    ``chip_smoke.py`` runs them) is a normal tensor, which autograd may
    save for the gradient of the encoding's scale."""
    from forwardtacotron_torch.models.layers import PositionalEncoding
    enc = PositionalEncoding(8, dropout=0.0)
    x = torch.randn(2, 37, 8)
    with torch.inference_mode():
        want = enc(x)
    enc(x).sum().backward()
    assert enc.scale.grad is not None
    torch.testing.assert_close(enc(x).detach(), want)
