"""The trainers' plots and writers on the port against the JAX package's,
on the CPU at narrow widths:

- ``ForwardTrainer``, ``MultiForwardTrainer`` (three speakers) and
  ``TacoTrainer``: ``plot_outputs`` gives the arrays the JAX
  ``generate_plots`` hands its writer (a recording writer, with the JAX
  module's plot functions patched to pass their arrays through): the
  ground-truth-aligned and generated mels and pitch, each speaker's
  generation, the teacher's attention and mels, and the Griffin-Lim audio
  (4 iterations on both sides, the port given the JAX phase draw through
  ``phase=``). float32: 1e-4 of max(1, max |JAX|); audio 1e-3 of the
  waveform's scale (4 momentum iterations from mels 1e-5 apart);
- ``generate_plots`` through TensorBoard's ``SummaryWriter`` writes an
  image for each of those tags and the audio; ``make_writer`` takes the
  CSV writer when TensorBoard cannot be imported, which drops figures and
  audio;
- plots leave training alone: 3 steps with a plot after each end with
  parameters, BatchNorm statistics and optimizer state bit-equal to the
  same 3 steps without plots (dropout and zoneout on), for the forward
  trainer and the teacher.
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.dsp.dsp import DSP
from forwardtacotron_torch.models.registry import \
    init_tts_model as torch_init_tts_model
from forwardtacotron_torch.models.tacotron import Tacotron
from forwardtacotron_torch.train import forward_trainer
from forwardtacotron_torch.train.common import TTSSession
from forwardtacotron_torch.train.state import create_train_state
from forwardtacotron_torch.train.taco_trainer import TacoTrainer
from forwardtacotron_torch.utils.files import read_config

from torch_training_setup import (  # noqa: F401 (no_tensorboard: a fixture)
    N_MELS, _random_variables, both_models, family_config, family_models,
    narrow_config, no_tensorboard, paths_of, scaled_close, write_dataset,
    write_multi_dataset)

F32_TOL = 1e-4
GL_ITERS = 4
TEACHER_NARROW = dict(embed_dims=16, encoder_dims=128, decoder_dims=32,
                      lstm_dims=32, postnet_dims=16, encoder_k=4,
                      postnet_k=3, num_highways=2, speaker_emb_dim=16)


class Recorder:
    """A writer that keeps what it is given."""

    def __init__(self):
        self.figures, self.audio = {}, {}

    def add_scalar(self, *args, **kwargs):
        pass

    def add_figure(self, tag, fig, step):
        self.figures[tag] = np.asarray(fig)

    def add_audio(self, tag, wav, step, sample_rate):
        self.audio[tag] = np.asarray(wav)[0]


class JaxGL:
    """The JAX DSP's Griffin-Lim at GL_ITERS iterations (its seed-0
    draw)."""

    def __init__(self, dsp):
        self.dsp, self.sample_rate = dsp, dsp.sample_rate

    def griffinlim(self, mel):
        return self.dsp.griffinlim(mel, n_iter=GL_ITERS, seed=0)


class PortGL(JaxGL):
    """The port's Griffin-Lim given the JAX seed-0 phase draw."""

    def griffinlim(self, mel):
        import jax
        import jax.numpy as jnp
        bins = self.dsp.n_fft // 2 + 1
        phase = np.asarray(2.0 * jnp.pi * jax.random.uniform(
            jax.random.PRNGKey(0), (bins, mel.shape[1])))
        return self.dsp.griffinlim(mel, n_iter=GL_ITERS, phase=phase)


def _sessions(config, r, taco=False):
    """(JAX session, port session) on the same data, batch 3."""
    from forwardtacotron_tpu.data import dataset as jdata
    from forwardtacotron_tpu.train.common import TTSSession as JaxSession
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    from forwardtacotron_torch.data import dataset as tdata

    section = config['tacotron' if taco else config.get(
        'tts_model', 'forward_tacotron')]['training']
    filters = dict(section['filter'], filter_duration_stats=False)
    kw = {'r': r} if taco else {}
    jload = jdata.get_taco_dataloaders if taco \
        else jdata.get_forward_dataloaders
    tload = tdata.get_taco_dataloaders if taco \
        else tdata.get_forward_dataloaders
    jsets = jload(JaxPaths.from_config(config), batch_size=3, **kw, **filters)
    tsets = tload(paths_of(config), batch_size=3, seed=0, **kw, **filters)
    return (JaxSession(1, r, 1e-3, 10, 3, *jsets),
            TTSSession(1, r, 1e-3, 10, 3, *tsets))


def _compare(arrays, rec, kinds):
    want_tags = sorted(rec.figures)
    got_tags = sorted(t for k in kinds for t in arrays[k])
    assert got_tags == want_tags
    for kind in kinds:
        for tag, arr in arrays[kind].items():
            scaled_close(arr, rec.figures[tag], F32_TOL, 1.0, tag)
    assert sorted(arrays['audio']) == sorted(rec.audio)
    for tag, wav in arrays['audio'].items():
        want = rec.audio[tag]
        assert wav.shape == want.shape, tag
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(wav, want, atol=1e-3 * scale, rtol=0,
                                   err_msg=tag)


def _event_tags(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(log_dir), size_guidance={
        'images': 0, 'audio': 0, 'scalars': 0})
    acc.Reload()
    return acc.Tags()


@pytest.mark.parametrize('family', ['forward_tacotron',
                                    'multi_forward_tacotron'])
def test_forward_plots_match_jax(family, tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.dsp.dsp import DSP as JaxDSP
    from forwardtacotron_tpu.parallel.mesh import make_mesh
    from forwardtacotron_tpu.train import forward_trainer as jft
    from forwardtacotron_tpu.train.state import \
        create_train_state as jax_train_state
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    if family == 'forward_tacotron':
        config = narrow_config('float32', tmp_path)
        jmodel, variables, tmodel = both_models(config)
        write_dataset(config)
        jcls, tcls = jft.ForwardTrainer, forward_trainer.ForwardTrainer
    else:
        config = family_config(family, 'float32', tmp_path)
        jmodel, variables, tmodel = family_models(config)
        write_multi_dataset(config)
        jcls = jft.MultiForwardTrainer
        tcls = forward_trainer.MultiForwardTrainer
    for name in ('plot_mel', 'plot_pitch'):
        monkeypatch.setattr(jft, name, np.asarray)
    jsession, session = _sessions(config, 1)

    rec = Recorder()
    jtrainer = jcls(JaxPaths.from_config(config),
                    JaxGL(JaxDSP.from_config(config)), config,
                    mesh=make_mesh(n_data=1))
    jtrainer.writer = rec
    jtrainer.generate_plots(jmodel, jax_train_state(
        jax.tree.map(jnp.asarray, variables), jtrainer.tx), jsession)

    trainer = tcls(paths_of(config),
                   PortGL(DSP.from_config(config, device='cpu')), config,
                   device='cpu')
    state = create_train_state(tmodel, trainer.tx)
    arrays = trainer.plot_outputs(state, session)
    _compare(arrays, rec, ('mel', 'pitch'))
    if family != 'forward_tacotron':
        assert sorted(t for t in arrays['mel'] if 'Speakers' in t) == [
            'Generated_Speakers/spk0', 'Generated_Speakers/spk1',
            'Generated_Speakers/spk2']

    # through TensorBoard: an image for each figure, the audio
    pytest.importorskip('matplotlib')
    assert type(trainer.writer).__name__ == 'SummaryWriter'
    trainer.generate_plots(state, session)
    trainer.writer.flush()
    tags = _event_tags(paths_of(config).forward_log)
    assert sorted(tags['images']) == sorted(rec.figures)
    assert sorted(tags['audio']) == sorted(rec.audio)


def _teacher_config(tmp_path):
    config = read_config('configs/singlespeaker.yaml')
    config['dsp']['num_mels'] = N_MELS
    config['tacotron']['model'].update(TEACHER_NARROW)
    config['tacotron']['training']['schedule'] = ['2, 1e-3, 3, 3']
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    return config


def _teacher_data(config):
    """``write_dataset`` with 16-wide speaker embeddings."""
    paths = write_dataset(config)
    rs = np.random.RandomState(5)
    for f in paths.speaker_emb.glob('*.npy'):
        np.save(f, rs.rand(16).astype(np.float32))
    return paths


def test_teacher_plots_match_jax(tmp_path, monkeypatch):
    import jax

    from forwardtacotron_tpu.dsp.dsp import DSP as JaxDSP
    from forwardtacotron_tpu.models import tacotron as jax_tacotron
    from forwardtacotron_tpu.parallel.mesh import make_mesh
    from forwardtacotron_tpu.train import taco_trainer as jtt
    from forwardtacotron_tpu.train.state import \
        create_train_state as jax_train_state
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    from forwardtacotron_torch.utils.convert import from_jax_variables

    monkeypatch.setattr(jax_tacotron, 'DECODER_SCAN_UNROLL', 1)
    for name in ('plot_mel', 'plot_attention'):
        monkeypatch.setattr(jtt, name, np.asarray)
    config = _teacher_config(tmp_path)
    _teacher_data(config)
    jmodel = jax_tacotron.Tacotron.from_config(config)
    rs = np.random.RandomState(1)
    probe = {'x': jax.numpy.asarray(rs.randint(1, 40, (2, 7))),
             'mel': jax.numpy.zeros((2, 8, N_MELS)),
             'speaker_emb': jax.numpy.zeros((2, 16))}
    variables = _random_variables(jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        probe, r=2, train=False)), seed=6)
    jsession, session = _sessions(config, 2, taco=True)

    rec = Recorder()
    jtrainer = jtt.TacoTrainer(JaxPaths.from_config(config),
                               JaxGL(JaxDSP.from_config(config)), config,
                               mesh=make_mesh(n_data=1))
    jtrainer.writer = rec
    jtrainer.generate_plots(jmodel, jax_train_state(variables, jtrainer.tx),
                            jsession)

    model = Tacotron.from_config(config)
    model.load_state_dict(from_jax_variables(variables), strict=False)
    trainer = TacoTrainer(paths_of(config),
                          PortGL(DSP.from_config(config, device='cpu')),
                          config, device='cpu')
    arrays = trainer.plot_outputs(create_train_state(model, trainer.tx),
                                  session)
    _compare(arrays, rec, ('attention', 'mel'))
    assert arrays['attention']['Attention/teacher_forced'].shape[0] == \
        int(session.val_sample['mel_len'][0]) // 2


def test_make_writer_tensorboard_then_csv(tmp_path, request):
    pytest.importorskip('tensorboard')
    pytest.importorskip('matplotlib')
    rs = np.random.RandomState(0)
    arrays = {'mel': {'Mel/a': rs.randn(16, 30)},
              'pitch': {'Pitch/b': rs.randn(12)},
              'attention': {'Attention/c': rs.rand(30, 12)},
              'audio': {'Audio/d': rs.randn(4000).astype(np.float32)}}
    writer = forward_trainer.make_writer(tmp_path / 'tb')
    assert type(writer).__name__ == 'SummaryWriter'
    forward_trainer.write_plots(writer, arrays, 7, 22050)
    writer.add_scalar('Loss/train', 0.5, 7)
    writer.flush()
    tags = _event_tags(tmp_path / 'tb')
    assert sorted(tags['images']) == ['Attention/c', 'Mel/a', 'Pitch/b']
    assert tags['audio'] == ['Audio/d'] and tags['scalars'] == ['Loss/train']

    request.getfixturevalue('no_tensorboard')
    (tmp_path / 'csv').mkdir()
    writer = forward_trainer.make_writer(tmp_path / 'csv')
    assert isinstance(writer, forward_trainer.CsvWriter)
    forward_trainer.write_plots(writer, arrays, 7, 22050)
    writer.add_scalar('Loss/train', 0.5, 7)
    assert [p.name for p in (tmp_path / 'csv').iterdir()] == ['metrics.csv']
    assert (tmp_path / 'csv' / 'metrics.csv').read_text() == \
        '7,Loss/train,0.5\n'


@pytest.mark.usefixtures('no_tensorboard')
@pytest.mark.parametrize('kind', ['forward', 'teacher'])
def test_plots_leave_training_alone(kind, tmp_path, monkeypatch):
    """3 steps with plot_every 1 against 3 steps without plots, dropout
    (and the teacher's zoneout, the forward trainer's pitch zoneout) on:
    every parameter, BatchNorm statistic and optimizer moment bit-equal;
    each plot written (``write_plots`` called after every step)."""
    written = []
    real = forward_trainer.write_plots
    monkeypatch.setattr(forward_trainer, 'write_plots',
                        lambda *a: written.append(a[2]) or real(*a))
    if kind == 'teacher':
        from forwardtacotron_torch.train import taco_trainer
        monkeypatch.setattr(taco_trainer, 'write_plots',
                            lambda *a: written.append(a[2]) or real(*a))
        config = _teacher_config(tmp_path)
        _teacher_data(config)
        section = config['tacotron']['training']
    else:
        config = narrow_config('float32', tmp_path)
        for key in config['forward_tacotron']['model']:
            if key.endswith('_dropout'):
                config['forward_tacotron']['model'][key] = 0.3
        section = config['forward_tacotron']['training']
        section['pitch_zoneout'] = 0.2
        write_dataset(config)
    dsp = DSP.from_config(config, device='cpu')
    runs = {}
    for plot_every in (10 ** 9, 1):
        section['plot_every'] = plot_every
        torch.manual_seed(3)
        if kind == 'teacher':
            model = Tacotron.from_config(config)
            trainer = TacoTrainer(paths_of(config), dsp, config,
                                  device='cpu')
            session = _sessions(config, 2, taco=True)[1]
        else:
            model = torch_init_tts_model(config)
            trainer = forward_trainer.ForwardTrainer(paths_of(config), dsp,
                                                     config, device='cpu')
            session = _sessions(config, 1)[1]
        session.max_step = 3
        state = create_train_state(model, trainer.tx)
        trainer.train_session(state, session, seed=0)
        runs[plot_every] = (state, {k: v.clone() for k, v in
                                    model.state_dict().items()})
    assert written == [1, 2, 3]
    (s0, sd0), (s1, sd1) = runs[10 ** 9], runs[1]
    assert s0.step == s1.step == 3
    assert sorted(sd0) == sorted(sd1)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for name in ('mu', 'nu'):
        for k, v in s0.opt_state[name].items():
            assert torch.equal(v, s1.opt_state[name][k]), (name, k)
    assert torch.equal(s0.opt_state['count'], s1.opt_state['count'])
