"""The port's remaining entry points and utils against the JAX package's,
on the CPU at narrow widths:

- ``python -m forwardtacotron_torch.train_forward --force_gta --device
  cpu`` from a port checkpoint writes every train and val item, each equal
  to the JAX model's ``apply(variables, batch, train=False)['mel_post']``
  on the same batches, cropped (f32: 1e-4 of max(1, max |JAX|)); the CLI
  refuses a world of more than one rank;
- the notebook ``Synthesizer`` on a reference-format ``.pt``: its
  ``synthesize_mel`` equals the JAX ``Synthesizer``'s (single speaker and
  a multispeaker model in a named voice), and its Griffin-Lim wav is
  (frames - 1) x hop long;
- ``utils.profiler``: ``ThroughputMeter.report`` equals JAX's under a
  patched clock, ``trace`` writes a trace naming an ``annotate`` span,
  ``device_memory_stats('cpu')`` is None;
- ``utils.display`` prints what the JAX package's prints, and
  ``utils.files.save_config`` writes its file.
"""

import time

import numpy as np
import pytest
import torch
import yaml

from forwardtacotron_torch.utils.checkpoints import save_checkpoint

from torch_training_setup import (QUICK_COMPILE, both_models, family_config,
                                  family_models, narrow_config, scaled_close,
                                  speaker_table, write_dataset)

F32_TOL = 1e-4


def test_force_gta_writes_the_jax_eval_forward(tmp_path):
    """6 train and 2 val items: one batch of each at the export's batch of
    8, so every file is the same whatever order the loader draws."""
    import jax

    from forwardtacotron_tpu.data.dataset import \
        get_forward_dataloaders as jax_loaders
    from forwardtacotron_tpu.utils.paths import Paths as JaxPaths

    from forwardtacotron_torch import train_forward

    config = narrow_config('float32', tmp_path)
    config['forward_tacotron']['training']['filter'][
        'filter_duration_stats'] = False
    jmodel, variables, tmodel = both_models(config)
    paths = write_dataset(config)
    save_checkpoint(paths.forward_checkpoints / 'latest_model.pt', tmodel,
                    config, step=3)
    cfg_path = tmp_path / 'config.yaml'
    cfg_path.write_text(yaml.dump(config))
    train_forward.main(['--config', str(cfg_path), '--device', 'cpu',
                        '--force_gta'])
    got = {p.stem: np.load(p) for p in paths.gta.glob('*.npy')}
    assert sorted(got) == [f'item{i}' for i in range(8)]
    assert not list(paths.forward_checkpoints.glob('forward_step*'))

    filters = config['forward_tacotron']['training']['filter']
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False)['mel_post'])
    n = 0
    for loader in jax_loaders(JaxPaths.from_config(config), batch_size=8,
                              **filters):
        for batch in loader:
            arrays = {k: v for k, v in batch.items()
                      if isinstance(v, np.ndarray)}
            mel_post = np.asarray(apply.lower(variables, arrays).compile(
                QUICK_COMPILE)(variables, arrays))
            for j, item_id in enumerate(batch['item_id']):
                want = mel_post[j, :int(batch['mel_len'][j])].T
                assert got[item_id].shape == want.shape == (
                    config['dsp']['num_mels'], int(batch['mel_len'][j]))
                scaled_close(got[item_id], want, F32_TOL, 1.0, item_id)
                n += 1
    assert n == 8


def test_force_gta_refuses_a_world(monkeypatch, tmp_path):
    """Above one rank ``--force_gta`` stops with a usage error (exit code
    2) before it reads anything, as train_tacotron's extraction modes do."""
    from forwardtacotron_torch import train_forward
    from forwardtacotron_torch.parallel import mesh

    left = []
    monkeypatch.setattr(mesh, 'initialize_distributed', lambda device: True)
    monkeypatch.setattr(mesh, 'process_count', lambda: 2)
    monkeypatch.setattr(torch.distributed, 'destroy_process_group',
                        lambda: left.append(True))
    with pytest.raises(SystemExit) as stop:
        train_forward.main(['--config', str(tmp_path / 'missing.yaml'),
                            '--device', 'cpu', '--force_gta'])
    assert stop.value.code == 2 and left == [True]


@pytest.mark.parametrize('family', ['forward_tacotron',
                                    'multi_forward_tacotron'])
def test_synthesizer_matches_jax(family, tmp_path):
    from forwardtacotron_tpu.notebook_utils.synthesize import \
        Synthesizer as JaxSynthesizer

    from forwardtacotron_torch.notebook_utils.synthesize import Synthesizer

    if family == 'forward_tacotron':
        config = narrow_config('float32', tmp_path)
        _, _, model = both_models(config)
        meta, speaker = None, None
    else:
        config = family_config(family, 'float32', tmp_path)
        _, _, model = family_models(config)
        dims = config[family]['model']['speaker_emb_dims']
        meta = {'speaker_embeddings': {
            f'spk{i}': e for i, e in enumerate(speaker_table(3, dims, 4))}}
        speaker = 'spk1'
    path = tmp_path / 'model.pt'
    save_checkpoint(path, model, config, step=0, meta=meta)
    text = 'hello there, this is a test.'
    synth = Synthesizer(str(path), device='cpu')
    jsynth = JaxSynthesizer(str(path))    # one instance: one compile
    mel = synth.synthesize_mel(text, speaker=speaker)
    want = np.asarray(jsynth.synthesize_mel(text, speaker=speaker))
    assert mel.shape == want.shape and mel.shape[1] > 10
    scaled_close(mel, want, F32_TOL, 1.0, 'mel_post')
    if meta:    # no name: the table's first speaker, as in JAX
        scaled_close(synth.synthesize_mel(text),
                     np.asarray(jsynth.synthesize_mel(text)), F32_TOL, 1.0,
                     'first speaker')
    wav = synth(text, speaker=speaker)
    # Griffin-Lim's inverse STFT: a hop per frame after the first
    assert wav.shape == ((mel.shape[1] - 1) * config['dsp']['hop_length'],)
    assert np.isfinite(wav).all()


def test_throughput_meter_matches_jax(monkeypatch):
    from forwardtacotron_tpu.utils.profiler import \
        ThroughputMeter as JaxMeter

    from forwardtacotron_torch.utils.profiler import ThroughputMeter

    clock = [100.0]
    monkeypatch.setattr(time, 'time', lambda: clock[0])
    meters = [ThroughputMeter(hop_length=275, sample_rate=22050),
              JaxMeter(hop_length=275, sample_rate=22050)]
    for m in meters:        # the field's factory holds the unpatched clock
        m._t0 = clock[0]
    reports = []
    for step in range(3):
        for m in meters:
            m.add(frames=1000 + step, tokens=70, steps=2)
        clock[0] += 1.5
        reports.append([m.report(reset=step != 1) for m in meters])
    for got, want in reports:
        assert got == want
    assert reports[0][0]['steps_per_s'] == pytest.approx(2 / 1.5)


def test_trace_annotate_and_memory_stats(tmp_path):
    import json

    from forwardtacotron_torch.utils.profiler import (annotate,
                                                      device_memory_stats,
                                                      trace)

    with trace(tmp_path / 'off', enabled=False):
        torch.ones(3).sum()
    assert not (tmp_path / 'off').exists()
    with trace(tmp_path / 'trace'):
        with annotate('synthesis_span'):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list((tmp_path / 'trace').glob('*.pt.trace.json'))
    assert len(files) == 1
    names = {e.get('name') for e in
             json.loads(files[0].read_text())['traceEvents']}
    assert 'synthesis_span' in names
    assert device_memory_stats('cpu') is None


def test_display_prints_what_jax_prints(capsys, monkeypatch, tmp_path):
    from forwardtacotron_tpu.utils import display as jdisplay
    from forwardtacotron_tpu.utils.files import save_config as jsave_config

    from forwardtacotron_torch.utils import display
    from forwardtacotron_torch.utils.files import save_config

    clock = [1000.0]
    monkeypatch.setattr(time, 'time', lambda: clock[0])
    printed = []
    for mod in (display, jdisplay):
        mod.stream('| Epoch: 1/3 (2/10) | Loss: 0.5 |')
        mod.simple_table([('Steps', '10k Steps'), ('Batch Size', 32),
                          ('Learning Rate', 1e-4)])
        print(mod.progbar(3, 7), mod.progbar(7, 7, size=8), mod.progbar(0, 0))
        print(mod.time_since(clock[0] - 75), mod.time_since(clock[0] - 7384))

        def boom():
            raise RuntimeError('no plot')
        assert mod.ignore_exception(boom)() is None
        assert mod.time_it(lambda: 5)() == 5
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert 'ignored exception in boom' in printed[0]

    config = {'dsp': {'num_mels': 80}, 'tts_model': 'forward_tacotron',
              'schedule': ['1e-3, 10, 3']}
    save_config(config, tmp_path / 'port.yaml')
    jsave_config(config, tmp_path / 'jax.yaml')
    written = (tmp_path / 'port.yaml').read_text()
    assert written == (tmp_path / 'jax.yaml').read_text()
    assert yaml.safe_load(written) == config


def test_plot_helpers_make_figures():
    pytest.importorskip('matplotlib')
    from forwardtacotron_torch.utils.display import (plot_attention,
                                                     plot_mel, plot_pitch)
    rs = np.random.RandomState(0)
    for fig in (plot_mel(rs.randn(16, 40)), plot_pitch(rs.randn(12)),
                plot_attention(rs.rand(40, 12))):
        assert fig.axes
