"""The port stands alone: no module of it (nor chip_smoke.py) imports JAX
or the JAX package, and its entry points never move to the CPU on their
own."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r'''
import importlib, pkgutil, sys
import forwardtacotron_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
importlib.import_module('chip_smoke')
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'forwardtacotron_tpu'))
print(len(names), bad)
assert len(names) >= 20 and not bad, bad
# the native DP is built at its first use, never at import
from forwardtacotron_torch.native import build
assert build._LOADED == {}, build._LOADED
'''


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    import yaml

    from forwardtacotron_torch import train_tacotron
    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.forward_tacotron import ForwardTacotron
    from forwardtacotron_torch.models.synthesis import TTSInference, Vocoder
    from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
    from forwardtacotron_torch.utils.device import resolve_device
    from forwardtacotron_torch.utils.vocoder_checkpoints import (load_hifigan,
                                                                 load_melgan)

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = ForwardTacotron(embed_dims=8, series_embed_dims=4,
                            durpred_conv_dims=8, durpred_rnn_dims=4,
                            pitch_conv_dims=8, pitch_rnn_dims=4,
                            energy_conv_dims=8, energy_rnn_dims=4,
                            rnn_dims=8, prenet_dims=8, prenet_k=2,
                            postnet_dims=8, postnet_k=2, n_mels=8)
    dsp_args = dict(num_mels=8, sample_rate=8000, hop_length=16,
                    win_length=64, n_fft=64, fmin=0, fmax=4000)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        TTSInference(model)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        DSP(**dsp_args)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        resolve_device('cuda')
    assert TTSInference(model, device='cpu').device.type == 'cpu'
    assert DSP(**dsp_args, device='cpu').device.type == 'cpu'
    # the vocoder: the device is resolved before the checkpoint is read
    generator = HiFiGANGenerator(upsample_initial_channel=16, num_mels=8)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        Vocoder(generator)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        Vocoder.from_checkpoint('g_00000000')
    with pytest.raises(RuntimeError, match='No CUDA device'):
        load_hifigan('g_00000000')
    with pytest.raises(RuntimeError, match='No CUDA device'):
        Vocoder.from_checkpoint('melgan.pt', vocoder_type='melgan')
    with pytest.raises(RuntimeError, match='No CUDA device'):
        load_melgan('melgan.pt')
    assert Vocoder(generator, device='cpu').device.type == 'cpu'
    # the teacher's trainer and CLI
    from forwardtacotron_torch.train.taco_trainer import TacoTrainer
    from forwardtacotron_torch.utils.files import read_config
    from forwardtacotron_torch.utils.paths import Paths

    config = read_config(REPO / 'configs' / 'singlespeaker.yaml')
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    paths = Paths.from_config(config)
    config_path = tmp_path / 'config.yaml'
    config_path.write_text(yaml.dump(config))
    with pytest.raises(RuntimeError, match='No CUDA device'):
        TacoTrainer(paths, None, config)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        train_tacotron.main(['--config', str(config_path)])
    with pytest.raises(RuntimeError, match='No CUDA device'):
        train_tacotron.main(['--config', str(config_path), '--force_gta'])
    assert TacoTrainer(paths, None, config,
                       device='cpu').device.type == 'cpu'
    with pytest.raises(RuntimeError, match='No CUDA device'):
        train_tacotron.main(['--config', str(config_path), '--force_align'])
    # the data pipeline: preprocessing, the speaker encoder, the extraction
    from forwardtacotron_torch import preprocess
    from forwardtacotron_torch.data.preprocess import (Preprocessor,
                                                       run_preprocessing)
    from forwardtacotron_torch.duration.extractor import DurationExtractor
    from forwardtacotron_torch.duration.pipeline import \
        DurationExtractionPipeline
    from forwardtacotron_torch.models.speaker_encoder import VoiceEncoder

    with pytest.raises(RuntimeError, match='No CUDA device'):
        preprocess.main(['--path', str(tmp_path), '--config',
                         str(config_path)])
    with pytest.raises(RuntimeError, match='No CUDA device'):
        run_preprocessing(config, tmp_path)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        Preprocessor(paths, config, {})
    with pytest.raises(RuntimeError, match='No CUDA device'):
        VoiceEncoder()
    pipe = DurationExtractionPipeline(paths, config,
                                      DurationExtractor(-11.0, 0.25))
    with pytest.raises(RuntimeError, match='No CUDA device'):
        pipe.extract_attentions(torch.nn.Linear(1, 1))
    assert VoiceEncoder(device='cpu').device.type == 'cpu'


def test_bfloat16_and_other_families_raise():
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.utils.files import read_config

    from forwardtacotron_torch.models.fast_pitch import FastPitch
    from forwardtacotron_torch.models.multi_fast_pitch import MultiFastPitch
    from forwardtacotron_torch.models.multi_forward_tacotron import \
        MultiForwardTacotron

    config = read_config(REPO / 'configs' / 'singlespeaker.yaml')
    config['tts_model'] = 'fast_pitch'
    assert isinstance(init_tts_model(config), FastPitch)
    # every family of the JAX package is ported: the multispeaker ones
    # build from configs/multispeaker.yaml, and an unknown family raises
    config = read_config(REPO / 'configs' / 'multispeaker.yaml')
    for family, cls in (('multi_forward_tacotron', MultiForwardTacotron),
                        ('multi_fast_pitch', MultiFastPitch)):
        config['tts_model'] = family
        assert isinstance(init_tts_model(config), cls)
    config['tts_model'] = 'tacotron'
    with pytest.raises(ValueError, match='not supported: tacotron'):
        init_tts_model(config)
    # bfloat16 is served since the fused serving path was ported; any other
    # dtype raises, naming the two that are served
    with pytest.raises(ValueError, match="'float32' or 'bfloat16'"):
        TTSInference(torch.nn.Linear(1, 1), dtype='float16', device='cpu')
    assert TTSInference(torch.nn.Linear(1, 1), dtype='bfloat16',
                        device='cpu').model.weight.dtype == torch.bfloat16


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """ForwardTrainer and ``python -m forwardtacotron_torch.train_forward``
    run on CUDA unless told ``device='cpu'``; without a card they raise."""
    import numpy as np
    import yaml

    from forwardtacotron_torch import train_forward
    from forwardtacotron_torch.train.forward_trainer import ForwardTrainer
    from forwardtacotron_torch.utils.files import read_config
    from forwardtacotron_torch.utils.paths import Paths

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    config = read_config(REPO / 'tests' / 'resources' / 'test_config.yaml')
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    paths = Paths.from_config(config)
    np.save(paths.alg / 'item.npy', np.ones(3, np.float32))
    config_path = tmp_path / 'config.yaml'
    config_path.write_text(yaml.dump(config))

    with pytest.raises(RuntimeError, match='No CUDA device'):
        ForwardTrainer(paths, None, config)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        train_forward.main(['--config', str(config_path)])
    assert ForwardTrainer(paths, None, config,
                          device='cpu').device.type == 'cpu'


_IMPORT_NEW = r'''
import importlib, sys
for name in ('forwardtacotron_torch.utils.msgpack',
             'forwardtacotron_torch.utils.checkpoints',
             'forwardtacotron_torch.utils.convert',
             'forwardtacotron_torch.utils.display',
             'forwardtacotron_torch.utils.profiler',
             'forwardtacotron_torch.utils.files',
             'forwardtacotron_torch.notebook_utils.synthesize',
             'forwardtacotron_torch.train.forward_trainer',
             'forwardtacotron_torch.train.taco_trainer',
             'forwardtacotron_torch.train_forward',
             'forwardtacotron_torch.train_tacotron',
             'forwardtacotron_torch.gen_forward', 'chip_smoke'):
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'flax', 'msgpack', 'tensorboard', 'matplotlib',
    'forwardtacotron_tpu') or m.startswith('torch.utils.tensorboard'))
assert not bad, bad
'''


def test_new_modules_import_no_jax_msgpack_tensorboard_or_matplotlib():
    """The checkpoint codec, the trainers' writers and plots, the profiler
    and the Synthesizer import none of these at import time (the card's
    machine has none of them); they load TensorBoard and matplotlib only
    where a writer or a figure is made."""
    proc = subprocess.run([sys.executable, '-c', _IMPORT_NEW], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_new_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``Synthesizer``, ``export_gta`` and ``train_forward --force_gta``
    resolve their device first: without CUDA they raise unless given the
    CPU."""
    import numpy as np
    import yaml

    from forwardtacotron_torch import train_forward
    from forwardtacotron_torch.models.forward_tacotron import ForwardTacotron
    from forwardtacotron_torch.notebook_utils.synthesize import Synthesizer
    from forwardtacotron_torch.train_forward import export_gta
    from forwardtacotron_torch.utils.files import read_config
    from forwardtacotron_torch.utils.paths import Paths

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    config = read_config(REPO / 'configs' / 'singlespeaker.yaml')
    config['data_path'] = str(tmp_path / 'data')
    config['checkpoint_path'] = str(tmp_path / 'ckpt')
    paths = Paths.from_config(config)
    np.save(paths.alg / 'item.npy', np.ones(3, np.float32))
    config_path = tmp_path / 'config.yaml'
    config_path.write_text(yaml.dump(config))
    model = ForwardTacotron(embed_dims=8, series_embed_dims=4,
                            durpred_conv_dims=8, durpred_rnn_dims=4,
                            pitch_conv_dims=8, pitch_rnn_dims=4,
                            energy_conv_dims=8, energy_rnn_dims=4,
                            rnn_dims=8, prenet_dims=8, prenet_k=2,
                            postnet_dims=8, postnet_k=2, n_mels=8)
    for device in (None, 'cuda'):
        with pytest.raises(RuntimeError, match='No CUDA device'):
            Synthesizer(str(tmp_path / 'missing.pt'), device=device)
        with pytest.raises(RuntimeError, match='No CUDA device'):
            export_gta(model, paths, config, device)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        train_forward.main(['--config', str(config_path), '--force_gta'])
    # given the CPU, the Synthesizer goes on to read its checkpoint
    with pytest.raises(FileNotFoundError):
        Synthesizer(str(tmp_path / 'missing.pt'), device='cpu')
