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
'''


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from forwardtacotron_torch.dsp.dsp import DSP
    from forwardtacotron_torch.models.forward_tacotron import ForwardTacotron
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.utils.device import resolve_device

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


def test_bfloat16_and_other_families_raise():
    from forwardtacotron_torch.models.registry import init_tts_model
    from forwardtacotron_torch.models.synthesis import TTSInference
    from forwardtacotron_torch.utils.files import read_config

    config = read_config(REPO / 'configs' / 'singlespeaker.yaml')
    config['tts_model'] = 'fast_pitch'
    with pytest.raises(NotImplementedError, match='fast_pitch'):
        init_tts_model(config)
    with pytest.raises(NotImplementedError, match='bfloat16'):
        TTSInference(torch.nn.Linear(1, 1), dtype='bfloat16', device='cpu')
