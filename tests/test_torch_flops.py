"""The port's roofline arithmetic (``forwardtacotron_torch/utils/flops.py``)
against the JAX module it copies, and against the port's model.

- Every counting function equals the JAX module's within rtol 1e-12, at
  the flagship widths (``configs/singlespeaker.yaml``) and at
  ``tests/test_flops.py``'s MID_MODEL, over batch x tokens x frames x
  dtype bytes.
- ``roofline_report`` equals the JAX report key by key for 'bf16' and
  'int8' on a JAX ``ChipSpec`` built from the H100's figures; 'tf32' and
  'f32' are held to values computed by hand.
- The analytic count equals what ``torch.utils.flop_counter`` counts in
  the port's ``ForwardTacotron``: ``generate`` against the decode stages
  and ``predict_series`` against 'series_predictors' within rtol 1e-6, a
  teacher-forced forward plus backward within 1% of
  ``forward_tacotron_train_flops``, whose backward counts 2 GEMMs per
  forward GEMM (autograd skips the input gradient of a layer whose input
  needs none, such as the pitch and energy projections').
- ``chip_spec`` names the CPU and the H100 SXM and refuses other cards.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode
from torch_cpu import (  # noqa: F401 (torch_one_thread: a fixture)
    subprocess_env, torch_one_thread)

from forwardtacotron_torch.models.forward_tacotron import ForwardTacotron
from forwardtacotron_torch.utils import flops
from forwardtacotron_torch.utils.files import read_config
from forwardtacotron_tpu.utils import flops as jax_flops

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12

# tests/test_flops.py's MID_MODEL
MID_MODEL = dict(
    embed_dims=64, series_embed_dims=32,
    durpred_conv_dims=64, durpred_rnn_dims=32, durpred_dropout=0.5,
    pitch_conv_dims=64, pitch_rnn_dims=32, pitch_dropout=0.5,
    pitch_strength=1.0,
    energy_conv_dims=64, energy_rnn_dims=32, energy_dropout=0.5,
    energy_strength=1.0,
    prenet_dims=64, prenet_k=8, prenet_dropout=0.5, prenet_num_highways=4,
    rnn_dims=128, postnet_dims=64, postnet_k=4, postnet_num_highways=4,
    postnet_dropout=0.0)


def _config(name):
    if name == 'singlespeaker':
        return read_config(REPO / 'configs' / 'singlespeaker.yaml')
    config = read_config(REPO / 'tests' / 'resources' / 'test_config.yaml')
    config['forward_tacotron'] = {'model': dict(MID_MODEL)}
    return config


@pytest.fixture(scope='module')
def configs():
    return {name: _config(name) for name in ('singlespeaker', 'mid')}


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize('dtype_bytes', [2, 4])
@pytest.mark.parametrize('t', [1, 256, 928])
@pytest.mark.parametrize('n', [1, 81, 160])
@pytest.mark.parametrize('b', [1, 32, 4096])
@pytest.mark.parametrize('model', ['singlespeaker', 'mid'])
def test_counts_match_jax(configs, model, b, n, t, dtype_bytes):
    config = configs[model]
    m = config['forward_tacotron']['model']
    n_mels = config['dsp']['num_mels']
    emb, p = m['embed_dims'], m['prenet_dims']
    for name, args in [
            ('dense_flops', (b, t, 2 * m['rnn_dims'], n_mels)),
            ('conv1d_flops', (b, n, emb, p, 5)),
            ('bidir_rnn_flops', (b, t, 2 * p, m['rnn_dims'], 4)),
            ('series_predictor_flops', (b, n, m['series_embed_dims'],
                                        m['pitch_conv_dims'],
                                        m['pitch_rnn_dims'])),
            ('cbhg_flops', (b, t, m['postnet_k'], m['postnet_dims'],
                            m['postnet_dims'], n_mels,
                            m['postnet_num_highways'], n_mels)),
            ('forward_tacotron_generate_flops', (config, b, n, t)),
            ('forward_tacotron_train_flops', (config, b, n, t)),
            ('forward_tacotron_activation_bytes',
             (config, b, n, t, dtype_bytes)),
            ('forward_tacotron_param_bytes', (config, dtype_bytes))]:
        _close(getattr(flops, name)(*args), getattr(jax_flops, name)(*args))
    _close(flops.forward_tacotron_stage_flops(m, b, n, t, n_mels=n_mels),
           jax_flops.forward_tacotron_stage_flops(m, b, n, t, n_mels=n_mels))
    _close(flops.forward_tacotron_stage_bytes(m, b, n, t, n_mels=n_mels,
                                              dtype_bytes=dtype_bytes),
           jax_flops.forward_tacotron_stage_bytes(
               m, b, n, t, n_mels=n_mels, dtype_bytes=dtype_bytes))


# (FLOPs, bytes, seconds): the bf16 serving call at batch 4096 in 177.69
# ms (compute-bound at bf16), a bytes-heavy call (bound by HBM), a train
# step at 32 x 160 x 928
RUNS = [(27.693106069504e12, 28.821861504e9, 0.17769),
        (1e12, 100e9, 0.5), (1.932392398848e12, 2.27251456e9, 0.5013)]


@pytest.mark.parametrize('dtype', ['bf16', 'int8'])
@pytest.mark.parametrize('run', RUNS)
def test_roofline_report_matches_jax(run, dtype):
    spec = flops.CHIP_SPECS['h100']
    jax_spec = jax_flops.ChipSpec('h100', 989e12, 1979e12, 3.35e12, 80e9)
    _close(flops.roofline_report(*run, spec=spec, dtype=dtype),
           jax_flops.roofline_report(*run, spec=jax_spec, dtype=dtype))


@pytest.mark.parametrize('dtype,peak', [('tf32', 495e12), ('f32', 67e12)])
def test_roofline_report_tf32_f32(dtype, peak):
    spec = flops.CHIP_SPECS['h100']
    report = flops.roofline_report(10e12, 100e9, 0.5, spec=spec,
                                   dtype=dtype)
    _close(report, {
        'chip': 'h100', 'achieved_tflops': 20.0, 'mfu': 20e12 / peak,
        'achieved_hbm_gbps': 200.0, 'hbm_util': 200e9 / 3.35e12,
        'arithmetic_intensity': 100.0, 'ridge_intensity': peak / 3.35e12,
        # 100 FLOP/B: above f32's ridge (20.0), below TF32's (147.8)
        'bound': 'compute' if dtype == 'f32' else 'hbm'})
    with pytest.raises(ValueError, match='fp16'):
        flops.roofline_report(1.0, 1.0, 1.0, spec=spec, dtype='fp16')


def test_chip_specs_hold_the_card_and_not_a_tpu():
    assert sorted(flops.CHIP_SPECS) == ['cpu', 'h100']
    h100 = flops.CHIP_SPECS['h100']
    assert (h100.flops_bf16, h100.flops_int8, h100.hbm_gbps, h100.hbm_bytes,
            h100.flops_tf32, h100.flops_f32) == (989e12, 1979e12, 3.35e12,
                                                 80e9, 495e12, 67e12)
    assert h100.ridge_bf16 == 989e12 / 3.35e12


def test_chip_spec_names_cards(monkeypatch):
    assert flops.chip_spec(torch.device('cpu')).name == 'cpu'
    assert flops.chip_spec('cpu').name == 'cpu'
    assert flops.card_spec('NVIDIA H100 80GB HBM3').name == 'h100'
    assert flops.card_spec('NVIDIA H100 SXM5 80GB').name == 'h100'
    for name in ('NVIDIA H100 PCIe', 'NVIDIA A100-SXM4-80GB'):
        with pytest.raises(ValueError, match=name):
            flops.card_spec(name)
    # a card: its name decides
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    names = iter(['NVIDIA H100 80GB HBM3', 'NVIDIA A100-SXM4-80GB'])
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda device=None: next(names))
    assert flops.chip_spec(torch.device('cuda')).name == 'h100'
    with pytest.raises(ValueError, match='A100'):
        flops.chip_spec()
    # no card: the default device is CUDA, so it raises
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='No CUDA device'):
        flops.chip_spec()
    with pytest.raises(RuntimeError, match='No CUDA device'):
        flops.roofline_report(1.0, 1.0, 1.0)


def test_module_imports_torch_only_in_chip_spec():
    code = ('import sys, forwardtacotron_torch.utils.flops; '
            'assert "torch" not in sys.modules')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=subprocess_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_jax_module_has_a_counterpart():
    """Apart from ``ops/pallas/`` (done by ``ops/hopper/``), every file of
    the JAX package has a file of the same path in the port."""
    def files(pkg):
        root = REPO / pkg
        return {str(p.relative_to(root)) for p in root.rglob('*.py')}
    missing = files('forwardtacotron_tpu') - files('forwardtacotron_torch')
    assert missing and all(p.startswith('ops/pallas/') for p in missing), \
        sorted(missing)


@pytest.fixture(scope='module')
def mid():
    """The port's ForwardTacotron at MID_MODEL (f32, CPU, seeded) and the
    inputs of tests/test_flops.py: b 4, n 32, t 128. It runs on one
    intra-op thread, as every port test does (tests/torch_cpu.py)."""
    config = _config('mid')
    torch.manual_seed(0)
    model = ForwardTacotron.from_config(config)
    rs = np.random.RandomState(0)
    b, n = 4, 32
    return config, model, {
        'x': torch.as_tensor(rs.randint(1, 100, (b, n))),
        'pitch': torch.as_tensor(rs.randn(b, n).astype(np.float32)),
        'energy': torch.as_tensor(rs.rand(b, n).astype(np.float32))}


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_generate_counts_match_the_model(mid):
    config, model, inp = mid
    b, n = inp['x'].shape
    t = 128
    stages = flops.forward_tacotron_stage_flops(
        MID_MODEL, b, n, t, n_mels=config['dsp']['num_mels'])
    with torch.no_grad():
        decode = _counted(lambda: model.generate(
            inp['x'], torch.full((b, n), float(t) / n), inp['pitch'],
            inp['energy'], t))
        series = _counted(lambda: model.predict_series(inp['x']))
    analytic = sum(v for k, v in stages.items() if k != 'series_predictors')
    np.testing.assert_allclose(analytic, decode, rtol=1e-6)
    np.testing.assert_allclose(stages['series_predictors'], series,
                               rtol=1e-6)


def test_train_step_count_matches_the_model(mid):
    config, model, inp = mid
    b, n = inp['x'].shape
    t = 3 * n
    batch = dict(inp, dur=torch.full((b, n), 3.0),
                 mel_len=torch.full((b,), t),
                 mel=torch.zeros(b, t, config['dsp']['num_mels']))
    model.train()

    def step():
        out = model(batch)
        sum(v.sum() for v in out.values()).backward()
    try:
        counted = _counted(step)
    finally:
        model.eval()
    np.testing.assert_allclose(
        flops.forward_tacotron_train_flops(config, b, n, t), counted,
        rtol=1e-2)
