"""Weights carried between the reference format, the JAX package and the
port: the port's state_dict is the reference schema, the JAX converter
accepts it, and ``from_jax_variables`` inverts that converter (exact)."""

import json
from pathlib import Path

import numpy as np
import torch
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.models.registry import init_tts_model
from forwardtacotron_torch.utils.convert import from_jax_variables
from forwardtacotron_torch.utils.files import read_config

SCHEMA = Path('tests/resources/reference_state_dict_schema.json')


def _full_model():
    torch.manual_seed(0)
    return init_tts_model(read_config('configs/singlespeaker.yaml'))


def test_state_dict_matches_reference_schema():
    schema = json.loads(SCHEMA.read_text())['models']['forward_tacotron']
    got = {k: list(v.shape) for k, v in _full_model().state_dict().items()}
    assert len(got) == 322
    assert got == schema


def test_jax_converter_accepts_port_state_dict():
    import jax

    from forwardtacotron_tpu.models.registry import \
        init_tts_model as jax_init_tts_model
    from forwardtacotron_tpu.utils.convert import (convert_state_dict,
                                                   validate_against)

    config = read_config('configs/singlespeaker.yaml')
    variables, _ = convert_state_dict(_full_model().state_dict())
    n = 4
    batch = {'x': np.ones((1, n), np.int64),
             'dur': np.ones((1, n), np.float32),
             'mel_len': np.array([2 * n]),
             'pitch': np.zeros((1, n), np.float32),
             'energy': np.zeros((1, n), np.float32),
             'mel': np.zeros((1, 2 * n, 80), np.float32)}
    model = jax_init_tts_model(config)
    shapes = jax.eval_shape(
        lambda: model.init({'params': jax.random.PRNGKey(0),
                            'dropout': jax.random.PRNGKey(1)},
                           batch, train=False))
    validate_against(variables, shapes)


def test_from_jax_variables_round_trips():
    from forwardtacotron_tpu.utils.convert import convert_state_dict

    model = _full_model()
    with torch.no_grad():   # BN stats away from their 0/1 init
        for name, buf in model.named_buffers():
            if name.endswith(('running_mean', 'running_var')):
                buf.uniform_(0.5, 1.5)
    sd = model.state_dict()
    back = from_jax_variables(convert_state_dict(sd)[0])
    assert set(back) == set(sd) - {'step'}
    for k, v in back.items():
        assert v.shape == sd[k].shape, k
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    fresh = init_tts_model(read_config('configs/singlespeaker.yaml'))
    missing, unexpected = fresh.load_state_dict(back, strict=False)
    assert missing == ['step'] and unexpected == []
