"""Model registry: config key -> model class (reference utils/checkpoints.py:37-49)."""

from typing import Any, Dict

from torch import nn

from forwardtacotron_torch.models.fast_pitch import FastPitch
from forwardtacotron_torch.models.forward_tacotron import ForwardTacotron

MODEL_REGISTRY = {'forward_tacotron': ForwardTacotron,
                  'fast_pitch': FastPitch}

# families of the JAX package that a later slice of the port brings
_LATER = {'multi_forward_tacotron':
              'the multispeaker slice (ROADMAP.md Queue 1, item 5)',
          'multi_fast_pitch':
              'the multispeaker slice (ROADMAP.md Queue 1, item 5)'}


def init_tts_model(config: Dict[str, Any]) -> nn.Module:
    model_type = config.get('tts_model', 'forward_tacotron')
    if model_type in MODEL_REGISTRY:
        return MODEL_REGISTRY[model_type].from_config(config)
    if model_type in _LATER:
        raise NotImplementedError(
            f'{model_type} is not ported to PyTorch yet; it comes with '
            f'{_LATER[model_type]}')
    raise ValueError(f'Model type not supported: {model_type}!')
