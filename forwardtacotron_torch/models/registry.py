"""Model registry: config key -> model class (reference utils/checkpoints.py:37-49)."""

from typing import Any, Dict

from torch import nn

from forwardtacotron_torch.models.fast_pitch import FastPitch
from forwardtacotron_torch.models.forward_tacotron import ForwardTacotron
from forwardtacotron_torch.models.multi_fast_pitch import MultiFastPitch
from forwardtacotron_torch.models.multi_forward_tacotron import \
    MultiForwardTacotron

MODEL_REGISTRY = {
    'forward_tacotron': ForwardTacotron,
    'fast_pitch': FastPitch,
    'multi_forward_tacotron': MultiForwardTacotron,
    'multi_fast_pitch': MultiFastPitch,
}

MULTISPEAKER_MODELS = {'multi_forward_tacotron', 'multi_fast_pitch'}


def init_tts_model(config: Dict[str, Any]) -> nn.Module:
    model_type = config.get('tts_model', 'forward_tacotron')
    if model_type not in MODEL_REGISTRY:
        raise ValueError(f'Model type not supported: {model_type}! '
                         f'Supported: {sorted(MODEL_REGISTRY)}')
    return MODEL_REGISTRY[model_type].from_config(config)


def is_multispeaker(config: Dict[str, Any]) -> bool:
    return config.get('tts_model') in MULTISPEAKER_MODELS
