"""Model registry: config key -> model class (reference utils/checkpoints.py:37-49)."""

from typing import Any, Dict

from forwardtacotron_torch.models.forward_tacotron import ForwardTacotron

# families of the JAX package that later slices of the port bring
_LATER = {'fast_pitch': 'the FastPitch slice (ROADMAP.md Queue 1, item 4)',
          'multi_forward_tacotron':
              'the multispeaker slice (ROADMAP.md Queue 1, item 5)',
          'multi_fast_pitch':
              'the multispeaker slice (ROADMAP.md Queue 1, item 5)'}


def init_tts_model(config: Dict[str, Any]) -> ForwardTacotron:
    model_type = config.get('tts_model', 'forward_tacotron')
    if model_type == 'forward_tacotron':
        return ForwardTacotron.from_config(config)
    if model_type in _LATER:
        raise NotImplementedError(
            f'{model_type} is not ported to PyTorch yet; it comes with '
            f'{_LATER[model_type]}')
    raise ValueError(f'Model type not supported: {model_type}!')
