"""Reference-format checkpoints: a torch ``.pt`` holding
{'model': state_dict, 'config': dict, ...} (reference
utils/checkpoints.py:13-23) loads straight into the port with
``load_state_dict``. The JAX package's native msgpack ``.ckpt`` is not
read yet."""

from pathlib import Path
from typing import Any, Dict, Tuple, Union

import torch

from forwardtacotron_torch.models.registry import init_tts_model


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The checkpoint dict ('model', 'config', optional meta), on the CPU.
    Reference checkpoints pickle their config, so this is for trusted
    files only."""
    return torch.load(str(path), map_location='cpu', weights_only=False)


def init_tts_model_from_checkpoint(path: Union[str, Path]
                                   ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """(model with the checkpoint's weights, checkpoint) on the CPU; the
    caller moves the model where it runs (``TTSInference`` does)."""
    checkpoint = load_checkpoint(path)
    model = init_tts_model(checkpoint['config'])
    model.load_state_dict(checkpoint['model'])
    return model, checkpoint


def checkpoint_step(checkpoint: Dict[str, Any]) -> int:
    """Training step stored in a reference checkpoint's ``step`` buffer."""
    return int(checkpoint['model']['step'].reshape(-1)[0])
