"""Reference-format checkpoints: a torch ``.pt`` holding
{'model': state_dict, 'optim': optimizer state, 'config': dict, ...}
(reference utils/checkpoints.py:13-34). A checkpoint of the reference, or one
the port's trainer wrote, loads straight into the port with
``load_state_dict``; the model's ``step`` buffer holds the training step.
The JAX package's native msgpack ``.ckpt`` is not read yet."""

from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from forwardtacotron_torch.models.registry import init_tts_model


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The checkpoint dict ('model', 'config', optional 'optim' and meta),
    on the CPU. Reference checkpoints pickle their config, so this is for
    trusted files only."""
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


def tree_to(tree: Any, device: Union[str, torch.device]) -> Any:
    """Every tensor of a nested dict, detached, on ``device``."""
    if torch.is_tensor(tree):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree


def save_checkpoint(path: Union[str, Path], model: torch.nn.Module,
                    config: Dict[str, Any], step: int,
                    opt_state: Optional[Dict[str, Any]] = None,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``path`` atomically (a crash never leaves half a
    ``latest_model.pt``), with the model's ``step`` buffer set to
    ``step``."""
    with torch.no_grad():
        model.step.fill_(int(step))
    checkpoint = {'model': tree_to(model.state_dict(), 'cpu'),
                  'config': config}
    if opt_state is not None:
        checkpoint['optim'] = tree_to(opt_state, 'cpu')
    checkpoint.update(meta or {})
    path = Path(path)
    tmp = path.with_suffix(path.suffix + '.tmp')
    torch.save(checkpoint, str(tmp))
    tmp.replace(path)


def restore_checkpoint(checkpoint_dir: Union[str, Path],
                       name: str = 'latest_model.pt'
                       ) -> Optional[Dict[str, Any]]:
    """``name`` from ``checkpoint_dir`` if it is there (the reference's
    implicit resume, utils/checkpoints.py:26-34), else None."""
    path = Path(checkpoint_dir) / name
    return load_checkpoint(path) if path.is_file() else None
