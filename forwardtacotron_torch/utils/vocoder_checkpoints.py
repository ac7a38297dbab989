"""Published HiFi-GAN generator checkpoints into the port's generator.

Port of the HiFi-GAN half of forwardtacotron_tpu/utils/vocoder_checkpoints.py.
jik876/hifigan ``generator_*`` files hold the state dict under
``'generator'``, trained with ``torch.nn.utils.weight_norm`` on every conv:
each weight is stored factored as (weight_g, weight_v) or, from newer torch,
``parametrizations.weight.original0/original1``. Inference does not need the
factoring, so it is folded here, W = g * v / ||v|| with the norm over all
axes but 0 (torch's default dim=0), in numpy float32 as the JAX package
folds it. The port keeps torch's layouts, so the folded dict loads with
``load_state_dict`` as it is.
"""

from typing import Dict, Optional, Union

import numpy as np
import torch

from forwardtacotron_torch.models.vocoder import HiFiGANGenerator
from forwardtacotron_torch.utils.device import resolve_device


def _load_torch_state(path: str) -> Dict[str, np.ndarray]:
    data = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(data, dict):
        for key in ('generator', 'model_g', 'model', 'state_dict'):
            if key in data and isinstance(data[key], dict):
                data = data[key]
                break
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, 'detach')
                          else v) for k, v in data.items()}


def fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Collapse (weight_g, weight_v) / parametrizations pairs to 'weight'."""
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.endswith('weight_g') or k.endswith(
                'parametrizations.weight.original0'):
            continue
        if k.endswith('weight_v'):
            base = k[:-len('_v')]
            g = sd[base + '_g']
            out[k[:-len('weight_v')] + 'weight'] = _fold(g, v)
        elif k.endswith('parametrizations.weight.original1'):
            prefix = k[:-len('parametrizations.weight.original1')]
            g = sd[prefix + 'parametrizations.weight.original0']
            out[prefix + 'weight'] = _fold(g, v)
        else:
            out[k] = v
    return out


def _fold(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))
    return (g * v / norm).astype(v.dtype)


def load_hifigan(path: str, config: Optional[dict] = None,
                 dtype: Optional[torch.dtype] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> HiFiGANGenerator:
    """A published HiFi-GAN generator checkpoint as a ``HiFiGANGenerator``
    in eval mode, on ``device`` (CUDA unless told otherwise) in ``dtype``
    (float32 unless given). ``config``: the official config.json dict
    (resblock / upsample_* keys); the v1 defaults are used when omitted."""
    dev = resolve_device(device)
    model = HiFiGANGenerator.from_config(config or {})
    sd = fold_weight_norm(_load_torch_state(path))
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()})
    return model.to(dev, dtype or torch.float32).eval()
