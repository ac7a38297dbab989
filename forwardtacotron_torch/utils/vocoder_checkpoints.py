"""Published HiFi-GAN and MelGAN generator checkpoints into the port's
generators.

Port of forwardtacotron_tpu/utils/vocoder_checkpoints.py. jik876/hifigan
``generator_*`` files hold the state dict under ``'generator'``,
seungwonpark/melgan files under ``'model_g'`` (keys ``generator.{i}...``,
indices of its ``nn.Sequential``); both trained with
``torch.nn.utils.weight_norm`` on every conv:
each weight is stored factored as (weight_g, weight_v) or, from newer torch,
``parametrizations.weight.original0/original1``. Inference does not need the
factoring, so it is folded here, W = g * v / ||v|| with the norm over all
axes but 0 (torch's default dim=0), in numpy float32 as the JAX package
folds it. The port keeps torch's layouts, so a folded HiFi-GAN dict loads
with ``load_state_dict`` as it is, and a MelGAN one once its indices are
renamed (:func:`convert_melgan_state_dict`).
"""

from typing import Dict, Optional, Union

import numpy as np
import torch

from forwardtacotron_torch.models.vocoder import (HiFiGANGenerator,
                                                  MelGANGenerator)
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


# torch Sequential indices in seungwonpark/melgan's Generator.generator
_MELGAN_UPS = {3: 0, 6: 1, 9: 2, 12: 3}
_MELGAN_RES = {4: 0, 7: 1, 10: 2, 13: 3}


def convert_melgan_state_dict(sd: Dict[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
    """seungwonpark/melgan Generator state_dict (weight norm folded here)
    -> the port's ``MelGANGenerator`` state_dict, as numpy arrays."""
    sd = fold_weight_norm(sd)
    sd = {k[len('generator.'):] if k.startswith('generator.') else k: v
          for k, v in sd.items()}
    names = {'1': 'conv_pre', '16': 'conv_post'}
    names.update({str(i): f'ups.{j}' for i, j in _MELGAN_UPS.items()})
    for i, j in _MELGAN_RES.items():
        for u in range(3):
            names[f'{i}.blocks.{u}.2'] = f'res.{j}.blocks_conv1.{u}'
            names[f'{i}.blocks.{u}.4'] = f'res.{j}.blocks_conv2.{u}'
            names[f'{i}.shortcuts.{u}'] = f'res.{j}.shortcuts.{u}'
    return {f'{names[k.rsplit(".", 1)[0]]}.{k.rsplit(".", 1)[1]}': v
            for k, v in sd.items()}


def load_melgan(path: str, dtype: Optional[torch.dtype] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> MelGANGenerator:
    """A published seungwonpark/melgan generator checkpoint as a
    ``MelGANGenerator`` in eval mode, on ``device`` (CUDA unless told
    otherwise) in ``dtype`` (float32 unless given). The mel and base
    channels are read from ``conv_pre``'s weight (80 and 512 in the
    published files)."""
    dev = resolve_device(device)
    sd = convert_melgan_state_dict(_load_torch_state(path))
    base, mels, _ = sd['conv_pre.weight'].shape
    model = MelGANGenerator(mel_channels=mels, base_channels=base)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()})
    return model.to(dev, dtype or torch.float32).eval()
