"""Two-phase synthesis orchestrator (port of
forwardtacotron_tpu/models/synthesis.py, float32 ``generate`` path).

Phase 1 predicts durations, pitch and energy; the host reads the expanded
frame counts; phase 2 decodes at the frame count rounded up to a
128-frame bucket, so one request's decode sees the same padded length as
in the JAX package.
"""

import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from forwardtacotron_torch.ops.length_regulator import expanded_lengths
from forwardtacotron_torch.utils.device import resolve_device


def bucket_frames(n: int, bucket: int = 128, max_frames: int = 16384) -> int:
    """Round a frame count up to a bucket boundary."""
    return min(max_frames, int(math.ceil(max(n, 1) / bucket)) * bucket)


class TTSInference:
    """Wraps a ForwardTacotron with the two-phase generate flow.

    ``device`` defaults to CUDA and raises when no GPU is present; pass
    ``device='cpu'`` to run on the CPU. Only ``dtype='float32'`` is
    ported."""

    def __init__(self, model: torch.nn.Module, dtype: str = 'float32',
                 device: Optional[Union[str, torch.device]] = None):
        if dtype == 'bfloat16':
            raise NotImplementedError(
                'bfloat16 serving comes with the fused serving path (slice 2, '
                'ROADMAP.md); use dtype="float32"')
        if dtype != 'float32':
            raise ValueError(f"dtype must be 'float32', got {dtype!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def generate(self, x, alpha: float = 1.0,
                 pitch_function: Callable = lambda p: p,
                 energy_function: Callable = lambda e: e
                 ) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(np.asarray(x), dtype=torch.long,
                            device=self.device)
        if x.dim() == 1:
            x = x[None, :]
        series = self.model.predict_series(x, alpha)
        dur = series['dur']
        pitch = torch.as_tensor(pitch_function(series['pitch']),
                                device=self.device)
        energy = torch.as_tensor(energy_function(series['energy']),
                                 device=self.device)
        mel_lens = expanded_lengths(dur)
        max_len = bucket_frames(int(mel_lens.max()))
        out = self.model.generate(x, dur, pitch, energy, max_len)
        out['mel_len'] = mel_lens
        return out

    def generate_cropped(self, x, **kwargs) -> Dict[str, np.ndarray]:
        """Single utterance: outputs cropped to the true length, mels as
        [n_mels, T] numpy arrays (the reference's layout)."""
        out = self.generate(x, **kwargs)
        length = int(out['mel_len'][0])
        return {'mel': out['mel'][0, :length].T.cpu().numpy(),
                'mel_post': out['mel_post'][0, :length].T.cpu().numpy(),
                'dur': out['dur'][0].cpu().numpy(),
                'pitch': out['pitch'][0].cpu().numpy(),
                'energy': out['energy'][0].cpu().numpy()}
