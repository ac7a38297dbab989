"""Config-driven DSP for synthesis: mel inversion, Griffin-Lim, wav writing.

Port of the synthesis half of forwardtacotron_tpu/dsp/dsp.py
(``from_config``, ``_mel_to_stft``, ``griffinlim``, ``save_wav``).
"""

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from forwardtacotron_torch.dsp.mel import mel_filterbank
from forwardtacotron_torch.ops.hopper.griffin_lim import griffin_lim_fused
from forwardtacotron_torch.ops.stft import griffin_lim_pair, initial_phase
from forwardtacotron_torch.utils.device import resolve_device


class DSP:

    def __init__(self, num_mels: int, sample_rate: int, hop_length: int,
                 win_length: int, n_fft: int, fmin: float, fmax: float,
                 device: Optional[Union[str, torch.device]] = None,
                 **kwargs: Any) -> None:
        """``kwargs`` takes the config's preprocessing-only keys (trims,
        VAD, peak norm), which synthesis does not use. ``device`` defaults
        to CUDA and raises when no GPU is present."""
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_fft = n_fft
        basis = mel_filterbank(sample_rate, n_fft, num_mels, fmin, fmax)
        self.mel_basis = torch.as_tensor(basis, device=self.device)
        self._mel_pinv = torch.as_tensor(np.linalg.pinv(basis),
                                         device=self.device)

    @classmethod
    def from_config(cls, config: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = None
                    ) -> 'DSP':
        return cls(**config['dsp'], device=device)

    def save_wav(self, wav: np.ndarray, path: Union[str, Path]) -> None:
        from scipy.io import wavfile
        wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
        wavfile.write(str(path), self.sample_rate,
                      (wav * 32767).astype(np.int16))

    def _mel_to_stft(self, mel_power: torch.Tensor,
                     nnls_iter: int = 8) -> torch.Tensor:
        """Linear spectrogram from mel: pinv init, then multiplicative NNLS
        updates S <- S * (M^T mel) / (M^T M S), which keep S >= 0."""
        s = torch.clamp(self._mel_pinv @ mel_power, min=0.0)
        num = self.mel_basis.T @ mel_power
        for _ in range(nnls_iter):
            den = self.mel_basis.T @ (self.mel_basis @ s)
            s = s * num / torch.clamp(den, min=1e-10)
        return s

    def _gl_fused_usable(self, n_frames: int) -> bool:
        """The fused iteration replaces R = n_fft // hop frames at each end
        from 2R-1 spectrum rows, so it needs at least 2R frames."""
        return n_frames >= 2 * (self.n_fft // self.hop_length)

    @torch.inference_mode()
    def griffinlim(self, mel: np.ndarray, n_iter: int = 32, seed: int = 0,
                   phase: Optional[np.ndarray] = None) -> np.ndarray:
        """Log-mel [n_mels, T] -> waveform (reference utils/dsp.py:80-94).

        The initial phase is drawn from a ``torch.Generator`` seeded with
        ``seed``, or taken from ``phase`` ([bins, T] radians) when given.
        It cannot equal the JAX package's ``jax.random`` draw for the same
        seed, so the two agree only when given the same ``phase``."""
        if self.n_fft % self.hop_length:
            raise NotImplementedError(
                'Griffin-Lim for a hop that does not divide n_fft is not '
                'ported yet')
        mel_power = torch.exp(torch.tensor(np.asarray(mel),
                                           dtype=torch.float32,
                                           device=self.device))
        linear = self._mel_to_stft(mel_power)
        if phase is None:
            phase = initial_phase(linear.shape, seed)
        phase = torch.tensor(np.asarray(phase), dtype=torch.float32,
                             device=self.device)
        if self._gl_fused_usable(linear.shape[1]):
            wav = griffin_lim_fused(linear[None], phase[None], self.n_fft,
                                    self.hop_length, self.win_length,
                                    n_iter=n_iter)[0]
        else:
            wav = griffin_lim_pair(linear, phase, self.n_fft,
                                   self.hop_length, self.win_length,
                                   n_iter=n_iter)
        return wav.cpu().numpy()
