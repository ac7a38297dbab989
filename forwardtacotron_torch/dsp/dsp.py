"""Config-driven DSP: wav IO, log-mel extraction, Griffin-Lim, silence trims.

Port of forwardtacotron_tpu/dsp/dsp.py (reference utils/dsp.py:11-128):
``load_wav`` / ``save_wav`` (scipy for ``.wav``; other formats need
soundfile, as in the JAX package), ``wav_to_mel`` on the DSP's device (the
STFT magnitude, the mel product, the log with ``LOG_MEL_FLOOR``),
``normalize`` / ``denormalize``, ``griffinlim`` (mel inversion by NNLS,
then the Griffin-Lim kernel), and the numpy trims: ``trim_silence`` and
``trim_long_silences`` (webrtcvad when installed, else an energy VAD with
the same windowing).
"""

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from forwardtacotron_torch.dsp.mel import mel_filterbank
from forwardtacotron_torch.ops.hopper.griffin_lim import griffin_lim_fused
from forwardtacotron_torch.ops.stft import (griffin_lim, griffin_lim_pair,
                                           initial_phase, stft_magnitude)
from forwardtacotron_torch.utils.device import resolve_device

LOG_MEL_FLOOR = 1e-5                 # clip floor (reference utils/dsp.py:97)


class DSP:

    def __init__(self, num_mels: int, sample_rate: int, hop_length: int,
                 win_length: int, n_fft: int, fmin: float, fmax: float,
                 peak_norm: bool = False,
                 trim_start_end_silence: bool = True,
                 trim_silence_top_db: int = 60,
                 trim_long_silences: bool = False,
                 vad_sample_rate: int = 16000,
                 vad_window_length: float = 30,
                 vad_moving_average_width: float = 8,
                 vad_max_silence_length: int = 12,
                 device: Optional[Union[str, torch.device]] = None,
                 **kwargs: Any) -> None:
        """The config's ``dsp`` section; ``device`` defaults to CUDA and
        raises when no GPU is present."""
        self.device = resolve_device(device)
        self.n_mels = num_mels
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_fft = n_fft
        self.fmin = fmin
        self.fmax = fmax

        self.should_peak_norm = peak_norm
        self.should_trim_start_end_silence = trim_start_end_silence
        self.should_trim_long_silences = trim_long_silences
        self.trim_silence_top_db = trim_silence_top_db

        self.vad_sample_rate = vad_sample_rate
        self.vad_window_length = vad_window_length
        self.vad_moving_average_width = vad_moving_average_width
        self.vad_max_silence_length = vad_max_silence_length

        basis = mel_filterbank(sample_rate, n_fft, num_mels, fmin, fmax)
        self.mel_basis = torch.as_tensor(basis, device=self.device)
        self._mel_pinv = torch.as_tensor(np.linalg.pinv(basis),
                                         device=self.device)

    @classmethod
    def from_config(cls, config: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = None
                    ) -> 'DSP':
        return cls(**config['dsp'], device=device)

    # ------------------------------------------------------------------ wav io

    def load_wav(self, path: Union[str, Path]) -> np.ndarray:
        """float32 mono samples at the DSP's rate: integer PCM scaled to
        [-1, 1), channels averaged, other rates resampled."""
        sr, wav = _read_audio(path)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        elif wav.dtype == np.int32:
            wav = wav.astype(np.float32) / 2147483648.0
        elif wav.dtype == np.uint8:
            wav = (wav.astype(np.float32) - 128.0) / 128.0
        else:
            wav = wav.astype(np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        if sr != self.sample_rate:
            wav = resample(wav, sr, self.sample_rate)
        return wav

    def save_wav(self, wav: np.ndarray, path: Union[str, Path]) -> None:
        from scipy.io import wavfile
        wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
        wavfile.write(str(path), self.sample_rate,
                      (wav * 32767).astype(np.int16))

    # ------------------------------------------------------------- mel extract

    @torch.inference_mode()
    def wav_to_mel(self, y: np.ndarray, normalize: bool = True) -> np.ndarray:
        """[samples] -> mel [n_mels, 1 + samples // hop]: the STFT
        magnitude and the mel product on the DSP's device in float32, then
        (``normalize``) the log of the mel clipped at ``LOG_MEL_FLOOR``."""
        y = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        spec = stft_magnitude(y, self.n_fft, self.hop_length,
                              self.win_length)
        mel = self.mel_basis @ spec
        if normalize:
            mel = torch.log(torch.clamp(mel, min=LOG_MEL_FLOOR))
        return mel.cpu().numpy()

    def normalize(self, mel: np.ndarray) -> np.ndarray:
        return np.log(np.clip(mel, a_min=LOG_MEL_FLOOR, a_max=None))

    def denormalize(self, mel: np.ndarray) -> np.ndarray:
        return np.exp(mel)

    # -------------------------------------------------------------- griffinlim

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
        mel_power = torch.exp(torch.tensor(np.asarray(mel),
                                           dtype=torch.float32,
                                           device=self.device))
        linear = self._mel_to_stft(mel_power)
        if phase is None:
            phase = initial_phase(linear.shape, seed)
        phase = torch.tensor(np.asarray(phase), dtype=torch.float32,
                             device=self.device)
        if self.n_fft % self.hop_length:
            # the pair path's strided overlap-add needs hop | n_fft: a
            # non-dividing hop (e.g. 2048/275) takes the rfft form, as in
            # the JAX package
            wav = griffin_lim(linear, phase, self.n_fft, self.hop_length,
                              self.win_length, n_iter=n_iter)
        elif self._gl_fused_usable(linear.shape[1]):
            wav = griffin_lim_fused(linear[None], phase[None], self.n_fft,
                                    self.hop_length, self.win_length,
                                    n_iter=n_iter)[0]
        else:
            wav = griffin_lim_pair(linear, phase, self.n_fft,
                                   self.hop_length, self.win_length,
                                   n_iter=n_iter)
        return wav.cpu().numpy()

    # ------------------------------------------------------------------- trims

    def trim_silence(self, wav: np.ndarray, frame_length: int = 2048,
                     hop_length: int = 512) -> np.ndarray:
        """Trim leading and trailing silence: frames whose RMS is more than
        ``trim_silence_top_db`` below the loudest frame's (what
        librosa.effects.trim does at reference utils/dsp.py:103-104)."""
        if len(wav) < frame_length:
            return wav
        pad = frame_length // 2
        y = np.pad(wav, (pad, pad), mode='constant')
        n_frames = 1 + (len(y) - frame_length) // hop_length
        idx = (np.arange(n_frames)[:, None] * hop_length
               + np.arange(frame_length)[None, :])
        rms = np.sqrt(np.mean(y[idx] ** 2, axis=1))
        ref = rms.max()
        if ref <= 0:
            return wav
        db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
        nonsilent = np.flatnonzero(db > -self.trim_silence_top_db)
        if len(nonsilent) == 0:
            return wav[:0]
        start = int(nonsilent[0] * hop_length)
        end = min(len(wav), int((nonsilent[-1] + 1) * hop_length))
        return wav[start:end]

    def trim_long_silences(self, wav: np.ndarray) -> np.ndarray:
        """Shorten long interior silences with a VAD mask: webrtcvad when
        installed (reference utils/dsp.py:107-128), else an energy VAD with
        the same windowing, moving-average smoothing and binary
        dilation."""
        samples_per_window = int(
            (self.vad_window_length * self.vad_sample_rate) // 1000)
        ratio = self.sample_rate / self.vad_sample_rate
        wav16 = resample(wav, self.sample_rate, self.vad_sample_rate)
        wav16 = wav16[:len(wav16) - (len(wav16) % samples_per_window)]
        if len(wav16) == 0:
            return wav

        n_windows = len(wav16) // samples_per_window
        frames = wav16[:n_windows * samples_per_window].reshape(
            n_windows, samples_per_window)
        voice_flags = self._vad_flags(frames)

        width = int(self.vad_moving_average_width)
        padded = np.concatenate([np.zeros((width - 1) // 2), voice_flags,
                                 np.zeros(width // 2)])
        csum = np.cumsum(np.concatenate([[0.0], padded]))
        smoothed = (csum[width:] - csum[:-width]) / width
        mask = np.round(smoothed).astype(bool)
        mask = _binary_dilation(mask, self.vad_max_silence_length + 1)

        sample_mask = np.repeat(mask, samples_per_window)
        # the mask, made at the VAD's rate, back at the DSP's rate
        keep = np.repeat(sample_mask, int(round(ratio)))[:len(wav)]
        if len(keep) < len(wav):
            keep = np.concatenate([keep, np.ones(len(wav) - len(keep), bool)])
        return wav[keep]

    def _vad_flags(self, frames: np.ndarray) -> np.ndarray:
        """1.0 for each window with voice: webrtcvad's decision where it is
        installed, else an RMS within 40 dB of the loudest window."""
        try:
            import webrtcvad
        except ImportError:
            rms = np.sqrt(np.mean(frames ** 2, axis=1))
            ref = rms.max()
            if ref <= 0:
                return np.ones(len(frames))
            db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
            return (db > -40.0).astype(float)
        vad = webrtcvad.Vad(mode=3)
        pcm = (np.clip(frames, -1, 1) * 32767).astype(np.int16)
        return np.array([vad.is_speech(f.tobytes(), self.vad_sample_rate)
                         for f in pcm], dtype=float)


def _read_audio(path: Union[str, Path]):
    """(sample rate, samples): scipy for .wav, soundfile (if installed) for
    every other format (e.g. VCTK's .flac)."""
    path = str(path)
    if path.lower().endswith('.wav'):
        from scipy.io import wavfile
        return wavfile.read(path)
    try:
        import soundfile as sf
    except ImportError as e:
        raise RuntimeError(
            f'Reading {path} requires the soundfile package '
            '(only .wav is supported without it)') from e
    wav, sr = sf.read(path, dtype='float32')
    return sr, wav


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), in place of librosa.load's
    resampler."""
    if orig_sr == target_sr:
        return wav
    from math import gcd

    from scipy.signal import resample_poly
    g = gcd(int(orig_sr), int(target_sr))
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def _binary_dilation(mask: np.ndarray, width: int) -> np.ndarray:
    """1-D binary dilation with a flat structuring element of ``width``
    ones."""
    from scipy.ndimage import binary_dilation
    return binary_dilation(mask, np.ones(width))
