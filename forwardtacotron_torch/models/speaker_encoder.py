"""Speaker encoder: the published Resemblyzer VoiceEncoder (the port of
forwardtacotron_tpu/models/speaker_encoder.py).

One d-vector per utterance, as the reference computes with Resemblyzer
(reference preprocess.py:172-182): a 3-layer ``nn.LSTM(40, 256)``, then
``nn.Linear(256, 256)``, ReLU and L2 normalisation of the last layer's
final hidden state (resemblyzer/voice_encoder.py), with its inference
pipeline (resemblyzer/audio.py and ``VoiceEncoder.embed_utterance``):

  wav at its rate -> resample to 16 kHz (host) -> 40-mel power spectrogram
  (n_fft 400, hop 160, librosa's melspectrogram defaults: power 2, Slaney)
  on the device -> partials of 160 frames at 50% overlap (min coverage
  0.75) -> embed each partial -> mean -> L2 normalise.

The module's ``state_dict`` keys are the published ones, so
``load_state_dict`` takes ``pretrained.pt`` (``load_resemblyzer_weights``
checks the keys and shapes). The JAX package runs this LSTM as a
``lax.scan`` with no Pallas kernel; here cuDNN's LSTM computes it, with
TF32 off so that the card's embedding is the float32 one.
"""

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from forwardtacotron_torch.utils.device import resolve_device

SAMPLE_RATE = 16000
MEL_N_FFT = 400
MEL_HOP = 160
MEL_N_CHANNELS = 40
PARTIAL_N_FRAMES = 160
MIN_PAD_COVERAGE = 0.75
OVERLAP = 0.5
MODEL_HIDDEN = 256
MODEL_LAYERS = 3
MODEL_EMB = 256

AUDIO_NORM_TARGET_DBFS = -30.0
VAD_WINDOW_LENGTH = 30          # ms
VAD_MOVING_AVERAGE_WIDTH = 8
VAD_MAX_SILENCE_LENGTH = 6


def _param_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    in_dim = MEL_N_CHANNELS
    for layer in range(MODEL_LAYERS):
        shapes[f'lstm.weight_ih_l{layer}'] = (4 * MODEL_HIDDEN, in_dim)
        shapes[f'lstm.weight_hh_l{layer}'] = (4 * MODEL_HIDDEN, MODEL_HIDDEN)
        shapes[f'lstm.bias_ih_l{layer}'] = (4 * MODEL_HIDDEN,)
        shapes[f'lstm.bias_hh_l{layer}'] = (4 * MODEL_HIDDEN,)
        in_dim = MODEL_HIDDEN
    shapes['linear.weight'] = (MODEL_EMB, MODEL_HIDDEN)
    shapes['linear.bias'] = (MODEL_EMB,)
    return shapes


def init_voice_encoder_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters in the published layout, uniform in +-1/sqrt(256),
    drawn from a ``torch.Generator`` seeded with ``seed`` (they cannot
    equal the JAX package's ``jax.random`` draw)."""
    gen = torch.Generator().manual_seed(seed)
    scale = 1.0 / np.sqrt(MODEL_HIDDEN)
    return {name: ((torch.rand(shape, generator=gen) * 2 - 1) * scale).numpy()
            for name, shape in _param_shapes().items()}


def load_resemblyzer_weights(path: str) -> Dict[str, np.ndarray]:
    """Resemblyzer's ``pretrained.pt`` (the state_dict under 'model_state',
    as published, or a plain state_dict) as numpy arrays.

    Raises ``ValueError`` when the keys or shapes are not the
    VoiceEncoder's: an unrelated checkpoint named ``pretrained.pt`` must
    not be taken for speaker-encoder weights."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    state = ckpt.get('model_state', ckpt) if isinstance(ckpt, dict) else ckpt
    if not isinstance(state, dict) or not all(
            hasattr(v, 'detach') for v in state.values()):
        raise ValueError(f'{path}: not a torch state_dict checkpoint')
    ref_shapes = _param_shapes()
    missing = sorted(set(ref_shapes) - set(state))
    if missing:
        raise ValueError(f'{path}: not Resemblyzer VoiceEncoder weights '
                         f'(missing keys e.g. {missing[:3]})')
    params = {k: state[k].detach().cpu().numpy() for k in ref_shapes}
    bad = {k: (params[k].shape, s) for k, s in ref_shapes.items()
           if params[k].shape != s}
    if bad:
        raise ValueError(f'{path}: VoiceEncoder weight shapes mismatch {bad}')
    return params


def normalize_volume(wav: np.ndarray,
                     target_dbfs: float = AUDIO_NORM_TARGET_DBFS,
                     increase_only: bool = False,
                     decrease_only: bool = False) -> np.ndarray:
    """resemblyzer audio.py normalize_volume: scale to a target dBFS."""
    power = float(np.mean(np.square(wav))) if len(wav) else 0.0
    if power <= 0:
        return wav
    change = target_dbfs - 10.0 * np.log10(power)
    if (change < 0 and increase_only) or (change > 0 and decrease_only):
        return wav
    return wav * (10.0 ** (change / 20.0))


def preprocess_for_embedding(wav: np.ndarray, source_sr: int) -> np.ndarray:
    """resemblyzer's ``preprocess_wav`` on the host: resample to 16 kHz,
    normalise the volume to -30 dBFS (increase only), then trim long
    silences with resemblyzer's VAD constants (window 30 ms, moving average
    8, max silence 6; webrtcvad where installed, else the energy VAD).
    Returns a 16 kHz waveform for ``embed_utterance(..., source_sr=16000)``
    (reference preprocess.py:80,181)."""
    from forwardtacotron_torch.dsp.dsp import DSP, resample
    wav = np.asarray(wav, np.float32)
    if source_sr != SAMPLE_RATE:
        wav = resample(wav, source_sr, SAMPLE_RATE)
    wav = normalize_volume(wav, increase_only=True)
    # the trim is numpy code: its DSP needs no device
    vad = DSP(num_mels=MEL_N_CHANNELS, sample_rate=SAMPLE_RATE,
              hop_length=MEL_HOP, win_length=MEL_N_FFT, n_fft=MEL_N_FFT,
              fmin=0.0, fmax=SAMPLE_RATE / 2.0,
              vad_sample_rate=SAMPLE_RATE,
              vad_window_length=VAD_WINDOW_LENGTH,
              vad_moving_average_width=VAD_MOVING_AVERAGE_WIDTH,
              vad_max_silence_length=VAD_MAX_SILENCE_LENGTH, device='cpu')
    return vad.trim_long_silences(wav)


def wav_to_mel_spectrogram(wav: torch.Tensor) -> torch.Tensor:
    """16 kHz samples -> 40-mel POWER spectrogram [frames, 40] (no log; 25 ms
    window, 10 ms hop, librosa's melspectrogram defaults), on the
    samples' device in float32 (resemblyzer/audio.py)."""
    from forwardtacotron_torch.dsp.mel import mel_filterbank
    from forwardtacotron_torch.ops.stft import stft_magnitude
    mag = stft_magnitude(wav.float(), MEL_N_FFT, MEL_HOP, MEL_N_FFT)
    fb = torch.as_tensor(mel_filterbank(SAMPLE_RATE, MEL_N_FFT,
                                        MEL_N_CHANNELS, 0.0,
                                        SAMPLE_RATE / 2.0),
                         device=wav.device)
    return (fb @ mag.float() ** 2).T


def compute_partial_slices(n_samples: int) -> Tuple[list, list]:
    """resemblyzer ``VoiceEncoder.compute_partial_slices`` with the default
    partial length and overlap: (wav_slices, mel_slices)."""
    samples_per_frame = MEL_HOP
    frame_step = max(int(np.round(PARTIAL_N_FRAMES * (1 - OVERLAP))), 1)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))

    wav_slices, mel_slices = [], []
    steps = max(1, n_frames - PARTIAL_N_FRAMES + frame_step + 1)
    for i in range(0, steps, frame_step):
        mel_range = np.array([i, i + PARTIAL_N_FRAMES])
        wav_range = mel_range * samples_per_frame
        mel_slices.append(slice(*mel_range))
        wav_slices.append(slice(*wav_range))

    last_wav_range = wav_slices[-1]
    coverage = (n_samples - last_wav_range.start) \
        / (last_wav_range.stop - last_wav_range.start)
    if coverage < MIN_PAD_COVERAGE and len(mel_slices) > 1:
        mel_slices = mel_slices[:-1]
        wav_slices = wav_slices[:-1]
    return wav_slices, mel_slices


class VoiceEncoder(nn.Module):
    """resemblyzer.VoiceEncoder, limited to embedding utterances, on
    ``device`` (CUDA unless the caller names another; resolved before any
    weights are read). ``params``: a published-layout dict (see
    ``load_resemblyzer_weights``), else the weights of ``weights_path``,
    else a seeded random draw whose embeddings carry no speaker
    identity."""

    def __init__(self, params: Optional[Dict[str, np.ndarray]] = None,
                 weights_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.lstm = nn.LSTM(MEL_N_CHANNELS, MODEL_HIDDEN, MODEL_LAYERS,
                            batch_first=True)
        self.linear = nn.Linear(MODEL_HIDDEN, MODEL_EMB)
        self.relu = nn.ReLU()
        if params is None:
            params = (load_resemblyzer_weights(weights_path)
                      if weights_path is not None
                      else init_voice_encoder_params())
        self.load_state_dict({k: torch.tensor(np.asarray(v))
                              for k, v in params.items()})
        self.to(self.device).eval()

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        """[B, T, 40] mel partials -> [B, 256] L2-normalised embeddings."""
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            _, (hidden, _) = self.lstm(mels)
        raw = self.relu(self.linear(hidden[-1]))
        return raw / torch.clamp(torch.norm(raw, dim=1, keepdim=True),
                                 min=1e-8)

    @torch.inference_mode()
    def embed_frames_batch(self, mels: np.ndarray) -> np.ndarray:
        """[B, T, 40] -> [B, 256]."""
        x = torch.as_tensor(np.asarray(mels, np.float32), device=self.device)
        return self(x).cpu().numpy()

    @torch.inference_mode()
    def embed_utterance(self, wav: np.ndarray,
                        source_sr: int = SAMPLE_RATE) -> np.ndarray:
        """One utterance -> one L2-normalised [256] d-vector (resemblyzer's
        ``embed_utterance`` with the default partials; volume and VAD
        preprocessing, ``preprocess_for_embedding``, is the caller's)."""
        from forwardtacotron_torch.dsp.dsp import resample
        wav = np.asarray(wav, np.float32)
        if source_sr != SAMPLE_RATE:
            wav = resample(wav, source_sr, SAMPLE_RATE)
        wav_slices, mel_slices = compute_partial_slices(len(wav))
        max_wave_length = wav_slices[-1].stop
        if max_wave_length >= len(wav):
            wav = np.pad(wav, (0, max_wave_length - len(wav)))
        mel = wav_to_mel_spectrogram(torch.as_tensor(wav, device=self.device))
        partials = torch.stack([mel[s] for s in mel_slices])
        raw = self(partials).mean(dim=0)
        return (raw / torch.clamp(torch.norm(raw), min=1e-8)).cpu().numpy()
