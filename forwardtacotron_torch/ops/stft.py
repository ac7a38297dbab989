"""Complex-free STFT / ISTFT / Griffin-Lim as real matrix products.

Port of the pair path of forwardtacotron_tpu/ops/stft.py (the DFT as two
real matmuls, framing and overlap-add as hop-strided reshapes; requires
hop | n_fft). Conventions follow librosa as the reference uses it:
center=True with reflect padding, periodic Hann window,
``n_frames = 1 + len(y) // hop`` and magnitude (power=1) spectrograms.
Signals may carry leading batch dimensions; spectra are frames-major
[..., n_frames, bins].

``griffin_lim_pair`` takes its initial phase as an argument: the JAX package
draws it with ``jax.random``, which PyTorch cannot reproduce bit for bit, so
callers draw it (``DSP.griffinlim`` from a seeded ``torch.Generator``) or
inject it (the parity tests).
"""

import math
from functools import lru_cache

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann', N, fftbins=True))."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window centered in an n_fft frame."""
    pad = n_fft - win_length
    return np.pad(hann_window(win_length), (pad // 2, pad - pad // 2))


@lru_cache(maxsize=8)
def _dft_matrices(n_fft: int):
    """Forward DFT (cos, -sin) [n_fft, bins] and inverse real-synthesis
    bases [bins, n_fft] (irfft weights folded: DC/Nyquist once, others
    twice)."""
    bins = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None] * np.arange(bins)[None, :] \
        * (2.0 * np.pi / n_fft)
    fwd_re = np.cos(k).astype(np.float32)
    fwd_im = (-np.sin(k)).astype(np.float32)
    w = np.full(bins, 2.0 / n_fft, np.float64)
    w[0] = w[-1] = 1.0 / n_fft
    inv_re = (np.cos(k.T) * w[:, None]).astype(np.float32)
    inv_im = (-np.sin(k.T) * w[:, None]).astype(np.float32)
    return fwd_re, fwd_im, inv_re, inv_im


@lru_cache(maxsize=32)
def _ola_win_sq(n_fft: int, hop: int, n_frames: int,
                win_length: int) -> np.ndarray:
    """Squared-window overlap-add normalizer, floored at 1e-10."""
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length)
                              / win_length))
    lpad = (n_fft - win_length) // 2
    window = np.zeros(n_fft, np.float64)
    window[lpad:lpad + win_length] = win
    window = window ** 2
    total = n_fft + hop * (n_frames - 1)
    acc = np.zeros(total, np.float32)
    for f in range(n_frames):
        acc[f * hop: f * hop + n_fft] += window
    return np.maximum(acc, 1e-10)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _frame_by_reshape(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., S] (center-padded) -> [..., F, n_fft] via n_fft/hop strided
    reshapes. Requires hop | n_fft."""
    s = y.shape[-1]
    f = 1 + (s - n_fft) // hop
    lead = y.shape[:-1]
    chunks = [y[..., j * hop:j * hop + f * hop].reshape(*lead, f, hop)
              for j in range(n_fft // hop)]
    return torch.cat(chunks, dim=-1)


def stft_pair(y: torch.Tensor, n_fft: int, hop_length: int,
              win_length: int, center: bool = True):
    """STFT of [..., S] signals as a real pair (re, im), each
    [..., n_frames, bins]."""
    if n_fft % hop_length:
        raise NotImplementedError('the pair STFT requires hop | n_fft')
    if center:
        half = n_fft // 2
        lead = y.shape[:-1]
        y = torch.nn.functional.pad(y.reshape(-1, 1, y.shape[-1]),
                                    (half, half), mode='reflect')
        y = y.reshape(*lead, y.shape[-1])
    window = _const(padded_window(win_length, n_fft), y)
    frames = _frame_by_reshape(y, n_fft, hop_length) * window
    fwd_re, fwd_im, _, _ = _dft_matrices(n_fft)
    re = frames @ _const(fwd_re, y)
    im = frames @ _const(fwd_im, y)
    return re, im


def istft_pair(re: torch.Tensor, im: torch.Tensor, n_fft: int,
               hop_length: int, win_length: int) -> torch.Tensor:
    """Inverse of :func:`stft_pair`: [..., n_frames, bins] -> [..., samples]."""
    if n_fft % hop_length:
        raise NotImplementedError('the pair ISTFT requires hop | n_fft')
    _, _, inv_re, inv_im = _dft_matrices(n_fft)
    frames = re @ _const(inv_re, re) + im @ _const(inv_im, re)
    frames = frames * _const(padded_window(win_length, n_fft), re)
    f = frames.shape[-2]
    hop = hop_length
    lead = frames.shape[:-2]
    total = n_fft + hop * (f - 1)
    signal = torch.zeros(*lead, total, dtype=frames.dtype,
                         device=frames.device)
    for j in range(n_fft // hop):
        part = frames[..., j * hop:(j + 1) * hop].reshape(*lead, f * hop)
        signal[..., j * hop:j * hop + f * hop] += part
    signal = signal / _const(_ola_win_sq(n_fft, hop, f, win_length), re)
    return signal[..., n_fft // 2: total - n_fft // 2]


def griffin_lim_pair(magnitude: torch.Tensor, phase: torch.Tensor,
                     n_fft: int, hop_length: int, win_length: int,
                     n_iter: int = 32, momentum: float = 0.99
                     ) -> torch.Tensor:
    """Griffin-Lim with momentum (librosa-style) on the pair path.

    ``magnitude`` and the initial ``phase`` (radians) are [bins, n_frames],
    the griffin_lim layout. Returns the [samples] waveform. This is the plain
    version of the fused iteration in ops/hopper/griffin_lim.py and the path
    for mels shorter than that kernel's 2R-frame minimum."""
    mag = magnitude.T
    ang_re, ang_im = torch.cos(phase.T), torch.sin(phase.T)
    tp_re = torch.zeros_like(mag)
    tp_im = torch.zeros_like(mag)
    c = momentum / (1 + momentum)
    for _ in range(n_iter):
        inverse = istft_pair(mag * ang_re, mag * ang_im, n_fft, hop_length,
                             win_length)
        rb_re, rb_im = stft_pair(inverse, n_fft, hop_length, win_length)
        up_re = rb_re - c * tp_re
        up_im = rb_im - c * tp_im
        mod = torch.clamp(torch.sqrt(up_re ** 2 + up_im ** 2), min=1e-16)
        ang_re, ang_im, tp_re, tp_im = up_re / mod, up_im / mod, rb_re, rb_im
    return istft_pair(mag * ang_re, mag * ang_im, n_fft, hop_length,
                      win_length)


def initial_phase(shape, seed: int) -> torch.Tensor:
    """Uniform phases in [0, 2*pi) from a CPU ``torch.Generator`` seeded
    with ``seed`` (the same draw on every device)."""
    gen = torch.Generator(device='cpu').manual_seed(seed)
    return 2.0 * math.pi * torch.rand(shape, generator=gen,
                                      dtype=torch.float32)
