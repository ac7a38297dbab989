"""STFT / ISTFT / Griffin-Lim: the complex-free pair path as real matrix
products, and the rfft form for hops that do not divide n_fft.

Port of forwardtacotron_tpu/ops/stft.py: its pair path (the DFT as two
real matmuls, framing and overlap-add as hop-strided reshapes; requires
hop | n_fft) and its rfft form (``frame_signal``, ``stft``, ``stft_magnitude``,
``istft``, ``griffin_lim``: a gather of frames, ``torch.fft``, an index-add overlap;
any hop, 1-D signals, spectra [bins, n_frames]). Conventions follow
librosa as the reference uses it:
center=True with reflect padding, periodic Hann window,
``n_frames = 1 + len(y) // hop`` and magnitude (power=1) spectrograms.
Signals may carry leading batch dimensions; spectra are frames-major
[..., n_frames, bins].

``griffin_lim_pair`` and ``griffin_lim`` take their initial phase as an
argument: the JAX package
draws it with ``jax.random``, which PyTorch cannot reproduce bit for bit, so
callers draw it (``DSP.griffinlim`` from a seeded ``torch.Generator``) or
inject it (the parity tests).
"""

import math
from functools import lru_cache
from typing import Optional

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


# ------------------------------------------------------------- rfft form

def frame_signal(y: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
    """Strided framing: [n] -> [n_frames, frame_length]."""
    n_frames = 1 + (y.shape[-1] - frame_length) // hop_length
    idx = (torch.arange(n_frames, device=y.device)[:, None] * hop_length
           + torch.arange(frame_length, device=y.device)[None, :])
    return y[idx]


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         center: bool = True) -> torch.Tensor:
    """Complex STFT of a 1-D signal -> [1 + n_fft // 2, n_frames]."""
    window = _const(padded_window(win_length, n_fft), y)
    if center:
        y = torch.nn.functional.pad(y[None, None], (n_fft // 2, n_fft // 2),
                                    mode='reflect')[0, 0]
    frames = frame_signal(y, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).T


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int, center: bool = True) -> torch.Tensor:
    """|STFT| of a 1-D signal -> [1 + n_fft // 2, n_frames]."""
    return stft(y, n_fft, hop_length, win_length, center).abs()


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`stft` by windowed overlap-add with the squared
    window's normalization; returns the center-trimmed signal."""
    window = _const(padded_window(win_length, n_fft), spec.real)
    frames = torch.fft.irfft(spec.T, n=n_fft, dim=-1) * window
    n_frames = frames.shape[0]
    total = n_fft + hop_length * (n_frames - 1)
    idx = (torch.arange(n_frames, device=spec.device)[:, None] * hop_length
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    signal = torch.zeros(total, dtype=frames.dtype, device=spec.device)
    signal.index_add_(0, idx, frames.reshape(-1))
    win_sq = torch.zeros(total, dtype=torch.float32, device=spec.device)
    win_sq.index_add_(0, idx, (window ** 2).expand(n_frames, n_fft)
                      .reshape(-1))
    signal = signal / torch.clamp(win_sq, min=1e-10)
    signal = signal[n_fft // 2: total - n_fft // 2]
    return signal if length is None else signal[:length]


def griffin_lim(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int,
                hop_length: int, win_length: int, n_iter: int = 32,
                momentum: float = 0.99) -> torch.Tensor:
    """Griffin-Lim with momentum (librosa-style) on the rfft form, for any
    hop. ``magnitude`` and the initial ``phase`` (radians) are [bins,
    n_frames]; returns the [samples] waveform. Runs no kernel."""
    angles = torch.polar(torch.ones_like(phase), phase)
    mag = magnitude.to(torch.complex64)
    tprev = torch.zeros_like(mag)
    c = momentum / (1 + momentum)
    for _ in range(n_iter):
        rebuilt = stft(istft(mag * angles, n_fft, hop_length, win_length),
                       n_fft, hop_length, win_length)
        update = rebuilt - c * tprev
        angles = update / torch.clamp(update.abs(), min=1e-16)
        tprev = rebuilt
    return istft(mag * angles, n_fft, hop_length, win_length)
