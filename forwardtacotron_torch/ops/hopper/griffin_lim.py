"""Griffin-Lim with a fused per-iteration kernel: ``griffin_lim.cu`` and its
plain twin.

Port of forwardtacotron_tpu/ops/pallas/griffin_lim.py. Because istft's
overlap-add and stft's framing share the hop, the frames -> frames map of
one iteration is banded: output frame i depends on the windowed IDFT frames
i-(R-1) .. i+(R-1), R = n_fft // hop,

    y_i[t] = q[t] * sum_d f_{i-d}[t + d*hop],   q = win / p(t mod hop),

with p the hop-periodic interior of the squared-window OLA normalizer. The
identity holds for interior frames; the first and last R frames (partial
normalizer, reflect padding) take their exact values from the true
normalizer ``winsq`` (:func:`ola_normalizer`): the kernel builds them from
the IDFT frames it has just computed, the twin by :func:`edge_frames` (the
JAX package's ``_edge_frames``), so an iteration on the card is its two
launches alone.

Spectra are frames-major [B, F, bins] with no bin padding.
``griffin_lim_iter`` launches the kernel for CUDA tensors and runs the plain
twin for CPU tensors; nothing else selects between them.
"""

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from forwardtacotron_torch.ops.hopper import build
from forwardtacotron_torch.ops.stft import (_dft_matrices, _ola_win_sq,
                                            istft_pair, padded_window)

# iterations run by the CUDA kernel since the count was last set to 0
launches = 0

# griffin_lim.cu's tile: K steps of 32 rows, 128 output columns per CTA;
# the kernel's weight matrices are padded to whole tiles
TILE_K, TILE_N = 32, 128


class GLConstants(NamedTuple):
    inv_w: torch.Tensor    # [2*bins, n_fft]: [inv_re ; inv_im], window folded
    fwd_re: torch.Tensor   # [n_fft, bins]
    fwd_im: torch.Tensor   # [n_fft, bins]
    q: torch.Tensor        # [n_fft]
    win: torch.Tensor      # [n_fft]
    # the kernel's copies: inv_w padded to [2 bins, n_fft] rounded up to
    # (TILE_K, TILE_N); [fwd_re | fwd_im] with columns (2k, 2k + 1) = bin
    # k's (re, im), padded to [n_fft, 2 bins] rounded up likewise
    inv_pad: torch.Tensor
    fwd_pad: torch.Tensor


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@lru_cache(maxsize=8)
def _constants_np(n_fft: int, hop: int, win_length: int):
    fwd_re, fwd_im, inv_re, inv_im = _dft_matrices(n_fft)
    bins = n_fft // 2 + 1
    win = padded_window(win_length, n_fft).astype(np.float32)
    p = np.zeros(hop, np.float64)
    for j in range(n_fft // hop):
        p += (win[j * hop:(j + 1) * hop] ** 2).astype(np.float64)
    p = np.maximum(p, 1e-10)
    q = (win / np.tile(p, n_fft // hop)).astype(np.float32)
    inv_w = np.concatenate([inv_re * win[None, :],
                            inv_im * win[None, :]]).astype(np.float32)
    inv_pad = np.zeros((_round_up(2 * bins, TILE_K),
                        _round_up(n_fft, TILE_N)), np.float32)
    inv_pad[:2 * bins, :n_fft] = inv_w
    fwd_pad = np.zeros((_round_up(n_fft, TILE_K),
                        _round_up(2 * bins, TILE_N)), np.float32)
    fwd_pad[:n_fft, 0:2 * bins:2] = fwd_re
    fwd_pad[:n_fft, 1:2 * bins:2] = fwd_im
    return inv_w, fwd_re, fwd_im, q, win, inv_pad, fwd_pad


def gl_constants(n_fft: int, hop: int, win_length: int,
                 device: torch.device) -> GLConstants:
    """The constants on ``device``, copied there once (read only)."""
    return _constants_on(n_fft, hop, win_length, torch.device(device))


@lru_cache(maxsize=8)
def _constants_on(n_fft: int, hop: int, win_length: int,
                  device: torch.device) -> GLConstants:
    return GLConstants(*(torch.as_tensor(np.ascontiguousarray(a),
                                         device=device)
                         for a in _constants_np(n_fft, hop, win_length)))


def ola_normalizer(n_fft: int, hop: int, n_frames: int, win_length: int,
                   device: torch.device) -> torch.Tensor:
    """The squared-window OLA normalizer of an n_frames signal."""
    return torch.as_tensor(_ola_win_sq(n_fft, hop, n_frames, win_length),
                           device=device)


def edge_frames(spec_re: torch.Tensor, spec_im: torch.Tensor, hop: int,
                consts: GLConstants, winsq: torch.Tensor) -> torch.Tensor:
    """Exact pre-DFT values of the first and last R frames, from the first
    and last 2R-1 spectrum rows with the true OLA normalizer ``winsq``
    (:func:`ola_normalizer`) and reflect padding. spec [B, F, bins] ->
    [B, 2R, n_fft] (R head rows, then R tail rows)."""
    b, n_frames, bins = spec_re.shape
    n_fft = consts.q.shape[0]
    r = n_fft // hop
    k = 2 * r - 1
    half = n_fft // 2
    seg = (k - 1) * hop + n_fft
    inv_re, inv_im = consts.inv_w[:bins], consts.inv_w[bins:]

    def ola(rows):
        sig = torch.zeros(b, seg, dtype=rows.dtype, device=rows.device)
        for j in range(k):
            sig[:, j * hop:j * hop + n_fft] += rows[:, j]
        return sig

    # head: frames 0 .. R-1
    raw = ola(spec_re[:, :k] @ inv_re + spec_im[:, :k] @ inv_im) / winsq[:seg]
    sig = raw[:, half:]
    sig_pad = torch.cat([sig[:, 1:half + 1].flip(-1), sig], dim=1)
    head = torch.stack([sig_pad[:, i * hop:i * hop + n_fft]
                        for i in range(r)], dim=1)

    # tail: frames F-R .. F-1, from a segment starting at raw offset `off`
    off = (n_frames - k) * hop
    raw_t = ola(spec_re[:, n_frames - k:] @ inv_re
                + spec_im[:, n_frames - k:] @ inv_im) / winsq[off:off + seg]
    sig_t = raw_t[:, half:][:, :hop * (n_frames - 1) - off]
    sig_tpad = torch.cat([sig_t, sig_t[:, -half - 1:-1].flip(-1)], dim=1)
    start0 = (n_frames - r) * hop - half - off
    tail = torch.stack([sig_tpad[:, start0 + j * hop:start0 + j * hop + n_fft]
                        for j in range(r)], dim=1)
    return torch.cat([head, tail], dim=1) * consts.win


def pre_dft_frames(spec_re, spec_im, winsq, consts: GLConstants,
                   hop: int) -> torch.Tensor:
    """The frames an iteration takes the DFT of, [B, F, n_fft]: the banded
    OLA of the IDFT frames times q, the first and last R frames from
    :func:`edge_frames`."""
    _, n_frames, bins = spec_re.shape
    n_fft = consts.q.shape[0]
    r = n_fft // hop
    repl = edge_frames(spec_re, spec_im, hop, consts, winsq)
    f = spec_re @ consts.inv_w[:bins] + spec_im @ consts.inv_w[bins:]
    y = torch.zeros_like(f)
    for d in range(-(r - 1), r):
        i0, i1 = max(0, d), n_frames + min(0, d)
        t0, t1 = max(0, -d * hop), n_fft - max(0, d * hop)
        y[:, i0:i1, t0:t1] += f[:, i0 - d:i1 - d, t0 + d * hop:t1 + d * hop]
    y = y * consts.q
    y[:, :r] = repl[:, :r]
    y[:, n_frames - r:] = repl[:, r:]
    return y


def griffin_lim_iter_plain(spec_re, spec_im, tp_re, tp_im, mag, winsq,
                           consts: GLConstants, hop: int,
                           momentum: float = 0.99):
    """One iteration: returns (spec_re, spec_im, rb_re, rb_im), where rb is
    the rebuilt spectrum (the next iteration's momentum term). All spectra
    [B, F, bins]; winsq is the OLA normalizer of F frames
    (:func:`ola_normalizer`), from which :func:`edge_frames` makes the
    first and last R frames."""
    y = pre_dft_frames(spec_re, spec_im, winsq, consts, hop)
    rb_re = y @ consts.fwd_re
    rb_im = y @ consts.fwd_im
    c = momentum / (1.0 + momentum)
    up_re = rb_re - c * tp_re
    up_im = rb_im - c * tp_im
    mod = torch.clamp(torch.sqrt(up_re * up_re + up_im * up_im), min=1e-16)
    return mag * up_re / mod, mag * up_im / mod, rb_re, rb_im


def _kernel():
    fn = build.library('griffin_lim').gl_iter_f32
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def griffin_lim_iter(spec_re, spec_im, tp_re, tp_im, mag, winsq,
                     consts: GLConstants, hop: int, momentum: float = 0.99):
    """Same contract as :func:`griffin_lim_iter_plain`, two kernel launches
    on the GPU (the IDFT product; then the OLA, the edge frames, the DFT
    product and the update)."""
    if spec_re.device.type == 'cpu':
        return griffin_lim_iter_plain(spec_re, spec_im, tp_re, tp_im, mag,
                                      winsq, consts, hop, momentum)
    if spec_re.device.type != 'cuda':
        raise ValueError(f'griffin_lim_iter: unsupported device '
                         f'{spec_re.device}')
    b, n_frames, bins = spec_re.shape
    n_fft = consts.q.shape[0]
    r = n_fft // hop
    args = (spec_re, spec_im, tp_re, tp_im, mag, winsq, consts.inv_pad,
            consts.fwd_pad, consts.q, consts.win)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != spec_re.device for t in args):
        raise ValueError('griffin_lim_iter: every input must be a '
                         'contiguous float32 tensor on the same device')
    if (any(t.shape != spec_re.shape for t in (spec_im, tp_re, tp_im, mag))
            or winsq.shape != ((n_frames - 1) * hop + n_fft,) or n_fft % hop
            or bins != n_fft // 2 + 1 or n_frames < 2 * r
            or consts.inv_pad.shape != (_round_up(2 * bins, TILE_K),
                                        _round_up(n_fft, TILE_N))
            or consts.fwd_pad.shape != (_round_up(n_fft, TILE_K),
                                        _round_up(2 * bins, TILE_N))):
        raise ValueError('griffin_lim_iter: bad shapes')
    frames = torch.empty(b, n_frames, n_fft, dtype=torch.float32,
                         device=spec_re.device)
    outs = [torch.empty_like(spec_re) for _ in range(4)]
    status = _kernel()(*(build.ptr(t) for t in args), build.ptr(frames),
                       *(build.ptr(t) for t in outs), b, n_frames, bins,
                       n_fft, hop, momentum / (1.0 + momentum),
                       spec_re.get_device(), build.stream_of(spec_re))
    build.check(status, 'griffin_lim_iter')
    global launches
    launches += 1
    return tuple(outs)


def griffin_lim_fused(magnitude: torch.Tensor, phase: torch.Tensor,
                      n_fft: int, hop_length: int, win_length: int,
                      n_iter: int = 32, momentum: float = 0.99
                      ) -> torch.Tensor:
    """Batched Griffin-Lim, one fused iteration per step.

    magnitude and the initial phase (radians) are [B, bins, F], the
    griffin_lim layout, batched. Needs hop | n_fft and F >= 2R (the edge
    computation reads 2R-1 rows at each end). Returns [B, samples]; the
    same algorithm as ops.stft.griffin_lim_pair."""
    if n_fft % hop_length:
        raise NotImplementedError('fused Griffin-Lim requires hop | n_fft')
    r = n_fft // hop_length
    if magnitude.shape[-1] < 2 * r:
        raise ValueError(f'fused Griffin-Lim needs >= {2 * r} frames, got '
                         f'{magnitude.shape[-1]}')
    consts = gl_constants(n_fft, hop_length, win_length, magnitude.device)
    mag = magnitude.transpose(1, 2).contiguous()
    phase = phase.transpose(1, 2)
    spec_re = (mag * torch.cos(phase)).contiguous()
    spec_im = (mag * torch.sin(phase)).contiguous()
    tp_re = torch.zeros_like(mag)
    tp_im = torch.zeros_like(mag)
    winsq = ola_normalizer(n_fft, hop_length, mag.shape[1], win_length,
                           mag.device)
    for _ in range(n_iter):
        spec_re, spec_im, tp_re, tp_im = griffin_lim_iter(
            spec_re, spec_im, tp_re, tp_im, mag, winsq, consts, hop_length,
            momentum)
    return istft_pair(spec_re, spec_im, n_fft, hop_length, win_length)
