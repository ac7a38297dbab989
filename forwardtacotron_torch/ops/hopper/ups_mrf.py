"""One whole level of HiFi-GAN's phase-stacked tail (leaky -> transposed-
conv upsample -> MRF): the ``ups_mrf`` entries of ``mrf.cu`` and their
plain twin, in float32 or bfloat16.

Port of forwardtacotron_tpu/ops/pallas/mrf.py::ups_mrf_pallas. Activations
are phase-stacked channels-major: in x [B, s*C, T_ps], sample s*t + r of
channel c sits at row r*C + c, lane t, so a level's upsample never
interleaves samples in device memory. ``ups_mrf`` launches the CUDA kernel
for CUDA tensors and runs the plain twin for CPU tensors; nothing else
selects between them. There is no gradient: the vocoder only serves.
"""

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from forwardtacotron_torch.ops.hopper import build
from forwardtacotron_torch.ops.hopper import mrf as mrf_ops

# the kernel's limits: upsample rates, phases out of one level, input
# channels and upsampler taps. At C_in 128 and C 64 a bf16 CTA holds the
# MRF window, the de-interleaved input tile (in the buffer of the unit's
# activation, dead while the upsample runs) and two staged [C, C_in]
# upsampler taps in 229,632 of a block's 232,448 bytes of shared memory.
RATES = (2, 4)
MAX_PHASES = 4
MAX_C_IN = 128
MAX_K_UP = 16

# launches of the CUDA kernel since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: 'ups_mrf_f32', torch.bfloat16: 'ups_mrf_bf16'}


def pack_up_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch ``ConvTranspose1d`` weight [C_in, C_out, k] -> the kernel's
    [k, C_out, C_in]: per tap the [C_out, C_in] matrix, C_in contiguous,
    with the taps reversed. (The JAX package's ``TransposedConv1d``
    parameter is the same taps as [k, C_in, C_out].)"""
    return weight.permute(2, 1, 0).flip(0)


def phase_stack(x: torch.Tensor, s: int) -> torch.Tensor:
    """[B, C, s*T] -> [B, s*C, T]: sample s*t + r of channel c to row
    r*C + c, lane t."""
    b, c, n = x.shape
    return x.reshape(b, c, n // s, s).permute(0, 3, 1, 2).reshape(
        b, s * c, n // s)


def phase_unstack(x: torch.Tensor, s: int) -> torch.Tensor:
    """The inverse of :func:`phase_stack`: [B, s*C, T] -> [B, C, s*T]."""
    b, rows, t = x.shape
    return x.reshape(b, s, rows // s, t).permute(0, 2, 3, 1).reshape(
        b, rows // s, s * t)


def shape_error(s_in: int, s_up: int, c_in: int, c: int, k_up: int,
                krs: Sequence[int], dils: Sequence[int]) -> Optional[str]:
    """Why the kernel cannot take this level, or None when it can. Needs no
    card: the wrapper raises with it, and the generator's gate consults it
    for every level of the tail."""
    if s_up not in RATES or s_in not in (1, 2, 4) \
            or s_in * s_up > MAX_PHASES:
        return (f'upsample rate {s_up} after {s_in} phases: the kernel takes '
                f'rates {RATES} and at most {MAX_PHASES} phases out')
    if k_up < s_up or (k_up - s_up) % 2 or k_up > MAX_K_UP:
        return (f'upsampler kernel size {k_up} at rate {s_up}: the kernel '
                f'takes k - s even and k <= {MAX_K_UP}')
    if not 0 < c_in <= MAX_C_IN:
        return (f'C_in={c_in}: the kernel keeps the input tile in shared '
                f'memory, which holds C_in <= {MAX_C_IN}')
    return mrf_ops.shape_error(c, krs, dils)


def ups_mrf_plain(x: torch.Tensor, up_w: torch.Tensor, up_b: torch.Tensor,
                  weights: Tuple[torch.Tensor, ...], s_in: int, s_up: int,
                  krs: Sequence[int], dils: Sequence[int],
                  t_valid: int) -> torch.Tensor:
    """x [B, s_in*C_in, T_ps] -> [B, s_in*s_up*C, T_ps], both phase-stacked.
    up_w [k, C, C_in] in x's dtype (:func:`pack_up_weight`), up_b [C]
    float32; ``weights`` as for :func:`mrf.mrf_plain`, with float32 biases.
    Lanes at or past ``t_valid`` are padding.

    Rounding points, in x's dtype: the leaky (slope 0.1) on the input,
    whose padding lanes are then zeroed; the upsample's float32 sum plus its
    float32 bias, rounded once; the MRF of :func:`mrf.mrf_plain`, each
    convolution's float32 product plus its float32 bias rounded once. The
    output's padding lanes are 0."""
    dt = x.dtype
    b, _, t_ps = x.shape
    k = up_w.shape[0]
    s_out = s_in * s_up
    lane_ok = torch.arange(t_ps, device=x.device) < t_valid
    a = phase_unstack(torch.where(lane_ok, mrf_ops._leaky(x),
                                  torch.zeros((), dtype=dt)), s_in)
    u = F.conv_transpose1d(a.float(), up_w.flip(0).permute(2, 1, 0).float(),
                           stride=s_up, padding=(k - s_up) // 2)
    u = (u + up_b.float()[:, None]).to(dt)
    n = s_out * t_valid
    y = (mrf_ops.mrf_plain(u[..., :n], weights, krs, dils) if n
         else u[..., :0])
    return phase_stack(F.pad(y, (0, s_out * t_ps - n)), s_out)


def pad_channels(x, up_w, up_b, weights, s_in, krs, c_in_pad, c_pad):
    """The level with zero input channels up to ``c_in_pad`` in every phase
    of x and zero output channels up to ``c_pad``: a zero output channel
    has zero upsampler weights and bias and stays zero through the MRF
    (:func:`mrf.pad_weights`), so the first C output channels of every
    phase are unchanged (:func:`unpad_output` takes them)."""
    b, _, t_ps = x.shape
    _, c, c_in = up_w.shape
    x = F.pad(x.reshape(b, s_in, c_in, t_ps),
              (0, 0, 0, c_in_pad - c_in)).reshape(b, s_in * c_in_pad, t_ps)
    return (x, F.pad(up_w, (0, c_in_pad - c_in, 0, c_pad - c)),
            F.pad(up_b, (0, c_pad - c)),
            mrf_ops.pad_weights(weights, krs, c, c_pad))


def unpad_output(out: torch.Tensor, s_out: int, c: int) -> torch.Tensor:
    """The first ``c`` channels of every phase of a padded level's output
    [B, s_out*C_pad, T]."""
    b, rows, t = out.shape
    if rows == s_out * c:
        return out
    return out.reshape(b, s_out, rows // s_out, t)[:, :, :c].reshape(
        b, s_out * c, t)


def _kernel(dtype):
    fn = getattr(build.library('mrf'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ups_mrf(x: torch.Tensor, up_w: torch.Tensor, up_b: torch.Tensor,
            weights: Tuple[torch.Tensor, ...], s_in: int, s_up: int,
            krs: Sequence[int], dils: Sequence[int],
            t_valid: int) -> torch.Tensor:
    """Same contract as :func:`ups_mrf_plain`, one kernel launch on the GPU.

    The kernel takes C and C_in in multiples of 16; others are padded with
    zero channels here, which is exact. What :func:`shape_error` refuses
    raises ``ValueError``."""
    if x.device.type == 'cpu':
        return ups_mrf_plain(x, up_w, up_b, weights, s_in, s_up, krs, dils,
                             t_valid)
    if x.device.type != 'cuda':
        raise ValueError(f'ups_mrf: unsupported device {x.device}')
    krs, dils = tuple(int(k) for k in krs), tuple(int(d) for d in dils)
    s_in, s_up, t_valid = int(s_in), int(s_up), int(t_valid)
    dt = x.dtype
    if dt not in _ENTRY or x.dim() != 3 or not x.is_contiguous():
        raise ValueError('ups_mrf: x must be a contiguous float32 or bfloat16 '
                         f'[B, s_in*C_in, T] tensor, got {dt} '
                         f'{tuple(x.shape)}')
    b, rows, t_ps = x.shape
    if up_w.dim() != 3 or rows != s_in * up_w.shape[2]:
        raise ValueError(f'ups_mrf: x {tuple(x.shape)} does not hold {s_in} '
                         f'phases of the upsampler\'s C_in '
                         f'({tuple(up_w.shape)})')
    k_up, c, c_in = up_w.shape
    err = shape_error(s_in, s_up, c_in, c, k_up, krs, dils)
    if err:
        raise ValueError(f'ups_mrf: {err}')
    if not 0 <= t_valid <= t_ps:
        raise ValueError(f'ups_mrf: t_valid={t_valid} outside [0, {t_ps}]')
    if len(weights) != 4 * len(krs):
        raise ValueError(f'ups_mrf: {len(weights)} weight tensors for '
                         f'{len(krs)} kernel sizes (4 each)')
    u = len(dils)
    wants = [(up_w, (k_up, c, c_in), dt), (up_b, (c,), torch.float32)]
    for i, kr in enumerate(krs):
        for j, shape in enumerate(((u, c, kr * c), (u, c, 1)) * 2):
            wants.append((weights[4 * i + j], shape,
                          torch.float32 if j % 2 else dt))
    for w, shape, wdt in wants:
        if (tuple(w.shape) != shape or w.dtype != wdt
                or w.device != x.device or not w.is_contiguous()
                or w.data_ptr() % 16):
            raise ValueError(f'ups_mrf: expected a contiguous, 16-byte '
                             f'aligned {wdt} {shape} tensor on {x.device}, '
                             f'got {w.dtype} {tuple(w.shape)} on {w.device}')
    s_out = s_in * s_up
    c_pad, ci_pad = -(-c // 16) * 16, -(-c_in // 16) * 16
    if (c_pad, ci_pad) != (c, c_in):
        x, up_w, up_b, weights = pad_channels(x, up_w, up_b, weights, s_in,
                                              krs, ci_pad, c_pad)
    out = torch.empty(b, s_out * c_pad, t_ps, dtype=dt, device=x.device)
    if b and t_ps:
        ptrs = (ctypes.c_void_p * len(weights))(
            *(w.data_ptr() for w in weights))
        status = _kernel(dt)(
            build.ptr(x), build.ptr(out), build.ptr(up_w), build.ptr(up_b),
            ptrs, (ctypes.c_int * len(krs))(*krs), len(krs),
            (ctypes.c_int * u)(*dils), u, b, ci_pad, c_pad, s_in, s_up, k_up,
            t_ps, t_valid, x.get_device(), build.stream_of(x))
        build.check(status, 'ups_mrf')
        global launches
        launches += 1
    return unpad_output(out, s_out, c)
