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
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from forwardtacotron_torch.ops.hopper import build
from forwardtacotron_torch.ops.hopper import mrf as mrf_ops

# the kernel's limits: phases out of one level (the JAX gate's); any number
# of input channels (the input tile loads in chunks of them where it does
# not fit whole, ``mrf.plan``); the input tile's halo is IN_HALO rows, or
# the farthest upsampler tap's reach where that is more (in_halo)
MAX_PHASES = 4
IN_HALO = mrf_ops.IN_HALO

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


def tap_reach(s_up: int, k_up: int) -> int:
    """Input rows the farthest upsampler tap reads away from its output's
    own input sample."""
    pad_up = k_up - 1 - (k_up - s_up) // 2
    return max(-((-pad_up) // s_up), (s_up - 1 + k_up - 1 - pad_up) // s_up)


def in_halo(s_up: int, k_up: int) -> int:
    """Input rows of halo the kernel's input tile keeps on each side:
    IN_HALO, or :func:`tap_reach` where the taps reach farther."""
    return max(IN_HALO, tap_reach(s_up, k_up))


def level_error(s_in: int, s_up: int, c_in: int,
                k_up: int) -> Optional[str]:
    """Why no plan can take the upsample of this level, or None."""
    if s_up < 2 or s_in < 1 or s_in * s_up > MAX_PHASES:
        return (f'upsample rate {s_up} after {s_in} phases: the kernel takes '
                f'rates of at least 2 and at most {MAX_PHASES} phases out')
    if k_up < s_up or (k_up - s_up) % 2:
        return (f'upsampler kernel size {k_up} at rate {s_up}: the kernel '
                f'takes k >= s with k - s even')
    if c_in < 1:
        return f'C_in={c_in}: the kernel takes at least 1 input channel'
    return None


def pallas_vmem_bytes(s_in: int, s_up: int, c_in: int, c: int, k_up: int,
                      krs: Sequence[int], n_units: int, elt: int) -> int:
    """At least the VMEM one ``ups_mrf_pallas`` step holds at its smallest
    tile (128 lanes), as the JAX generator calls it: its unblocked weights
    (the upsampler's kernel in the activation's dtype and its float32 bias,
    the MRF's weights with float32 biases) and the double-buffered input
    window, input and output masks and output blocks, in an ``elt``-byte
    dtype (ops/pallas/mrf.py:293-330)."""
    s_out = s_in * s_up
    t_tile = 128
    t_w = t_tile + 2 * (-(-mrf_ops.HALO // s_out) + 8)
    weights = (k_up * c_in * c * elt + 4 * c
               + sum(2 * n_units * (c * kr * c * elt + 4 * c) for kr in krs))
    blocks = 2 * (s_in * c_in * t_w + 2 * t_w + s_out * c * t_tile) * elt
    return weights + blocks


def plan(dtype: torch.dtype, s_in: int, s_up: int, c_in: int, c: int,
         k_up: int, krs: Sequence[int], dils: Sequence[int],
         smem_limit: Optional[int] = None) -> dict:
    """The launch plan of one level of the tail (``mrf.plan`` with the
    upsample's input tile and kept output, past the old shapes only where
    :func:`pallas_vmem_bytes` stays within the Pallas kernel's scoped
    limit); raises ValueError with the reason where none fits. Needs no
    card."""
    err = level_error(s_in, s_up, c_in, k_up)
    if err:
        raise ValueError(err)
    elt = 2 if dtype == torch.bfloat16 else 4
    return mrf_ops.plan(dtype, c, krs, dils, c_in=c_in, s_out=s_in * s_up,
                        s_up=s_up, smem_limit=smem_limit,
                        in_halo=in_halo(s_up, k_up),
                        pallas_need=pallas_vmem_bytes(
                            s_in, s_up, c_in, c, k_up, krs, len(dils), elt))


def shape_error(s_in: int, s_up: int, c_in: int, c: int, k_up: int,
                krs: Sequence[int], dils: Sequence[int],
                dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """Why the kernel cannot take this level in ``dtype`` (default:
    float32 or bfloat16), or None when it can. Needs no card: the wrapper
    raises with it, and the generator's gate consults it for every level
    of the tail with the activation's dtype."""
    for dt in (dtype,) if dtype else (torch.float32, torch.bfloat16):
        try:
            plan(dt, s_in, s_up, c_in, c, k_up, krs, dils)
        except ValueError as e:
            return str(e)
    return None


def up_taps(s_up: int, k_up: int):
    """The upsampler's taps (indices into the packed [k, C, C_in] weight)
    in the kernel's order: per output phase r of the stride, the taps
    m_first(r) + j * s_up."""
    pad_up = k_up - 1 - (k_up - s_up) // 2
    return [list(range((pad_up - r) % s_up, k_up, s_up))
            for r in range(s_up)]


def pack_weights(up_w: torch.Tensor, s_up: int,
                 weights: Tuple[torch.Tensor, ...], krs: Sequence[int],
                 cs: int, wide: bool = False, cw: int = 0) -> torch.Tensor:
    """The level's upsampler taps ([k, C, C_in], C and C_in padded to the
    plan's) in the kernel's phase order (:func:`up_taps`; each phase's
    stages chunk-major where the input tile loads in chunks of ``cw``
    channels), then its MRF weights (``mrf.pack_weights``), as the bf16
    ring streams them: [C / cs, stages * cs * KC]."""
    return torch.cat([mrf_ops.product_images(up_w[taps], cs, cw)
                      for taps in up_taps(s_up, up_w.shape[0])]
                     + [mrf_ops.pack_weights(weights, krs, cs, wide)],
                     1).contiguous()


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


def pad_input(x: torch.Tensor, s_in: int, c_in_pad: int) -> torch.Tensor:
    """x [B, s_in*C_in, T] with zero input channels up to ``c_in_pad`` in
    every phase."""
    b, rows, t_ps = x.shape
    c_in = rows // s_in
    return F.pad(x.reshape(b, s_in, c_in, t_ps),
                 (0, 0, 0, c_in_pad - c_in)).reshape(b, s_in * c_in_pad, t_ps)


class Prepared(NamedTuple):
    """A level's weights as the kernel launches them (:func:`prepare`)."""
    up_w: torch.Tensor                  # zero channels up to the plan's
    up_b: torch.Tensor
    weights: Tuple[torch.Tensor, ...]
    packed: Optional[torch.Tensor]      # the bf16 ring's stage images
    c_pad: int
    c_in_pad: int
    cs: int
    table: torch.Tensor                 # ``mrf.branch_table``
    biases: torch.Tensor                # ``mrf.pack_biases``
    krs: Tuple[int, ...]
    dils: Tuple[int, ...]
    wide: bool
    cw: int                             # input channels a tile chunk


def prepare(up_w: torch.Tensor, up_b: torch.Tensor,
            weights: Tuple[torch.Tensor, ...], s_in: int, s_up: int,
            krs: Sequence[int], dils: Sequence[int]) -> Prepared:
    """The level's weights (as :func:`ups_mrf` takes them) with zero input
    channels up to the plan's C_in and zero output channels up to its C (a
    zero output channel has zero upsampler weights and bias and stays zero
    through the MRF, :func:`mrf.pad_weights`, so the first C output
    channels of every phase are unchanged: :func:`unpad_output` takes
    them), and, in bf16, packed into the ring's stage images. Fixed for a
    weight set: a caller that launches the level again passes it to
    :func:`ups_mrf` as ``prepared`` and skips this work."""
    krs, dils = tuple(int(k) for k in krs), tuple(int(d) for d in dils)
    k_up, c, c_in = up_w.shape
    pl = plan(up_w.dtype, int(s_in), int(s_up), c_in, c, k_up, krs, dils)
    c_pad, ci_pad = pl['c_pad'], pl['c_in_pad']
    if (c_pad, ci_pad) != (c, c_in):
        up_w = F.pad(up_w, (0, ci_pad - c_in, 0, c_pad - c)).contiguous()
        up_b = F.pad(up_b, (0, c_pad - c))
        weights = mrf_ops.pad_weights(weights, krs, c, c_pad)
    packed = pack_weights(up_w, int(s_up), weights, krs, pl['cs'],
                          pl['wide'], pl['cw']) \
        if up_w.dtype == torch.bfloat16 else None
    return Prepared(up_w, up_b, weights, packed, c_pad, ci_pad, pl['cs'],
                    mrf_ops.branch_table(weights, krs, dils),
                    mrf_ops.pack_biases(weights, krs), krs, dils,
                    pl['wide'], pl['cw'])


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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                            ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p] \
        + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ups_mrf(x: torch.Tensor, up_w: torch.Tensor, up_b: torch.Tensor,
            weights: Tuple[torch.Tensor, ...], s_in: int, s_up: int,
            krs: Sequence[int], dils: Sequence[int], t_valid: int,
            prepared: Optional[Prepared] = None) -> torch.Tensor:
    """Same contract as :func:`ups_mrf_plain`, one kernel launch on the GPU.

    The kernel takes C as ``mrf.mrf`` does and C_in as a power of two from
    16 to 64 or a multiple of 64 (of the tile's chunk, ``mrf.plan``);
    others are padded with zero channels, which is exact. ``prepared``: :func:`prepare` of these
    weights, made here when not given. What :func:`plan` refuses raises
    ``ValueError``."""
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
    try:
        pl = plan(dt, s_in, s_up, c_in, c, k_up, krs, dils)
    except ValueError as e:
        raise ValueError(f'ups_mrf: {e}') from None
    if not 0 <= t_valid <= t_ps:
        raise ValueError(f'ups_mrf: t_valid={t_valid} outside [0, {t_ps}]')
    for w, shape, wdt in ((up_w, (k_up, c, c_in), dt),
                          (up_b, (c,), torch.float32)):
        if (tuple(w.shape) != shape or w.dtype != wdt
                or w.device != x.device or not w.is_contiguous()
                or w.data_ptr() % 16):
            raise ValueError(f'ups_mrf: expected a contiguous, 16-byte '
                             f'aligned {wdt} {shape} tensor on {x.device}, '
                             f'got {w.dtype} {tuple(w.shape)} on {w.device}')
    mrf_ops.check_weights('ups_mrf', weights, krs, len(dils), c, dt,
                          torch.float32, x.device)
    s_out = s_in * s_up
    c_pad, ci_pad = pl['c_pad'], pl['c_in_pad']
    if ci_pad != c_in:
        x = pad_input(x, s_in, ci_pad)
    out = torch.empty(b, s_out * c_pad, t_ps, dtype=dt, device=x.device)
    if b and t_ps:
        prepared = prepared or prepare(up_w, up_b, weights, s_in, s_up, krs,
                                       dils)
        mrf_ops.check_prepared('ups_mrf', prepared, pl, krs, dils)
        if (prepared.c_in_pad, prepared.cw) != (ci_pad, pl['cw']):
            raise ValueError(f'ups_mrf: the prepared weights are for C_in='
                             f'{prepared.c_in_pad} in chunks of '
                             f'{prepared.cw}, the plan takes {ci_pad} in '
                             f'chunks of {pl["cw"]}')
        status = _kernel(dt)(
            build.ptr(x), build.ptr(out), build.ptr(prepared.up_w),
            build.ptr(prepared.up_b),
            *mrf_ops.launch_args(prepared, krs, dils), b, ci_pad, c_pad,
            s_in, s_up, k_up, t_ps, t_valid, pl['cs'], pl['t_tile'],
            pl['stages'], int(pl['wide']), pl['cw'], x.get_device(),
            build.stream_of(x))
        build.check(status, 'ups_mrf')
        global launches
        launches += 1
    return unpad_output(out, s_out, c)
