"""One whole HiFi-GAN MRF level: the ``mrf.cu`` kernel and its plain twin, in
float32 or bfloat16.

Port of forwardtacotron_tpu/ops/pallas/mrf.py::mrf_pallas. Per kernel size
kr, ``len(dils)`` residual units (leaky -> dilated conv(kr, d) -> leaky ->
conv(kr, 1) -> add), then the mean of the kr branches, on channels-major
x [B, C, T]. ``mrf`` launches the CUDA kernel for CUDA tensors and runs the
plain twin for CPU tensors; nothing else selects between them. There is no
gradient: the vocoder only serves, and the TPU kernel has no VJP either.
"""

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from forwardtacotron_torch.ops.hopper import build

LRELU_SLOPE = 0.1
# the kernel's window carries this many samples of halo on each side: at
# least the accumulated span of the deepest branch (kr=11, d=(1,3,5): 60)
HALO = 64
# the kernel keeps a window of [t_tile + 2 * HALO, C] activations twice in
# shared memory, plus a float32 [C, t_tile] branch sum: C is capped there
MAX_CHANNELS = 64
# kernel limits on the number of branches and of units per branch
MAX_BRANCHES, MAX_UNITS = 4, 4

# launches of the CUDA kernel since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: 'mrf_f32', torch.bfloat16: 'mrf_bf16'}


def pack_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """Conv1d weight [C_out, C_in, k] -> [C_out, k * C_in], im2col rows
    j-major (column j * C_in + c_in), the layout of the JAX package's
    ``pack_conv_weight``."""
    c_out, c_in, k = weight.shape
    return weight.permute(0, 2, 1).reshape(c_out, k * c_in)


def branch_span(kr: int, dils: Sequence[int]) -> int:
    """Samples of context one branch reads on each side of an output."""
    return sum((kr // 2) * d + kr // 2 for d in dils)


def _leaky(v: torch.Tensor) -> torch.Tensor:
    # max(v, s * v) with s in the activation's dtype, as the TPU kernel
    # computes it (its slope is a weakly typed constant)
    return torch.maximum(v, v * torch.tensor(LRELU_SLOPE, dtype=v.dtype))


def mrf_plain(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
              krs: Sequence[int], dils: Sequence[int]) -> torch.Tensor:
    """x [B, C, T] -> [B, C, T]. ``weights``: per kr in order (w1 [U, C,
    kr*C], b1 [U, C, 1], w2 [U, C, kr*C], b2 [U, C, 1]), packed as
    :func:`pack_conv_weight`, in x's dtype (the biases may be float32).

    Rounding points, in x's dtype: the leaky; each convolution's float32
    product, then its bias added (a float32 bias is added to the float32
    product and the sum rounded once, as the phase-stacked tail's kernel
    does); the residual add. The branch sum is taken in float32, divided by
    ``len(krs)`` and rounded. Positions outside [0, T) are zero before
    every convolution (the convolutions' zero padding)."""
    dt = x.dtype
    c = x.shape[1]

    def conv(a, w, b, kr, d):
        k = w.reshape(c, kr, c).permute(0, 2, 1)          # [C_out, C_in, kr]
        y = F.conv1d(a.float(), k.float(), padding=(kr // 2) * d, dilation=d)
        if b.dtype == torch.float32:
            return (y + b).to(dt)
        return y.to(dt) + b

    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i, kr in enumerate(krs):
        w1, b1, w2, b2 = weights[4 * i:4 * i + 4]
        cur = x
        for u, d in enumerate(dils):
            y = conv(_leaky(cur), w1[u], b1[u], kr, d)
            cur = cur + conv(_leaky(y), w2[u], b2[u], kr, 1)
        acc = acc + cur.float()
    return (acc / len(krs)).to(dt)


def _kernel(dtype):
    fn = getattr(build.library('mrf'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]\
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pad_weights(weights, krs, c, c_pad):
    """The level's weights with zero channels up to ``c_pad``: a zero
    channel stays zero through every unit (zero weights in and out, zero
    bias), so the first C output channels are unchanged."""
    pc = c_pad - c
    out = []
    for i, kr in enumerate(krs):
        for w, b in (weights[4 * i:4 * i + 2], weights[4 * i + 2:4 * i + 4]):
            u = w.shape[0]
            w4 = F.pad(w.reshape(u, c, kr, c), (0, pc, 0, 0, 0, pc))
            out += [w4.reshape(u, c_pad, kr * c_pad).contiguous(),
                    F.pad(b, (0, 0, 0, pc)).contiguous()]
    return tuple(out)


def shape_error(c: int, krs: Sequence[int],
                dils: Sequence[int]) -> Optional[str]:
    """Why the kernel cannot take a level of ``c`` channels with these
    kernel sizes and dilations, or None when it can. Needs no card: the
    wrapper raises with it, and the generator's gate consults it."""
    if not 0 < c <= MAX_CHANNELS:
        return (f'C={c} is not supported: the kernel keeps a window of '
                f'[t_tile + {2 * HALO}, C] activations twice and a float32 '
                f'[C, t_tile] sum in one block\'s shared memory, which holds '
                f'C <= {MAX_CHANNELS}')
    if not (0 < len(krs) <= MAX_BRANCHES and 0 < len(dils) <= MAX_UNITS):
        return (f'at most {MAX_BRANCHES} kernel sizes and {MAX_UNITS} '
                f'dilations, got {tuple(krs)}, {tuple(dils)}')
    if any(k % 2 == 0 for k in krs) \
            or max(branch_span(k, dils) for k in krs) > HALO:
        return (f'odd kernel sizes whose span fits the {HALO}-sample halo '
                f'only, got {tuple(krs)}, {tuple(dils)}')
    return None


def mrf(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
        krs: Sequence[int], dils: Sequence[int]) -> torch.Tensor:
    """Same contract as :func:`mrf_plain`, one kernel launch on the GPU.

    The kernel takes C <= 64 in multiples of 16; other C are padded with
    zero channels here, which is exact. What :func:`shape_error` refuses
    raises ``ValueError``."""
    if x.device.type == 'cpu':
        return mrf_plain(x, weights, krs, dils)
    if x.device.type != 'cuda':
        raise ValueError(f'mrf: unsupported device {x.device}')
    krs, dils = tuple(int(k) for k in krs), tuple(int(d) for d in dils)
    dt = x.dtype
    if dt not in _ENTRY or x.dim() != 3 or not x.is_contiguous():
        raise ValueError('mrf: x must be a contiguous float32 or bfloat16 '
                         f'[B, C, T] tensor, got {dt} {tuple(x.shape)}')
    b, c, t = x.shape
    err = shape_error(c, krs, dils)
    if err:
        raise ValueError(f'mrf: {err}')
    if len(weights) != 4 * len(krs):
        raise ValueError(f'mrf: {len(weights)} weight tensors for '
                         f'{len(krs)} kernel sizes (4 each)')
    u = len(dils)
    for i, kr in enumerate(krs):
        for j, want in enumerate(((u, c, kr * c), (u, c, 1)) * 2):
            w = weights[4 * i + j]
            if (tuple(w.shape) != want or w.dtype != dt
                    or w.device != x.device or not w.is_contiguous()
                    or w.data_ptr() % 16):
                raise ValueError(
                    f'mrf: weight {4 * i + j} must be a contiguous, '
                    f'16-byte aligned {dt} {want} tensor on {x.device}, got '
                    f'{w.dtype} {tuple(w.shape)} on {w.device}')
    c_pad = -(-c // 16) * 16
    if c_pad != c:
        x = F.pad(x, (0, 0, 0, c_pad - c)).contiguous()
        weights = pad_weights(weights, krs, c, c_pad)
    out = torch.empty_like(x)
    if b == 0 or t == 0:
        return out[:, :c]
    ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    status = _kernel(dt)(
        build.ptr(x), build.ptr(out), ptrs,
        (ctypes.c_int * len(krs))(*krs), len(krs),
        (ctypes.c_int * u)(*dils), u, b, c_pad, t, x.get_device(),
        build.stream_of(x))
    build.check(status, 'mrf')
    global launches
    launches += 1
    return out[:, :c] if c_pad != c else out
