"""The CBHG highway stack, alone or behind the residual add and the
pre_highway Dense: the two entries of the ``highway.cu`` kernel and their
plain twins, in float32 or bfloat16.

Port of forwardtacotron_tpu/ops/pallas/highway.py::pre_highway_stack_pallas
(``pre_highway_stack``) and ::highway_stack_pallas (``highway_stack``).
Each wrapper launches the CUDA kernel for CUDA tensors and runs its plain
twin for CPU tensors; nothing else selects between them.
"""

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from forwardtacotron_torch.ops.hopper import build

# the kernel keeps two float32 [R, max(C_in, C)] row tiles in a block's
# 232,448 bytes of shared memory, R from 32 rows down to 1 as rows widen
MAX_WIDTH = 232448 // (2 * 1 * 4)

# launches of each entry since its count was last set to 0
launches = 0          # pre_highway_stack
stack_launches = 0    # highway_stack

_ENTRY = {torch.float32: 'pre_highway_stack_f32',
          torch.bfloat16: 'pre_highway_stack_bf16'}
_STACK_ENTRY = {torch.float32: 'highway_stack_f32',
                torch.bfloat16: 'highway_stack_bf16'}


def pre_highway_stack_plain(a: torch.Tensor, res: torch.Tensor,
                            pre_w: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """(a + res) @ pre_w, then per layer x + sigmoid(g) * (relu(h) - x)
    with [h | g] = x @ w[l] + b[l].

    a, res [N, C_in]; pre_w [C_in, C]; w [L, C, 2C] (W1 | W2 packed), all
    of one dtype; b [L, 2C] float32. Returns [N, C] in a's dtype. Products
    accumulate in float32; x is rounded to a's dtype after the residual
    add, after the pre-projection and after each layer, as the TPU kernel
    rounds it."""
    dt = a.dtype
    x = _rnd(_rnd(a.float() + res.float(), dt) @ pre_w.float(), dt)
    return _layers(x, w, b).to(dt)


def highway_stack_plain(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Per layer x + sigmoid(g) * (relu(h) - x) with [h | g] = x @ w[l] +
    b[l], on rows x [N, C]; w [L, C, 2C] (W1 | W2 packed) in x's dtype, b
    [L, 2C] float32. Returns [N, C] in x's dtype; products accumulate in
    float32 and x is rounded to its dtype after each layer, as the TPU
    kernel rounds it."""
    return _layers(x.float(), w, b).to(x.dtype)


def _rnd(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """float32 ``t`` rounded to ``dt`` and back."""
    return t.to(dt).float()


def _layers(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The highway layers on float32 rows x holding values of w's dtype."""
    dt, c = w.dtype, w.shape[1]
    for layer in range(w.shape[0]):
        hg = x @ w[layer].float() + b[layer].float()
        h = torch.relu(hg[:, :c])
        g = torch.sigmoid(hg[:, c:])
        x = _rnd(x + g * (h - x), dt)
    return x


def shape_error(c_in: int, c: int) -> Optional[str]:
    """Why the kernel cannot take rows of width ``c_in`` projected to ``c``
    channels, or None when it can (``c_in`` is padded to a multiple of 4
    first). Needs no card: the wrapper raises with it, and the CBHG's gate
    consults it."""
    if c <= 0 or c % 4:
        return f'C={c} must be a positive multiple of 4'
    if c_in <= 0 or max(-(-c_in // 4) * 4, c) > MAX_WIDTH:
        return (f'C_in={c_in}, C={c}: the kernel holds rows of at most '
                f'{MAX_WIDTH} channels in shared memory')
    return None


def pad_input_width(a: torch.Tensor, res: torch.Tensor, pre_w: torch.Tensor,
                    c_in_pad: int):
    """a, res and pre_w with zero input columns (rows of pre_w) up to
    ``c_in_pad``: (a + res) @ pre_w gains only zero terms."""
    pc = c_in_pad - a.shape[1]
    return (F.pad(a, (0, pc)).contiguous(), F.pad(res, (0, pc)).contiguous(),
            F.pad(pre_w, (0, 0, 0, pc)).contiguous())


def _kernel(dtype):
    fn = getattr(build.library('highway'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stack_kernel(dtype):
    fn = getattr(build.library('highway'), _STACK_ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pre_highway_stack(a: torch.Tensor, res: torch.Tensor,
                      pre_w: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`pre_highway_stack_plain`, one kernel launch
    on the GPU. The kernel takes C_in in multiples of 4; others are padded
    with zero columns here, which is exact. What :func:`shape_error`
    refuses raises ``ValueError``."""
    if a.device.type == 'cpu':
        return pre_highway_stack_plain(a, res, pre_w, w, b)
    if a.device.type != 'cuda':
        raise ValueError(f'pre_highway_stack: unsupported device {a.device}')
    n, c_in = a.shape
    c = pre_w.shape[1]
    n_layers = w.shape[0]
    args = (a, res, pre_w, w, b)
    dt = a.dtype
    if (dt not in _ENTRY
            or any(t.dtype != dt for t in (res, pre_w, w))
            or b.dtype != torch.float32
            or any(not t.is_contiguous() or t.device != a.device
                   for t in args)):
        raise ValueError('pre_highway_stack: a, res, pre_w and w must be '
                         'contiguous float32 or bfloat16 tensors of one '
                         'dtype, b contiguous float32, all on one device')
    if (res.shape != a.shape or pre_w.shape[0] != c_in
            or w.shape != (n_layers, c, 2 * c) or b.shape != (n_layers, 2 * c)):
        raise ValueError('pre_highway_stack: bad shapes '
                         f'{[tuple(t.shape) for t in args]}')
    err = shape_error(c_in, c)
    if err:
        raise ValueError(f'pre_highway_stack: {err}')
    if c_in % 4:
        c_in = -(-c_in // 4) * 4
        a, res, pre_w = pad_input_width(a, res, pre_w, c_in)
    out = torch.empty(n, c, dtype=dt, device=a.device)
    if n == 0:
        return out
    status = _kernel(dt)(*(build.ptr(t) for t in (a, res, pre_w, w, b)),
                         build.ptr(out),
                         n, c_in, c, n_layers, a.get_device(),
                         build.stream_of(a))
    build.check(status, 'pre_highway_stack')
    global launches
    launches += 1
    return out


def highway_stack(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`highway_stack_plain`, one kernel launch on
    the GPU (``highway.cu`` without its input stage). What
    :func:`shape_error` refuses raises ``ValueError``."""
    if x.device.type == 'cpu':
        return highway_stack_plain(x, w, b)
    if x.device.type != 'cuda':
        raise ValueError(f'highway_stack: unsupported device {x.device}')
    n, c = x.shape
    n_layers = w.shape[0]
    dt = x.dtype
    if (dt not in _STACK_ENTRY or w.dtype != dt or b.dtype != torch.float32
            or any(not t.is_contiguous() or t.device != x.device
                   for t in (x, w, b))):
        raise ValueError('highway_stack: x and w must be contiguous float32 '
                         'or bfloat16 tensors of one dtype, b contiguous '
                         'float32, all on one device')
    if w.shape != (n_layers, c, 2 * c) or b.shape != (n_layers, 2 * c):
        raise ValueError('highway_stack: bad shapes '
                         f'{[tuple(t.shape) for t in (x, w, b)]}')
    err = shape_error(c, c)
    if err:
        raise ValueError(f'highway_stack: {err}')
    out = torch.empty_like(x)
    if n == 0:
        return out
    status = _stack_kernel(dt)(build.ptr(x), build.ptr(w), build.ptr(b),
                               build.ptr(out), n, c, n_layers,
                               x.get_device(), build.stream_of(x))
    build.check(status, 'highway_stack')
    global stack_launches
    stack_launches += 1
    return out
