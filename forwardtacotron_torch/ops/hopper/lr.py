"""Length regulator: the ``lr.cu`` kernel, its plain twin and its gradient.

Port of forwardtacotron_tpu/ops/pallas/length_regulator.py::
length_regulator_pallas. Token features [B, N, C] expand to frames
[B, max_len, C]: frame t of item b copies the token whose span
[ends[n-1], ends[n]) holds t, and frames at or past the expanded length
ends[b, -1] are zero. ``length_regulator`` is differentiable in x, as the
JAX function's custom VJP is: the gradient of a token is the sum of the
incoming gradient over the frames it was copied to, and the durations get
none. The forward launches the CUDA kernel for CUDA tensors and runs the
plain twin for CPU tensors; nothing else selects between them. The backward
is plain PyTorch on both, as the JAX backward is an XLA einsum outside any
Pallas kernel. The kernel's launch (:func:`plan`: one CTA per item and
tile of frames) needs no card.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from forwardtacotron_torch.ops.hopper import build

# the launch plan: a CTA's tile of frames is a power of two up to MAX_TILE
# (lr.cu's shared token table) whose rows hold at most TILE_BYTES, halved
# down to MIN_TILE while the grid gives fewer than CTAS_PER_SM CTAs to each
# of the card's N_SM SMs (an H100 SXM has 132)
MAX_TILE = 256
MIN_TILE = 8
TILE_BYTES = 32768
CTAS_PER_SM = 4
N_SM = 132
INT_MAX = 2 ** 31 - 1

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def length_regulator_plain(x: torch.Tensor, ends: torch.Tensor,
                           max_len: int) -> torch.Tensor:
    """x [B, N, C] tokens; ends [B, N] integer, the running sum of the
    rounded durations. Returns [B, max_len, C] in x's dtype."""
    b, n, c = x.shape
    if n == 0:
        return x.new_zeros(b, max_len, c)
    t = torch.arange(max_len, device=x.device, dtype=ends.dtype)
    # token owning frame t = the first whose span ends after t
    idx = torch.searchsorted(ends.contiguous(),
                             t.expand(b, max_len).contiguous(),
                             right=True).clamp(max=n - 1)
    rows = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, c))
    valid = (t[None, :] < ends[:, -1:])[:, :, None]
    return torch.where(valid, rows, torch.zeros_like(rows))


def segment_sum(g: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The length regulator's gradient: g [B, T, C] -> [B, N, C], token n
    summing g over the frames [ends[n-1], ends[n]) clipped to T. A float32
    running sum over time read at the span ends (no atomics, so the same on
    every run), rounded once to g's dtype."""
    b, t, c = g.shape
    csum = torch.nn.functional.pad(torch.cumsum(g.float(), dim=1),
                                   (0, 0, 1, 0))
    hi = ends.long().clamp(max=t)
    lo = torch.cat([hi.new_zeros(b, 1), hi[:, :-1]], dim=1)

    def at(idx):
        return torch.gather(csum, 1, idx[:, :, None].expand(-1, -1, c))
    return (at(hi) - at(lo)).to(g.dtype)


class Plan(NamedTuple):
    """The launch of one ``lr.cu`` call (:func:`plan`): B * ceil(T / tile)
    CTAs, as the kernel derives them from T and the tile."""
    tile: int        # frames of a CTA's tile
    row_vecs: int    # 16-byte words of a row


def plan(b: int, n: int, t: int, c: int, dtype: torch.dtype) -> Plan:
    """The launch of a [b, n, c] -> [b, t, c] expansion in ``dtype``: one
    CTA per (item, tile of frames). The tile is the largest power of two up
    to MAX_TILE whose output (tile rows of c values) is at most TILE_BYTES,
    halved while the grid has fewer than CTAS_PER_SM CTAs per SM and the
    tile more than MIN_TILE frames (a batch-1 request). Raises ValueError
    with the reason for a shape the kernel does not take. Needs no card."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'lr: the kernel takes float32 or bfloat16, got '
                         f'{dtype}')
    if n < 1 or b < 1 or t < 1 or c < 1:
        raise ValueError(f'lr: B={b}, N={n}, T={t}, C={c}: the kernel takes '
                         'at least one item, token, frame and channel')
    row_bytes = c * (2 if dtype == torch.bfloat16 else 4)
    if row_bytes % 16:
        raise ValueError(f'lr: rows of {row_bytes} bytes; the kernel copies '
                         '16-byte words (C a multiple of 4 in float32, of 8 '
                         'in bfloat16)')
    tile = MAX_TILE
    while tile > 1 and tile * row_bytes > TILE_BYTES:
        tile //= 2
    while tile > MIN_TILE and b * -(-t // tile) < CTAS_PER_SM * N_SM:
        tile //= 2
    tiles = -(-t // tile)
    if b * tiles > INT_MAX or tile * row_bytes // 16 > INT_MAX:
        raise ValueError(f'lr: {b} items of {tiles} tiles of {tile} frames: '
                         f'the grid holds at most {INT_MAX} CTAs')
    return Plan(tile, row_bytes // 16)


_plan = functools.lru_cache(maxsize=256)(plan)
_fn = None


def _kernel():
    """``lr_expand`` of the built library, its argument types set once."""
    global _fn
    if _fn is None:
        fn = build.library('lr').lr_expand
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(x: torch.Tensor, ends: torch.Tensor, out: torch.Tensor,
           pl: Plan) -> None:
    """One launch of the kernel with the plan ``pl`` into ``out``; the
    caller has checked the tensors (:func:`length_regulator_expand`)."""
    b, n, _ = x.shape
    status = _kernel()(x.data_ptr(), ends.data_ptr(), out.data_ptr(), b, n,
                       out.shape[1], pl.row_vecs * 16, pl.tile,
                       x.get_device(),
                       # the current stream's handle, without the Stream
                       # object torch.cuda.current_stream builds per call
                       torch._C._cuda_getCurrentRawStream(x.get_device()))
    build.check(status, 'lr')
    global launches
    launches += 1


def length_regulator_expand(x: torch.Tensor, ends: torch.Tensor,
                            max_len: int) -> torch.Tensor:
    """Same contract as :func:`length_regulator_plain`, one kernel launch on
    the GPU (ends must then be int32 and non-decreasing in each item, as a
    running sum of durations is); no gradient."""
    if x.device.type == 'cpu':
        return length_regulator_plain(x, ends, max_len)
    if x.device.type != 'cuda':
        raise ValueError(f'lr: unsupported device {x.device}')
    b, n, c = x.shape
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or ends.dtype != torch.int32 or ends.shape != (b, n) or n == 0
            or max_len < 0 or not x.is_contiguous()
            or not ends.is_contiguous() or ends.device != x.device):
        raise ValueError(
            'lr: x must be a contiguous float32 or bfloat16 [B, N, C] tensor '
            'with N >= 1, ends a contiguous int32 [B, N] tensor on the same '
            'device')
    row_bytes = c * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f'lr: rows of {row_bytes} bytes at address '
                         f'{x.data_ptr():#x}; the kernel copies 16-byte '
                         'words (C a multiple of 4 in float32, of 8 in '
                         'bfloat16, and x 16-byte aligned)')
    out = torch.empty(b, max_len, c, dtype=x.dtype, device=x.device)
    if b == 0 or max_len == 0 or c == 0:
        return out
    launch(x, ends, out, _plan(b, n, max_len, c, x.dtype))
    return out


class _LengthRegulator(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ends, max_len):
        ctx.save_for_backward(ends)
        return length_regulator_expand(x, ends, max_len)

    @staticmethod
    def backward(ctx, g):
        (ends,) = ctx.saved_tensors
        return segment_sum(g, ends), None, None


def length_regulator(x: torch.Tensor, ends: torch.Tensor,
                     max_len: int) -> torch.Tensor:
    """:func:`length_regulator_expand`, differentiable in x."""
    return _LengthRegulator.apply(x, ends, max_len)
