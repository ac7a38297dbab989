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
Pallas kernel.
"""

import ctypes

import torch

from forwardtacotron_torch.ops.hopper import build

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


def _kernel():
    fn = build.library('lr').lr_expand
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def length_regulator_expand(x: torch.Tensor, ends: torch.Tensor,
                            max_len: int) -> torch.Tensor:
    """Same contract as :func:`length_regulator_plain`, one kernel launch on
    the GPU (ends must then be int32); no gradient."""
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
    status = _kernel()(build.ptr(x), build.ptr(ends), build.ptr(out), b, n,
                       max_len, row_bytes, x.get_device(), build.stream_of(x))
    build.check(status, 'lr')
    global launches
    launches += 1
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
