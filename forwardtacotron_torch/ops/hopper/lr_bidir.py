"""Bidirectional length regulator: the ``lr_bidir.cu`` kernel and its plain
twin.

Port of forwardtacotron_tpu/ops/pallas/length_regulator.py::
length_regulator_bidir_pallas. Token features expand straight into the
recurrent kernels' time-major [T, 2, B, C] layout, direction 1 already
flipped per item, so the bi-LSTM of the frame trunk reads it as it is.
``length_regulator_bidir`` launches the CUDA kernel for CUDA tensors and runs
the plain twin for CPU tensors; nothing else selects between them.
"""

import ctypes

import torch

from forwardtacotron_torch.ops.hopper import build

# launches of the CUDA kernel since the count was last set to 0
launches = 0

# the JAX kernel's time tile: the fused frame trunk runs max_len rounded up
# to it, which fixes where an over-budget item's backward direction starts
T_TILE = 64


def length_regulator_bidir_plain(x: torch.Tensor, ends: torch.Tensor,
                                 t_run: int) -> torch.Tensor:
    """x [B, N, C] tokens; ends [B, N] integer, the running sum of the
    rounded durations (token n spans frames [ends[n-1], ends[n])). Returns
    [t_run, 2, B, C] in x's dtype: row (t, 0, b) is frame t of item b, row
    (t, 1, b) is frame min(len_b - 1 - t, t_run - 1) with len_b = ends[b, -1];
    a frame that no span holds is zero."""
    b, n, c = x.shape
    t = torch.arange(t_run, device=x.device)
    lens = ends[:, -1:]
    frames = torch.stack([t.expand(b, t_run),
                          torch.clamp(lens - 1 - t, max=t_run - 1)], dim=1)
    frames = frames.reshape(b, 2 * t_run)
    # token holding frame f = the first whose span ends after f
    idx = torch.searchsorted(ends.contiguous(), frames.contiguous(),
                             right=True).clamp(max=n - 1)
    rows = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, c))
    valid = (frames >= 0) & (frames < lens)
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    return rows.reshape(b, 2, t_run, c).permute(2, 1, 0, 3).contiguous()


def _kernel():
    fn = build.library('lr_bidir').lr_bidir
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def length_regulator_bidir(x: torch.Tensor, ends: torch.Tensor,
                           t_run: int) -> torch.Tensor:
    """Same contract as :func:`length_regulator_bidir_plain`, one kernel
    launch on the GPU (ends must then be int32)."""
    if x.device.type == 'cpu':
        return length_regulator_bidir_plain(x, ends, t_run)
    if x.device.type != 'cuda':
        raise ValueError(
            f'length_regulator_bidir: unsupported device {x.device}')
    b, n, c = x.shape
    row_bytes = c * x.element_size()
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or ends.dtype != torch.int32 or ends.shape != (b, n)
            or n == 0 or row_bytes % 16 or t_run < 0
            or not x.is_contiguous() or not ends.is_contiguous()
            or ends.device != x.device):
        raise ValueError(
            'length_regulator_bidir: x must be a contiguous float32 or '
            'bfloat16 [B, N, C] tensor with C * itemsize a multiple of 16 '
            'bytes and N >= 1, ends a contiguous int32 [B, N] tensor on the '
            'same device')
    out = torch.empty(t_run, 2, b, c, dtype=x.dtype, device=x.device)
    if b == 0 or t_run == 0:
        return out
    status = _kernel()(build.ptr(x), build.ptr(ends), build.ptr(out), b, n,
                       t_run, row_bytes, x.get_device(), build.stream_of(x))
    build.check(status, 'lr_bidir')
    global launches
    launches += 1
    return out
