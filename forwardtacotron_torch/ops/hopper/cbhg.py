"""The CBHG front (bank -> pool -> mask -> proj1): the ``cbhg_front.cu``
kernel and its plain twin.

Port of forwardtacotron_tpu/ops/pallas/cbhg.py::bank_pool_proj_pallas.
``bank_pool_proj`` launches the CUDA kernel for CUDA tensors and runs the
plain twin for CPU tensors; nothing else selects between them.
"""

import ctypes
from typing import Sequence

import torch

from forwardtacotron_torch.ops.hopper import build

# launches of the CUDA kernel since the count was last set to 0
launches = 0

# the kernel keeps one output column per thread
MAX_P = 256


def bank_pool_proj_plain(x: torch.Tensor, mask: torch.Tensor,
                         bank_w: Sequence[torch.Tensor],
                         bn_scale: torch.Tensor, bn_bias: torch.Tensor,
                         proj_w: torch.Tensor, proj_scale: torch.Tensor,
                         proj_bias: torch.Tensor) -> torch.Tensor:
    """Whole CBHG front with both eval BatchNorms folded.

    x [B, T, C_in] (zero beyond each item's length); mask [B, T], 1.0 at
    valid frames, applied after the pool; bank_w[i] [k, C_in, C] for
    k = i + 1; bn_scale/bn_bias [K, C] (scale' = scale*rsqrt(var+eps),
    bias' = bias - mean*scale'); proj_w [3, K*C, P]; proj_scale/proj_bias
    [P]. Returns [B, T, P], conv_project1's output after ReLU and BN."""
    b, t, _ = x.shape
    c = bank_w[0].shape[-1]
    acc = torch.zeros(b, t, proj_w.shape[-1], dtype=x.dtype, device=x.device)
    neg = torch.full((b, 1, c), float('-inf'), dtype=x.dtype, device=x.device)
    for bi, w in enumerate(bank_w):
        k = w.shape[0]
        xp = torch.nn.functional.pad(x, (0, 0, k // 2, k - 1 - k // 2))
        cols = torch.cat([xp[:, j:j + t] for j in range(k)], dim=-1)
        y = cols @ w.reshape(-1, c)
        y = torch.relu(y) * bn_scale[bi] + bn_bias[bi]
        y = torch.maximum(torch.cat([neg, y[:, :-1]], dim=1), y)
        y = y * mask[:, :, None]
        yp = torch.nn.functional.pad(y, (0, 0, 1, 1))
        for d in range(3):
            acc = acc + yp[:, d:d + t] @ proj_w[d, bi * c:(bi + 1) * c]
    return torch.relu(acc) * proj_scale + proj_bias


def _kernel():
    fn = build.library('cbhg_front').cbhg_front_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bank_pool_proj(x: torch.Tensor, mask: torch.Tensor,
                   bank_w: Sequence[torch.Tensor],
                   bn_scale: torch.Tensor, bn_bias: torch.Tensor,
                   proj_w: torch.Tensor, proj_scale: torch.Tensor,
                   proj_bias: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`bank_pool_proj_plain`, one kernel launch on
    the GPU."""
    if x.device.type == 'cpu':
        return bank_pool_proj_plain(x, mask, bank_w, bn_scale, bn_bias,
                                    proj_w, proj_scale, proj_bias)
    if x.device.type != 'cuda':
        raise ValueError(f'bank_pool_proj: unsupported device {x.device}')
    b, t, c_in = x.shape
    k_max = len(bank_w)
    c = bank_w[0].shape[-1]
    p = proj_w.shape[-1]
    if [w.shape for w in bank_w] != [(k, c_in, c)
                                     for k in range(1, k_max + 1)]:
        raise ValueError('bank_pool_proj: bank_w[i] must be [i+1, C_in, C]')
    if (mask.shape != (b, t) or bn_scale.shape != (k_max, c)
            or bn_bias.shape != (k_max, c)
            or proj_w.shape != (3, k_max * c, p)
            or proj_scale.shape != (p,) or proj_bias.shape != (p,)
            or c_in % 4 or c % 4 or p > MAX_P):
        raise ValueError('bank_pool_proj: bad shapes (C_in and C must be '
                         f'multiples of 4, P at most {MAX_P})')
    bank = torch.cat([w.reshape(-1) for w in bank_w])
    args = (x, mask, bank, bn_scale, bn_bias, proj_w, proj_scale, proj_bias)
    if any(a.dtype != torch.float32 or not a.is_contiguous()
           or a.device != x.device for a in args):
        raise ValueError('bank_pool_proj: every input must be a contiguous '
                         'float32 tensor on the same device')
    out = torch.empty(b, t, p, dtype=torch.float32, device=x.device)
    if b == 0 or t == 0:
        return out
    status = _kernel()(*(build.ptr(a) for a in args), build.ptr(out),
                       b, t, c_in, c, p, k_max, x.get_device(),
                       build.stream_of(x))
    build.check(status, 'cbhg_front')
    global launches
    launches += 1
    return out
