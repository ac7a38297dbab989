"""Residual add + pre_highway + highway stack: the ``highway.cu`` kernel and
its plain twin.

Port of forwardtacotron_tpu/ops/pallas/highway.py::pre_highway_stack_pallas.
``pre_highway_stack`` launches the CUDA kernel for CUDA tensors and runs the
plain twin for CPU tensors; nothing else selects between them.
"""

import ctypes

import torch

from forwardtacotron_torch.ops.hopper import build

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def pre_highway_stack_plain(a: torch.Tensor, res: torch.Tensor,
                            pre_w: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """(a + res) @ pre_w, then per layer x + sigmoid(g) * (relu(h) - x)
    with [h | g] = x @ w[l] + b[l].

    a, res [N, C_in]; pre_w [C_in, C]; w [L, C, 2C] (W1 | W2 packed);
    b [L, 2C]. Returns [N, C]."""
    x = (a + res) @ pre_w
    c = pre_w.shape[1]
    for layer in range(w.shape[0]):
        hg = x @ w[layer] + b[layer]
        h = torch.relu(hg[:, :c])
        g = torch.sigmoid(hg[:, c:])
        x = x + g * (h - x)
    return x


def _kernel():
    fn = build.library('highway').pre_highway_stack_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pre_highway_stack(a: torch.Tensor, res: torch.Tensor,
                      pre_w: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`pre_highway_stack_plain`, one kernel launch
    on the GPU."""
    if a.device.type == 'cpu':
        return pre_highway_stack_plain(a, res, pre_w, w, b)
    if a.device.type != 'cuda':
        raise ValueError(f'pre_highway_stack: unsupported device {a.device}')
    n, c_in = a.shape
    c = pre_w.shape[1]
    n_layers = w.shape[0]
    args = (a, res, pre_w, w, b)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != a.device for t in args):
        raise ValueError('pre_highway_stack: every input must be a '
                         'contiguous float32 tensor on the same device')
    if (res.shape != a.shape or pre_w.shape[0] != c_in
            or w.shape != (n_layers, c, 2 * c) or b.shape != (n_layers, 2 * c)
            or c_in % 4 or c % 4):
        raise ValueError('pre_highway_stack: bad shapes '
                         f'{[tuple(t.shape) for t in args]} (C_in and C must '
                         'be multiples of 4)')
    out = torch.empty(n, c, dtype=torch.float32, device=a.device)
    if n == 0:
        return out
    status = _kernel()(*(build.ptr(t) for t in args), build.ptr(out),
                       n, c_in, c, n_layers, a.get_device(),
                       build.stream_of(a))
    build.check(status, 'pre_highway_stack')
    global launches
    launches += 1
    return out
