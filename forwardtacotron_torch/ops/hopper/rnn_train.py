"""Trainable bidirectional recurrences: the ``rnn_bwd.cu`` backward sweeps,
their plain twins, and ``GruCore`` / ``LstmCore`` as autograd Functions.

Port of forwardtacotron_tpu/ops/pallas/rnn_train.py (the training path):

  forward   ``rnn.gru`` (_gru_fwd_call) and ``rnn.lstm_train``
            (_lstm_fwd_call with _lstm_kernel_train: hs and the cell states)
  backward  ``gru_bwd``  <- _gru_core_bwd  (body _gru_bwd_kernel): dgx, dgh
            ``lstm_bwd`` <- _lstm_core_bwd (body _lstm_bwd_kernel): dgates

The sweeps walk time in reverse, carry dh (and dc) in float32, recompute the
gates from x_t and the saved h_{t-1} (and c_t, c_{t-1}), and write the
pre-activation gradients in bf16. The weight and input gradients are plain
products over the whole [T*2*B] axis outside the kernels, with float32
accumulation, as the JAX package leaves them to XLA. Each wrapper launches
its CUDA kernel for CUDA tensors (bfloat16 only) and runs its twin for CPU
tensors; nothing else selects between them.

``models.layers.bidir_rnn_trainable`` pads the batch, flips and stacks the
directions around these cores. Which route ``models.layers._bidir_scan``
takes for a recurrence the kernels can run (bf16, H % 128 == 0, input width
% 16 == 0) is this module's mode, the counterpart of the JAX package's
``pallas_rnns``: 'on' (the default: the inference kernels, no gradient),
'train' (these cores, differentiable) or 'off' (the per-step loops). The
trainer sets it with :func:`rnn_mode`.
"""

import ctypes
from contextlib import contextmanager

import torch

from forwardtacotron_torch.ops.hopper import build, rnn

# launches of each CUDA kernel since the counts were last set to 0
launches = {'gru_bwd': 0, 'lstm_bwd': 0}

_MODES = ('on', 'train', 'off')
_state = {'mode': 'on'}


@contextmanager
def rnn_mode(mode: str):
    """Route the eligible recurrences of the block: 'on', 'train' or
    'off' (see the module docstring)."""
    if mode not in _MODES:
        raise ValueError(f'rnn_mode: {mode!r} is not one of {_MODES}')
    prev = _state['mode']
    _state['mode'] = mode
    try:
        yield
    finally:
        _state['mode'] = prev


def current_mode() -> str:
    return _state['mode']


# -------------------------------------------------------------- the twins


def _zero_first(seq: torch.Tensor) -> torch.Tensor:
    """seq [T, ...] shifted one step later: row t holds seq[t-1], row 0
    zeros (the state before the first step)."""
    return torch.cat([torch.zeros_like(seq[:1]), seq[:-1]])


def gru_bwd_plain(dhs, hs, x2, wi, wh, bi, bh):
    """Reverse-time GRU sweep. dhs, hs [T, 2, B, H]; x2 [T, 2, B, I]; wi
    [2, I, 3H], wh [2, H, 3H], bi/bh [2, 3H], all in one dtype. Returns
    (dgx, dgh) [T, 2, B, 3H] in that dtype: the gradients of the x- and
    h-projections, which differ in the n gate."""
    dt = x2.dtype
    f = torch.float32
    wif, whf = wi.float(), wh.float()
    bif, bhf = bi.float()[:, None], bh.float()[:, None]
    h_prevs = _zero_first(hs)
    dgx = torch.empty(*hs.shape[:3], wi.shape[-1], dtype=dt,
                      device=x2.device)
    dgh = torch.empty_like(dgx)
    dh = torch.zeros(hs.shape[1:], dtype=f, device=x2.device)
    for t in range(hs.shape[0] - 1, -1, -1):
        h_prev = h_prevs[t].float()
        gx = torch.baddbmm(bif, x2[t].float(), wif)
        gh = torch.baddbmm(bhf, h_prev, whf)
        xr, xz, xn = gx.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh_total = dhs[t].float() + dh
        dz = dh_total * (h_prev - n)
        dn = dh_total * (1.0 - z)
        dgn = dn * (1.0 - n * n)
        dr = dgn * hn
        dgr = dr * r * (1.0 - r)
        dgz = dz * z * (1.0 - z)
        dgx[t] = torch.cat([dgr, dgz, dgn], dim=-1).to(dt)
        dgh[t] = torch.cat([dgr, dgz, dgn * r], dim=-1).to(dt)
        dh = dh_total * z + torch.bmm(dgh[t].float(), whf.transpose(1, 2))
    return dgx, dgh


def lstm_bwd_plain(dhs, hs, cs, x2, wi, wh, b):
    """Reverse-time LSTM sweep. dhs, hs, cs [T, 2, B, H]; x2 [T, 2, B, I];
    wi [2, I, 4H], wh [2, H, 4H], b [2, 4H] (bi + bh). Returns dgates
    [T, 2, B, 4H] in x2's dtype."""
    dt = x2.dtype
    f = torch.float32
    wif, whf, bf = wi.float(), wh.float(), b.float()[:, None]
    h_prevs, c_prevs = _zero_first(hs), _zero_first(cs)
    dgates = torch.empty(*hs.shape[:3], wi.shape[-1], dtype=dt,
                         device=x2.device)
    dh = torch.zeros(hs.shape[1:], dtype=f, device=x2.device)
    dc = torch.zeros_like(dh)
    for t in range(hs.shape[0] - 1, -1, -1):
        gates = (torch.bmm(x2[t].float(), wif)
                 + torch.bmm(h_prevs[t].float(), whf) + bf)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, fg, g, o = (torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg),
                       torch.sigmoid(go))
        tc = torch.tanh(cs[t].float())
        dh_total = dhs[t].float() + dh
        d_o = dh_total * tc
        dc_total = dh_total * o * (1.0 - tc * tc) + dc
        dgi = dc_total * g * i * (1.0 - i)
        dgf = dc_total * c_prevs[t].float() * fg * (1.0 - fg)
        dgg = dc_total * i * (1.0 - g * g)
        dgo = d_o * o * (1.0 - o)
        dgates[t] = torch.cat([dgi, dgf, dgg, dgo], dim=-1).to(dt)
        dh = torch.bmm(dgates[t].float(), whf.transpose(1, 2))
        dc = dc_total * fg
    return dgates


# --------------------------------------------------------- the CUDA kernels


def _launch(name: str, entry: str, ptrs, outs, ints, x2: torch.Tensor):
    t_len, _, b = x2.shape[:3]
    if t_len == 0 or b == 0:
        return
    bar = torch.zeros(2 * b, dtype=torch.int32, device=x2.device)
    fn = getattr(build.library('rnn_bwd'), entry)
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + len(outs) + 1) \
        + [ctypes.c_int] * (len(ints) + 1) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(*(build.ptr(t) for t in ptrs + outs), build.ptr(bar), *ints,
                x2.get_device(), build.stream_of(x2))
    build.check(status, f'rnn_train.{name}')
    launches[name] += 1


def gru_bwd(dhs, hs, x2, wi, wh, bi, bh):
    """Same contract as :func:`gru_bwd_plain`; one launch on the GPU."""
    if x2.device.type == 'cpu':
        return gru_bwd_plain(dhs, hs, x2, wi, wh, bi, bh)
    t_len, _, b, i = x2.shape
    h = wh.shape[1]
    rnn._check('gru_bwd', x2, (dhs, hs, x2, wi, bi, bh, wh),
               ((t_len, 2, b, h), (t_len, 2, b, h), (t_len, 2, b, i),
                (2, i, 3 * h), (2, 3 * h), (2, 3 * h), (2, h, 3 * h)))
    dgx = x2.new_empty(t_len, 2, b, 3 * h)
    dgh = torch.empty_like(dgx)
    _launch('gru_bwd', 'rnn_gru_bwd_bf16', (dhs, hs, x2, wi, wh, bi, bh),
            (dgx, dgh), (t_len, b, i, h), x2)
    return dgx, dgh


def lstm_bwd(dhs, hs, cs, x2, wi, wh, b):
    """Same contract as :func:`lstm_bwd_plain`; one launch on the GPU."""
    if x2.device.type == 'cpu':
        return lstm_bwd_plain(dhs, hs, cs, x2, wi, wh, b)
    t_len, _, batch, i = x2.shape
    h = wh.shape[1]
    rnn._check('lstm_bwd', x2, (dhs, hs, cs, x2, wi, b, wh),
               ((t_len, 2, batch, h), (t_len, 2, batch, h),
                (t_len, 2, batch, h), (t_len, 2, batch, i), (2, i, 4 * h),
                (2, 4 * h), (2, h, 4 * h)))
    dgates = x2.new_empty(t_len, 2, batch, 4 * h)
    _launch('lstm_bwd', 'rnn_lstm_bwd_bf16', (dhs, hs, cs, x2, wi, wh, b),
            (dgates,), (t_len, batch, i, h), x2)
    return dgates


# --------------------------------------------------------- autograd cores


def _weight_grads(x2, h_prev, dgx, dgh, wi):
    """(dx2, dwi, dwh): products over the whole [T*2*B] axis in float32,
    rounded once to the inputs' dtype."""
    f = torch.float32
    gx, gh = dgx.to(f), dgh.to(f)
    dx2 = torch.einsum('tdbg,dig->tdbi', gx, wi.to(f)).to(x2.dtype)
    dwi = torch.einsum('tdbi,tdbg->dig', x2.to(f), gx).to(wi.dtype)
    dwh = torch.einsum('tdbh,tdbg->dhg', h_prev.to(f), gh).to(wi.dtype)
    return dx2, dwi, dwh


class GruCore(torch.autograd.Function):
    """hs = GRU(x2) over the stacked directions, [T, 2, B, I] ->
    [T, 2, B, H]; backward through ``gru_bwd``."""

    @staticmethod
    def forward(ctx, x2, wi, wh, bi, bh):
        hs = rnn.gru(x2, wi, wh, bi, bh)
        ctx.save_for_backward(x2, wi, wh, bi, bh, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x2, wi, wh, bi, bh, hs = ctx.saved_tensors
        dgx, dgh = gru_bwd(dhs.to(x2.dtype).contiguous(), hs, x2, wi, wh,
                           bi, bh)
        dx2, dwi, dwh = _weight_grads(x2, _zero_first(hs), dgx, dgh, wi)
        f = torch.float32
        return (dx2, dwi, dwh, dgx.to(f).sum((0, 2)).to(bi.dtype),
                dgh.to(f).sum((0, 2)).to(bh.dtype))


class LstmCore(torch.autograd.Function):
    """hs = LSTM(x2) over the stacked directions with the summed bias b;
    the forward keeps the cell states for ``lstm_bwd``."""

    @staticmethod
    def forward(ctx, x2, wi, wh, b):
        hs, cs = rnn.lstm_train(x2, wi, wh, b)
        ctx.save_for_backward(x2, wi, wh, b, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x2, wi, wh, b, hs, cs = ctx.saved_tensors
        dgates = lstm_bwd(dhs.to(x2.dtype).contiguous(), hs, cs, x2, wi, wh,
                          b)
        dx2, dwi, dwh = _weight_grads(x2, _zero_first(hs), dgates, dgates,
                                      wi)
        return (dx2, dwi, dwh,
                dgates.to(torch.float32).sum((0, 2)).to(b.dtype))

