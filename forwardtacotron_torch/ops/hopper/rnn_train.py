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
its CUDA kernels for CUDA tensors (bfloat16 only) and runs its twin for CPU
tensors; nothing else selects between them. On the card a sweep is two
launches of ``rnn_bwd.cu``, each counted: the gate recompute for all steps
at once (a tensor-core product whose epilogue stores, per step, row and
unit, the float32 coefficients that make the step's dgates linear in dh and
dc, ``rnn_bwd.cu``'s note lists them), then the reverse walk that carries
dh through the resident rows of Wh. :func:`plan` lays out both launches and
:func:`pack_gate_weights` the gate product's weights, without a card.

``models.layers.bidir_rnn_trainable`` pads the batch, flips and stacks the
directions around these cores. Which route ``models.layers._bidir_scan``
takes for a recurrence the kernels can run (bf16, H % 128 == 0, input width
% 16 == 0) is this module's mode, the counterpart of the JAX package's
``pallas_rnns``: 'on' (the default: the inference kernels, no gradient),
'train' (these cores, differentiable) or 'off' (the per-step loops). The
trainer sets it with :func:`rnn_mode`.
"""

import ctypes
import functools
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

# rnn_bwd.cu's shapes: hidden units of a sweep CTA, K depth of a stage and
# rows of a wgmma tile, sweep ring stages per warpgroup and coefficient
# slots, hidden units of one gate-product column tile (4 gate blocks of
# them), gate-product ring stages
UNIT = 16
CHUNK = 64
TILE = 64
MIN_STAGES = 2
MAX_STAGES = 16
COEF_SLOTS = 2
GATE_UNITS = 32
GATE_N = 4 * GATE_UNITS
GATE_STAGE = 2 * TILE * CHUNK * 2 + GATE_N * CHUNK * 2
GATE_MIN_STAGES = 2
GATE_MAX_STAGES = 3
# float32 values the gate product stores per (step, direction, row, unit):
# dhs and the coefficients of the step's dgates
N_COEF = {'gru': 6, 'lstm': 7}
N_GATES = {'gru': 3, 'lstm': 4}


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(cell: str, batch: int, t_len: int, in_dim: int, hidden: int,
         n_sm: int, smem_limit: int) -> dict:
    """The launch plans of ``rnn_bwd.cu``'s two kernels for ``cell`` ('gru'
    or 'lstm') on a card of ``n_sm`` SMs whose blocks may opt in to
    ``smem_limit`` bytes of shared memory. Needs no card. Raises ValueError
    where the kernels cannot take the shape.

    ``gates``: the gate recompute, one GEMM per direction over all steps.
    Its 64-row tiles hold ``bb`` = min(B, 64) batch rows of ``tb`` = 64 //
    bb consecutive steps of one direction (``m_tiles`` per direction), its
    column tiles GATE_UNITS hidden units x 4 gate blocks (``n_tiles``); a
    CTA takes two row tiles (two consumer warpgroups) and one column tile,
    K = I and H each padded to CHUNK, through a ring of ``stages`` stages
    (GATE_MAX_STAGES at most, so two CTAs share an SM).
    ``sweep``: CTA (s, d, r) owns UNIT hidden units of direction d (``ctas_
    per_direction`` = H / UNIT) and keeps their [UNIT, G] rows of Wh
    resident; batch tile k of 64 rows belongs to group k mod ``groups``
    (as many as the SMs hold, at most the tiles), each group walks its
    tiles one after another, T steps each, one barrier round per step
    after the first: ``rounds``. A tile's boxes and coefficient blocks
    hold ``rows`` = min(B, 64) rounded up to 8 rows; its two rings have
    ``stages`` stages of rows x CHUNK each (MIN_STAGES to MAX_STAGES), as
    many as the carve leaves room for.
    ``smem`` are the carves in bytes, as rnn_bwd.cu's gate_smem and
    sweep_carve sum them (the entries refuse any other value)."""
    if cell not in N_GATES:
        raise ValueError(f'rnn_train.plan: no backward sweep for {cell!r}')
    if hidden % 16 or in_dim % 16 or hidden <= 0 or in_dim <= 0:
        raise ValueError(f'rnn_train.plan: H={hidden} or I={in_dim} is not a '
                         'positive multiple of 16')
    g = N_GATES[cell] * hidden
    nk = N_COEF[cell]
    # the gate product
    bb = min(batch, TILE)
    tb = TILE // bb
    m_tiles = -(-t_len // tb) * -(-batch // bb)
    n_tiles = -(-hidden // GATE_UNITS)
    gate_fixed = 128 + 1024
    gate_stages = min(GATE_MAX_STAGES,
                      (smem_limit - gate_fixed) // GATE_STAGE)
    if gate_stages < GATE_MIN_STAGES:
        raise ValueError(f'rnn_train.plan: {smem_limit} B of shared memory '
                         'hold fewer than two gate-product stages')
    gates = dict(rows=bb, steps=tb, m_tiles=m_tiles, n_tiles=n_tiles,
                 n_cols=n_tiles * GATE_N,
                 k=_round(in_dim, CHUNK) + _round(hidden, CHUNK),
                 stages=gate_stages,
                 smem=gate_fixed + gate_stages * GATE_STAGE,
                 grid=n_tiles * 2 * -(-m_tiles // 2))
    # the sweep
    per_dir = hidden // UNIT
    b_tiles = -(-batch // TILE)
    groups = min(n_sm // (2 * per_dir), b_tiles)
    if groups < 1:
        raise ValueError(f'rnn_train.plan: H={hidden} needs 2 x {per_dir} '
                         f'CTAs, more than {n_sm} SMs')
    rows = TILE if batch >= TILE else _round(batch, 8)
    fixed = (_round(UNIT * _round(g, CHUNK) * 2, 128)
             + COEF_SLOTS * rows * nk * UNIT * 4 + 8 * 128 * 4
             + _round((4 * MAX_STAGES + 2 * COEF_SLOTS) * 8, 128) + 1024
             + (TILE - rows) * CHUNK * 2)
    ring_stage = 2 * rows * CHUNK * 2
    stages = min(MAX_STAGES, (smem_limit - fixed) // ring_stage)
    if stages < MIN_STAGES:
        raise ValueError(f'rnn_train.plan: the {cell} sweep at H={hidden} '
                         f'needs {fixed + MIN_STAGES * ring_stage} B of '
                         f'shared memory, more than {smem_limit}')
    sweep = dict(unit=UNIT, ctas_per_direction=per_dir, tile=TILE,
                 rows=rows, groups=groups,
                 tiles_per_group=-(-b_tiles // groups),
                 chunks=_round(g, CHUNK) // CHUNK, stages=stages,
                 smem=fixed + stages * ring_stage,
                 grid=(per_dir, 2, groups),
                 rounds=-(-b_tiles // groups) * max(t_len - 1, 0))
    return dict(gates=gates, sweep=sweep)


@functools.lru_cache(maxsize=None)
def _gate_columns(cell: str, hidden: int, device: torch.device):
    """The gate product's columns of ``pack_gate_weights`` on ``device``:
    each column's source column of wi / wh and whether it takes the x rows
    and the h rows (built once per shape, on the host)."""
    lstm = cell == 'lstm'
    n = torch.arange(_round(hidden, GATE_UNITS) * 4)
    gate = (n % GATE_N) // GATE_UNITS
    unit = (n // GATE_N) * GATE_UNITS + n % GATE_UNITS
    src = gate if lstm else gate.clamp(max=2)      # GRU n_x, n_h: column n
    col = (src * hidden + unit).clamp(max=N_GATES[cell] * hidden - 1)
    keep_x = (unit < hidden) & (lstm | (gate != 3))
    keep_h = (unit < hidden) & (lstm | (gate != 2))
    return col.to(device), keep_x.to(device), keep_h.to(device)


def pack_gate_weights(cell: str, wi: torch.Tensor,
                      wh: torch.Tensor) -> torch.Tensor:
    """wi [2, I, G], wh [2, H, G] as the gate product reads them: [2, NC,
    KP], one row per product column, K-major: columns in tiles of
    GATE_UNITS hidden units x 4 gate blocks (LSTM i, f, g, o; GRU r, z,
    n_x, n_h, the n gate's x and h halves apart), zero past H; K = the x
    rows (I padded to CHUNK) then the h rows (H padded to CHUNK), the GRU's
    n_x zero in the h rows and n_h in the x rows."""
    i_dim, h = wi.shape[1], wh.shape[1]
    col, keep_x, keep_h = _gate_columns(cell, h, wi.device)
    zero = wi.new_zeros(())
    ip = _round(i_dim, CHUNK)
    out = wi.new_zeros(2, col.numel(), ip + _round(h, CHUNK))
    out[:, :, :i_dim] = torch.where(keep_x, wi.index_select(2, col),
                                    zero).transpose(1, 2)
    out[:, :, ip:ip + h] = torch.where(keep_h, wh.index_select(2, col),
                                       zero).transpose(1, 2)
    return out


def coef_shape(cell: str, t_len: int, batch: int, hidden: int):
    """The gate product's float32 output: [T, 2, H / UNIT, B, N_COEF,
    UNIT], one sweep CTA's block of a step contiguous."""
    return (t_len, 2, hidden // UNIT, batch, N_COEF[cell], UNIT)


def _entry(name: str, n_ptrs: int, n_ints: int):
    fn = getattr(build.library('rnn_bwd'), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sweep(cell: str, x2, hs, cs, dhs, wi, wh, biases, outs):
    """The two launches of one sweep on x2's card: the gate product into
    the coefficient buffer, then the reverse walk into ``outs``."""
    t_len, _, b, i_dim = x2.shape
    h = wh.shape[1]
    p = plan(cell, b, t_len, i_dim, h, *rnn.device_limits(x2.device))
    gates, sweep = p['gates'], p['sweep']
    dev, stream = x2.get_device(), build.stream_of(x2)
    name = f'{cell}_bwd'
    wpk = pack_gate_weights(cell, wi, wh)
    coef = torch.empty(coef_shape(cell, t_len, b, h), dtype=torch.float32,
                       device=x2.device)
    ptrs = (x2, hs) + ((cs,) if cell == 'lstm' else ()) + (dhs, wpk) \
        + biases + (coef,)
    status = _entry(f'rnn_{cell}_bwd_gates_bf16', len(ptrs), 7)(
        *(build.ptr(t) for t in ptrs), t_len, b, i_dim, h, gates['stages'],
        gates['smem'], dev, stream)
    build.check(status, f'rnn_train.{name} (gates)')
    launches[name] += 1
    bar = torch.zeros(2 * sweep['groups'], dtype=torch.int32,
                      device=x2.device)
    ptrs = (coef, wh) + outs
    status = _entry(f'rnn_{cell}_bwd_sweep_bf16', len(ptrs) + 1, 7)(
        *(build.ptr(t) for t in ptrs), build.ptr(bar), t_len, b, h,
        sweep['stages'], sweep['groups'], sweep['smem'], dev, stream)
    build.check(status, f'rnn_train.{name} (sweep)')
    launches[name] += 1


def gru_bwd(dhs, hs, x2, wi, wh, bi, bh):
    """Same contract as :func:`gru_bwd_plain`; two launches on the GPU."""
    if x2.device.type == 'cpu':
        return gru_bwd_plain(dhs, hs, x2, wi, wh, bi, bh)
    t_len, _, b, i = x2.shape
    h = wh.shape[1]
    rnn._check('gru_bwd', x2, (dhs, hs, x2, wi, bi, bh, wh),
               ((t_len, 2, b, h), (t_len, 2, b, h), (t_len, 2, b, i),
                (2, i, 3 * h), (2, 3 * h), (2, 3 * h), (2, h, 3 * h)))
    dgx = x2.new_empty(t_len, 2, b, 3 * h)
    dgh = torch.empty_like(dgx)
    if t_len and b:
        _sweep('gru', x2, hs, None, dhs, wi, wh, (bi, bh), (dgx, dgh))
    return dgx, dgh


def lstm_bwd(dhs, hs, cs, x2, wi, wh, b):
    """Same contract as :func:`lstm_bwd_plain`; two launches on the GPU."""
    if x2.device.type == 'cpu':
        return lstm_bwd_plain(dhs, hs, cs, x2, wi, wh, b)
    t_len, _, batch, i = x2.shape
    h = wh.shape[1]
    rnn._check('lstm_bwd', x2, (dhs, hs, cs, x2, wi, b, wh),
               ((t_len, 2, batch, h), (t_len, 2, batch, h),
                (t_len, 2, batch, h), (t_len, 2, batch, i), (2, i, 4 * h),
                (2, 4 * h), (2, h, 4 * h)))
    dgates = x2.new_empty(t_len, 2, batch, 4 * h)
    if t_len and batch:
        _sweep('lstm', x2, hs, cs, dhs, wi, wh, (b,), (dgates,))
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

