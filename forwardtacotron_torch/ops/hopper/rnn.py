"""Bidirectional recurrences of the bf16 serving path: the ``rnn.cu`` kernels
and their plain twins.

Port of forwardtacotron_tpu/ops/pallas/rnn.py (inference kernels):

  ``gru_xp``   <- gru_from_xp_pallas (body _gru_xp_kernel)
  ``gru``      <- bidir_rnn_pallas, GRU body (_gru_kernel)
  ``lstm``     <- bidir_rnn_pallas, LSTM body (_lstm_kernel)
  ``lstm_mel`` <- lstm_lr_mel_pallas's recurrence (_lstm_mel_kernel)

and of the forward kernels of forwardtacotron_tpu/ops/pallas/rnn_train.py
(the training path): its GRU forward (_gru_fwd_call) is ``gru``, and

  ``lstm_train`` <- _lstm_fwd_call with cells (_lstm_kernel_train): the LSTM
                    that also returns every step's cell state

Every function takes the kernels' time-major layout: inputs [T, 2, B, *]
with direction 1 already flipped by the caller, weights stacked per
direction as [2, K, G] in torch gate order (GRU r, z, n; LSTM i, f, g, o).
Each wrapper launches one CUDA kernel, which runs the whole sequence, for
CUDA tensors (bfloat16 only, as the TPU kernels are), and the plain twin for
CPU tensors; nothing else selects between them. Every one launches rnn.cu's
step-major kernel (``rnn_step_kernel``) with the launch plan of
:func:`plan`; a shape the plan refuses raises ValueError before any
launch.

Numerics of the TPU kernels, which the twins repeat: products accumulate in
float32, gates run in float32, the carried h and c are rounded to the input
dtype every step, the GRU adds bi and bh apart in float32, the LSTM takes
one bias (bi + bh, summed by the caller in the input dtype), and the mel
stage multiplies the rounded h by W_mel and rounds the result.
"""

import ctypes
from typing import Optional

import torch

from forwardtacotron_torch.ops.hopper import build

# launches of each CUDA kernel since the counts were last set to 0
launches = {'gru_xp': 0, 'gru': 0, 'lstm': 0, 'lstm_mel': 0, 'lstm_train': 0}

# rnn.cu's step-major schedule (rnn_step_kernel): batch rows of a tile (one
# consumer warpgroup's), depth of one ring stage, fewest and most ring
# stages per warpgroup (a warpgroup frees a stage only once it has waited
# for the chunk two after it, so the producer needs a third)
WG_ROWS = 64
CHUNK = 64
MIN_STAGES = 3
MAX_STAGES = 8
# gru_xp: slots of one tile's three [64, unit] gx_t boxes per warpgroup
GX_SLOTS = 2
# the modes of rnn_step_kernel, by wrapper
MODES = ('gru', 'gru_xp', 'lstm', 'lstm_mel', 'lstm_train')


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def plan(mode: str, batch: int, t_len: int, in_dim: int, hidden: int,
         n_mels: int, n_sm: int, smem_limit: int) -> dict:
    """The launch plan of rnn.cu's step-major kernel for ``mode`` ('gru':
    MODE_GRU_X, 'gru_xp': MODE_GRU_XP, 'lstm': MODE_LSTM_X, 'lstm_mel':
    MODE_LSTM_MEL, 'lstm_train': MODE_LSTM_TRAIN) on a card
    of ``n_sm`` SMs whose blocks may opt in to ``smem_limit`` bytes of
    shared memory. Needs no card. Raises ValueError where the kernel cannot
    take the shape. For 'gru_xp' the input is the precomputed projection
    gx [T, 2, B, 3H] and ``in_dim`` is 0: no x rows in the slice.

    A CTA owns ``unit`` hidden units of one direction (their weight slice
    stays in its shared memory, K padded to CHUNK multiples, with the GRU's
    n gate as two column blocks and the LSTM's W_mel columns beside the
    gates; 'gru_xp' has h rows only and the columns r, z, n_h), so a
    direction takes ``hidden / unit`` CTAs; one CTA per SM,
    so ``groups`` = the SM count over 2 directions x that, at most the
    number of batch tiles. Batch tile k (rows [k tile, (k+1) tile) cut at
    the batch, ``tile`` = 64, one consumer warpgroup's rows) belongs to
    group k mod ``groups``; each step a CTA walks all its group's tiles,
    ``tiles_per_group`` at most, then meets its group at one barrier:
    ``rounds`` = T serial rounds. With two tiles or more per group the CTA
    runs 2 ``warpgroups`` on alternate tiles, each with a ring of as many
    stages of tile x CHUNK bf16 as the carve leaves room for (MIN_STAGES
    to MAX_STAGES); 'gru_xp' also keeps GX_SLOTS slots of a tile's three
    [tile, unit] gx_t boxes per warpgroup, which its producer loads before
    the step barrier. The first slice width that leaves MIN_STAGES wins:
    LSTM-mel takes 16 units (its mel columns fill the wgmma width); the
    GRUs and the other LSTMs 32 where a batch of several tiles makes each
    staged byte feed more columns, 8 at one tile for more CTAs and a
    shorter step, and the other widths where the carve or the SMs refuse
    the first; one warpgroup only where no width leaves two rings room.
    ``smem`` is the carve in bytes, as rnn.cu's step_carve sums it (the
    entry refuses any other value).
    ``mel_cols``: the W_mel columns of one CTA (a multiple of 8, the wgmma
    width; columns past M are zero). ``cluster`` is 1: no clusters."""
    if mode not in MODES:
        raise ValueError(f'rnn.plan: no step-major kernel for {mode!r}')
    if hidden % 16 or in_dim % 16:
        raise ValueError(f'rnn.plan: H={hidden} or I={in_dim} is not a '
                         'multiple of 16')
    mel, xp = mode == 'lstm_mel', mode == 'gru_xp'
    if xp and in_dim:
        raise ValueError('rnn.plan: gru_xp takes in_dim 0 (gx holds the '
                         'input projection)')
    tile = WG_ROWS
    n_tiles = -(-batch // tile)
    depth = -(-in_dim // CHUNK) * CHUNK + -(-hidden // CHUNK) * CHUNK
    units = (16,) if mel else (8, 16, 32) if n_tiles == 1 else (32, 16, 8)
    why = []
    for warpgroups in (2, 1):
        for unit in units:
            if hidden % unit:
                continue
            per_dir = hidden // unit
            mel_cols = 8 * -(-n_mels // (8 * per_dir)) if mel else 0
            if mel_cols > 16:
                raise ValueError(f'rnn.plan: M={n_mels} needs {mel_cols} mel '
                                 f'columns per CTA at H={hidden}; the kernel '
                                 'takes 16')
            groups = min(n_sm // (2 * per_dir), n_tiles)
            if groups < 1:
                why.append(f'{unit} units: 2 x {per_dir} CTAs > {n_sm} SMs')
                continue
            tiles_per_group = -(-n_tiles // groups)
            if warpgroups > tiles_per_group:
                continue
            cols = 3 * unit if xp else 4 * unit + mel_cols
            gx = (128 + warpgroups * GX_SLOTS * 3 * tile * unit * 2
                  if xp else 0)
            fixed = (_align128(depth * cols * 2)
                     + _align128(2 * 4 * unit * 4) + _align128(32 * MAX_STAGES)
                     + gx + 1024)
            ring_stage = warpgroups * tile * CHUNK * 2
            stages = min(MAX_STAGES, (smem_limit - fixed) // ring_stage)
            if stages < MIN_STAGES:
                why.append(f'{unit} units x {warpgroups} warpgroups: '
                           f'{fixed + MIN_STAGES * ring_stage} B')
                continue
            return dict(unit=unit, ctas_per_direction=per_dir, tile=tile,
                        groups=groups, tiles_per_group=tiles_per_group,
                        warpgroups=warpgroups, stages=stages, chunk=CHUNK,
                        cluster=1, mel_cols=mel_cols,
                        smem=fixed + stages * ring_stage,
                        grid=(per_dir, 2, groups), rounds=t_len)
    raise ValueError(f'rnn.plan: no {mode} slice of I={in_dim}, H={hidden} '
                     f'fits {n_sm} SMs of {smem_limit} B shared memory '
                     f'({"; ".join(why)})')


_limits = {}


def device_limits(device: torch.device):
    """(SM count, opt-in shared memory per block) of a CUDA device, from
    torch where it reports them, else from rnn.cu's query entry."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _limits:
        props = torch.cuda.get_device_properties(index)
        smem = getattr(props, 'shared_memory_per_block_optin', None)
        n_sm = props.multi_processor_count
        if not smem:
            fn = build.library('rnn').rnn_device_limits
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            got_sm, got_smem = ctypes.c_int(), ctypes.c_int()
            build.check(fn(index, ctypes.byref(got_sm), ctypes.byref(got_smem)),
                        'rnn.device_limits')
            n_sm, smem = got_sm.value, got_smem.value
        _limits[index] = (n_sm, smem)
    return _limits[index]



def _steps(x2: torch.Tensor, wi: Optional[torch.Tensor], wh: torch.Tensor,
           bi: Optional[torch.Tensor], bh: Optional[torch.Tensor],
           wm: Optional[torch.Tensor] = None, cells: bool = False):
    """The recurrences of all the kernels, one step at a time in float32
    (the input projection too, so memory stays at one step's size).

    GRU: bh given (bi and bh added apart), 3 gates; with wi None, x2 holds
    the precomputed input projections. LSTM: bh None, bi is the summed
    bias, 4 gates, and wm [2, H, M] turns each step's output into
    h_t @ wm; with ``cells`` it returns (hs, cs), cs the rounded cell
    states."""
    dt = x2.dtype
    t_len, _, batch, _ = x2.shape
    hidden = wh.shape[1]
    whf = wh.float()
    wif = None if wi is None else wi.float()
    bif = None if bi is None else bi.float()[:, None]
    bhf = None if bh is None else bh.float()[:, None]
    h = x2.new_zeros(2, batch, hidden, dtype=torch.float32)
    c = torch.zeros_like(h)
    width = hidden if wm is None else wm.shape[-1]
    out = x2.new_empty(t_len, 2, batch, width)
    cs = x2.new_empty(t_len, 2, batch, hidden) if cells else None
    for t in range(t_len):
        gx = x2[t].float()
        if wif is not None:
            gx = torch.baddbmm(bif, gx, wif)
        if bhf is not None:                             # GRU
            xr, xz, xn = gx.chunk(3, dim=-1)
            hr, hz, hn = torch.baddbmm(bhf, h, whf).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = ((1.0 - z) * n + z * h).to(dt).float()
        else:                                           # LSTM
            i, f, g, o = (gx + torch.bmm(h, whf)).chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = (torch.sigmoid(o) * torch.tanh(c_new)).to(dt).float()
            c = c_new.to(dt).float()
            if cells:
                cs[t] = c
        out[t] = h if wm is None else torch.bmm(h, wm.float())
    return (out, cs) if cells else out


def gru_xp_plain(xp2: torch.Tensor, wh: torch.Tensor,
                 bh: torch.Tensor) -> torch.Tensor:
    """GRU from precomputed input projections: xp2 [T, 2, B, 3H] (x @ wi +
    bi), wh [2, H, 3H], bh [2, 3H]; h starts at 0. Returns [T, 2, B, H] in
    xp2's dtype."""
    return _steps(xp2, None, wh, None, bh)


def gru_plain(x2: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
              bi: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """GRU with the input projection: x2 [T, 2, B, I], wi [2, I, 3H], wh
    [2, H, 3H], bi/bh [2, 3H]. Returns [T, 2, B, H] in x2's dtype."""
    return _steps(x2, wi, wh, bi, bh)


def lstm_plain(x2: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """LSTM with the input projection: x2 [T, 2, B, I], wi [2, I, 4H], wh
    [2, H, 4H], b [2, 4H] (bi + bh). Returns [T, 2, B, H] in x2's dtype."""
    return _steps(x2, wi, wh, b, None)


def lstm_mel_plain(x2: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
                   b: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """``lstm_plain`` whose every step ends in h_t @ wm[d]: wm [2, H, M].
    Returns [T, 2, B, M] in x2's dtype (the hidden states never leave)."""
    return _steps(x2, wi, wh, b, None, wm)


def lstm_train_plain(x2: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
                     b: torch.Tensor):
    """``lstm_plain`` that also returns the cell states: (hs, cs), both
    [T, 2, B, H] in x2's dtype, cs[t] = c_t as the next step reads it."""
    return _steps(x2, wi, wh, b, None, cells=True)


def _kernel(entry: str, n_ptrs: int, n_ints: int):
    fn = getattr(build.library('rnn'), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x2: torch.Tensor, tensors, shapes) -> None:
    """Raise unless every tensor is a contiguous bfloat16 CUDA tensor on
    x2's device with the expected shape, and the widths are multiples of
    16 (the kernel's unit block and tensor-core depth)."""
    if x2.device.type != 'cuda':
        raise ValueError(f'rnn.{name}: unsupported device {x2.device}')
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           or t.device != x2.device for t in tensors):
        raise ValueError(f'rnn.{name}: the kernel takes contiguous bfloat16 '
                         'tensors on one CUDA device')
    got = [tuple(t.shape) for t in tensors]
    if got != [tuple(s) for s in shapes] or any(
            d % 16 for d in (x2.shape[-1], tensors[-1].shape[-2])):
        raise ValueError(f'rnn.{name}: bad shapes {got}, expected {shapes} '
                         'with the input width and H multiples of 16')


def _launch(name: str, entry: str, ptrs, ints, x2: torch.Tensor,
            out, hidden: int, cells: bool = False, n_mels: int = 0):
    """One launch of ``entry`` with the plan of mode ``name`` after the
    shape arguments ``ints``; ``cells`` adds the LSTM's c buffer (each
    thread reads only the rows and units it wrote)."""
    t_len, _, b = x2.shape[:3]
    if t_len == 0 or b == 0:
        return out
    ints = (*ints, *_plan_ints(name, x2, hidden, n_mels))
    # h ping-pong buffer shared by the CTAs of a direction (written before
    # it is read, so left uninitialized) and their barrier counters
    hbuf = torch.empty(2, 2, b, hidden, dtype=torch.bfloat16,
                       device=x2.device)
    scratch = (hbuf,)
    if cells:
        scratch += (torch.empty(2, b, hidden, dtype=torch.bfloat16,
                                device=x2.device),)
    bar = torch.zeros(2 * b, dtype=torch.int32, device=x2.device)
    outs = out if isinstance(out, tuple) else (out,)
    fn = _kernel(entry, len(ptrs) + len(outs) + len(scratch) + 1,
                 len(ints) + 1)
    status = fn(*(build.ptr(t) for t in ptrs + outs + scratch),
                build.ptr(bar), *ints, x2.get_device(), build.stream_of(x2))
    build.check(status, f'rnn.{name}')
    launches[name] += 1
    return out


def _plan_ints(mode: str, x2: torch.Tensor, hidden: int, n_mels: int = 0):
    """The step-major entry's plan arguments for x2 on its card: unit, (mel
    columns,) warpgroups, groups, ring stages, carve."""
    t_len, _, batch, in_dim = x2.shape
    if mode == 'gru_xp':
        in_dim = 0
    p = plan(mode, batch, t_len, in_dim, hidden, n_mels,
             *device_limits(x2.device))
    return (p['unit'], *((p['mel_cols'],) if mode == 'lstm_mel' else ()),
            p['warpgroups'], p['groups'], p['stages'], p['smem'])


def gru_xp(xp2: torch.Tensor, wh: torch.Tensor,
           bh: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`gru_xp_plain`; one launch on the GPU."""
    if xp2.device.type == 'cpu':
        return gru_xp_plain(xp2, wh, bh)
    t_len, _, b, g = xp2.shape
    h = g // 3
    _check('gru_xp', xp2, (xp2, bh, wh),
           ((t_len, 2, b, 3 * h), (2, 3 * h), (2, h, 3 * h)))
    out = xp2.new_empty(t_len, 2, b, h)
    return _launch('gru_xp', 'rnn_gru_xp_bf16', (xp2, wh, bh),
                   (t_len, b, h), xp2, out, h)


def gru(x2: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
        bi: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`gru_plain`; one launch on the GPU."""
    if x2.device.type == 'cpu':
        return gru_plain(x2, wi, wh, bi, bh)
    t_len, _, b, i = x2.shape
    h = wh.shape[1]
    _check('gru', x2, (x2, wi, bi, bh, wh),
           ((t_len, 2, b, i), (2, i, 3 * h), (2, 3 * h), (2, 3 * h),
            (2, h, 3 * h)))
    out = x2.new_empty(t_len, 2, b, h)
    return _launch('gru', 'rnn_gru_x_bf16', (x2, wi, wh, bi, bh),
                   (t_len, b, i, h), x2, out, h)


def lstm(x2: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
         b: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`lstm_plain`; one launch on the GPU."""
    if x2.device.type == 'cpu':
        return lstm_plain(x2, wi, wh, b)
    t_len, _, batch, i = x2.shape
    h = wh.shape[1]
    _check('lstm', x2, (x2, wi, b, wh),
           ((t_len, 2, batch, i), (2, i, 4 * h), (2, 4 * h), (2, h, 4 * h)))
    out = x2.new_empty(t_len, 2, batch, h)
    return _launch('lstm', 'rnn_lstm_x_bf16', (x2, wi, wh, b),
                   (t_len, batch, i, h), x2, out, h, cells=True)


def lstm_mel(x2: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
             b: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`lstm_mel_plain`; one launch on the GPU."""
    if x2.device.type == 'cpu':
        return lstm_mel_plain(x2, wi, wh, b, wm)
    t_len, _, batch, i = x2.shape
    h = wh.shape[1]
    m = wm.shape[-1]
    _check('lstm_mel', x2, (x2, wi, b, wm, wh),
           ((t_len, 2, batch, i), (2, i, 4 * h), (2, 4 * h), (2, h, m),
            (2, h, 4 * h)))
    out = x2.new_empty(t_len, 2, batch, m)
    return _launch('lstm_mel', 'rnn_lstm_mel_bf16', (x2, wi, wh, b, wm),
                   (t_len, batch, i, h, m), x2, out, h, cells=True,
                   n_mels=m)


def lstm_train(x2: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
               b: torch.Tensor):
    """Same contract as :func:`lstm_train_plain`; one launch on the GPU."""
    if x2.device.type == 'cpu':
        return lstm_train_plain(x2, wi, wh, b)
    t_len, _, batch, i = x2.shape
    h = wh.shape[1]
    _check('lstm_train', x2, (x2, wi, b, wh),
           ((t_len, 2, batch, i), (2, i, 4 * h), (2, 4 * h), (2, h, 4 * h)))
    out = (x2.new_empty(t_len, 2, batch, h), x2.new_empty(t_len, 2, batch, h))
    return _launch('lstm_train', 'rnn_lstm_train_bf16', (x2, wi, wh, b),
                   (t_len, batch, i, h), x2, out, h)
