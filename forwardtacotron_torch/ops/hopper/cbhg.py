"""The CBHG front's kernels and their plain twins, in float32 or bfloat16:

- ``bank_pool_proj``: bank -> pool -> mask -> proj1 (``cbhg_front.cu``),
  port of forwardtacotron_tpu/ops/pallas/cbhg.py::bank_pool_proj_pallas;
- ``pool_proj1``: pool -> mask -> proj1's convolution on the bank concat
  (``pool.cu``), port of cbhg.py::pool_proj1_pallas;
- ``pool_mask``: pool -> mask on the bank concat (``pool.cu``), port of
  cbhg.py::pool_mask_pallas.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
twin for CPU tensors; nothing else selects between them.
"""

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from forwardtacotron_torch.ops.hopper import build

# launches of each kernel since its count was last set to 0
launches = 0              # bank_pool_proj (cbhg_front.cu)
pool_proj1_launches = 0   # pool_proj1 (pool.cu)
pool_mask_launches = 0    # pool_mask (pool.cu)

# the JAX gate's halo clause (forwardtacotron_tpu/ops/pallas/cbhg.py
# BANK_HALO): the largest bank tap offset K // 2 the kernel is planned for
BANK_HALO = 8
SMEM_BYTES = 232448

# bf16 entry (cbhg_front_mma_kernel): TM output frames per CTA, whose bank
# runs over BANK_ROWS rows (nine 16-row tiles: frames t0-2 .. t0+141, of
# which t0-2 .. t0+TM feed the pool); the bank walks C in chunks of CB
# columns, each chunk's taps x input channels stream through a ring of
# stages of at most KS rows, the projection's P in tiles of PT columns.
# Weight rows are LD elements (CB + 8: ldmatrix without bank conflicts).
TM = 128
BANK_ROWS = 144
CB = 64
PT = 256
KS = 256
LD = CB + 8
STAGE_BYTES = 2 * KS * LD
MAX_STAGES = 4
# the ring's mbarriers, the f32 bank rows of one chunk ([TM + 3, LD]), the
# tile's mask (TM + 4) and the chunk's folded BN (2 CB) in f32, and its
# pooled bf16 rows ([TM + 2, LD]), beside the halo and the ring
_MMA_FIXED = 64 + 4 * ((TM + 3) * LD + TM + 4 + 2 * CB) + 2 * (TM + 2) * LD

# f32 entry (cbhg_front_kernel, FMA): F32_TT frames per CTA, one bank
# column per thread in chunks of F32_CB, one output column per thread in
# tiles of F32_PT
F32_TT = 32
F32_CB = 256
F32_PT = 256
_F32_FIXED = 4 * (F32_TT + 2) * F32_CB

_ENTRY = {torch.float32: 'cbhg_front_f32', torch.bfloat16: 'cbhg_front_bf16'}


def bank_pool_proj_plain(x: torch.Tensor, mask: torch.Tensor,
                         bank_w: Sequence[torch.Tensor],
                         bn_scale: torch.Tensor, bn_bias: torch.Tensor,
                         proj_w: torch.Tensor, proj_scale: torch.Tensor,
                         proj_bias: torch.Tensor) -> torch.Tensor:
    """Whole CBHG front with both eval BatchNorms folded.

    x [B, T, C_in] (zero beyond each item's length), bank_w[i] [k, C_in, C]
    for k = i + 1 and proj_w [3, K*C, P] share one dtype; mask [B, T]
    (1.0 at valid frames, applied after the pool), bn_scale/bn_bias [K, C]
    (scale' = scale*rsqrt(var+eps), bias' = bias - mean*scale') and
    proj_scale/proj_bias [P] are float32. Returns [B, T, P] in x's dtype,
    conv_project1's output after ReLU and BN. The bank, its ReLU/BN and the
    pool run in float32; each pooled branch is rounded to x's dtype before
    the projection, as in the TPU kernel."""
    dt = x.dtype
    xf = x.float()
    b, t, _ = x.shape
    c = bank_w[0].shape[-1]
    acc = torch.zeros(b, t, proj_w.shape[-1], device=x.device)
    neg = torch.full((b, 1, c), float('-inf'), device=x.device)
    for bi, w in enumerate(bank_w):
        k = w.shape[0]
        xp = torch.nn.functional.pad(xf, (0, 0, k // 2, k - 1 - k // 2))
        cols = torch.cat([xp[:, j:j + t] for j in range(k)], dim=-1)
        y = cols @ w.reshape(-1, c).float()
        y = torch.relu(y) * bn_scale[bi] + bn_bias[bi]
        y = torch.maximum(torch.cat([neg, y[:, :-1]], dim=1), y)
        y = (y * mask[:, :, None]).to(dt).float()
        yp = torch.nn.functional.pad(y, (0, 0, 1, 1))
        for d in range(3):
            acc = acc + yp[:, d:d + t] @ proj_w[d, bi * c:(bi + 1) * c].float()
    return (torch.relu(acc) * proj_scale + proj_bias).to(dt)


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(dtype: torch.dtype, k_max: int, c_in: int, c: int, p: int,
         smem_limit: int = SMEM_BYTES) -> dict:
    """The launch plan of the front kernel for ``dtype``: a bank of
    ``k_max`` convolutions C_in -> C and a projection to P. Needs no card.

    Both entries hold the input halo of a frame tile (frames t0-2-K//2 ..
    t0+tile+K-1-K//2, the bank's taps over the pool's and the projection's
    look-around) in shared memory, resident over all branches where it
    fits (``n_ci`` 1), else in ``n_ci`` chunks of ``ki`` input channels
    reloaded for each bank chunk. bf16: ``tile`` = TM frames, C padded to
    CB-column chunks (``c_pad``), P to PT-column tiles (``p_pad``), C_in to
    ``n_ci`` x ``ki`` (multiples of 16), and a ring of ``stages`` (2 ..
    MAX_STAGES) weight stages of STAGE_BYTES. f32: ``tile`` = F32_TT
    frames, ``ki`` a multiple of 4 (the last chunk may be narrower), C and
    P in chunks of 256 columns. Raises ``ValueError`` for a shape it cannot
    plan."""
    if min(k_max, c_in, c, p) <= 0:
        raise ValueError(f'K={k_max}, C_in={c_in}, C={c}, P={p} must be '
                         'positive')
    if k_max // 2 > BANK_HALO:
        raise ValueError(f'K={k_max}: bank taps reach K//2 = {k_max // 2} '
                         f'frames back, more than the {BANK_HALO}-frame '
                         'halo of the JAX gate')
    if dtype == torch.bfloat16:
        rows = BANK_ROWS + k_max - 1
        c_in16 = _round(c_in, 16)
        for n_ci in range(1, c_in16 // 16 + 1):
            ki = _round(-(-c_in16 // n_ci), 16)
            halo = 2 * rows * (ki + 8)
            stages = min(MAX_STAGES,
                         (smem_limit - _MMA_FIXED - halo) // STAGE_BYTES)
            if stages >= 2:
                return dict(tile=TM, ki=ki, n_ci=n_ci, c_in_pad=ki * n_ci,
                            c_pad=_round(c, CB), p_pad=_round(p, PT),
                            stages=stages,
                            smem=_MMA_FIXED + halo + stages * STAGE_BYTES)
        raise ValueError(f'K={k_max}: no input-channel chunk leaves room '
                         f'for 2 ring stages in {smem_limit} bytes')
    if dtype == torch.float32:
        rows = F32_TT + 2 + k_max
        c_in4 = _pad4(c_in)
        ki = min(c_in4, (smem_limit - _F32_FIXED) // (4 * rows) // 4 * 4)
        if ki < 4:
            raise ValueError(f'K={k_max}: the halo does not fit {smem_limit} '
                             'bytes')
        return dict(tile=F32_TT, ki=ki, n_ci=-(-c_in4 // ki),
                    c_in_pad=c_in4, c_pad=_pad4(c), p_pad=_round(p, F32_PT),
                    stages=0, smem=_F32_FIXED + 4 * rows * ki)
    raise ValueError(f'dtype {dtype}: float32 or bfloat16 only')


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def shape_error(k_max: int, c_in: int, c: int, p: int) -> Optional[str]:
    """Why the kernel cannot take a front of ``k_max`` bank convolutions
    C_in -> C and a projection to P, or None when it can: it tiles P and
    chunks C and C_in, so it refuses only what the JAX gate refuses too
    (bank taps beyond its halo). Needs no card: the wrapper raises with it,
    and the CBHG's gate consults it."""
    for dtype in _ENTRY:
        try:
            plan(dtype, k_max, c_in, c, p)
        except ValueError as e:
            return str(e)
    return None


def pad_channels(x, bank_w, bn_scale, bn_bias, proj_w, c_in_pad, c_pad):
    """The front with zero input channels up to ``c_in_pad`` and zero bank
    channels up to ``c_pad``: a zero bank channel has zero weights and a
    zero folded BatchNorm, so it pools to 0 and meets zero projection rows;
    the output is unchanged."""
    c_in, c = bank_w[0].shape[1:]
    k_max, p = len(bank_w), proj_w.shape[-1]
    pi, pc = c_in_pad - c_in, c_pad - c
    proj_w = F.pad(proj_w.reshape(3, k_max, c, p), (0, 0, 0, pc))
    return (F.pad(x, (0, pi)).contiguous(),
            [F.pad(w, (0, pc, 0, pi)).contiguous() for w in bank_w],
            F.pad(bn_scale, (0, pc)).contiguous(),
            F.pad(bn_bias, (0, pc)).contiguous(),
            proj_w.reshape(3, k_max * c_pad, p).contiguous())


def pack_weights(bank_w: Sequence[torch.Tensor], proj_w: torch.Tensor,
                 fp: dict):
    """The bf16 kernel's weight streams for plan ``fp``: each ring stage a
    contiguous block that is its shared-memory image (one bulk copy), rows
    of LD elements, zero where C_in, C, P or the row are padded:

    - bank: the K branches' [k, C_in, C] as [n_cc, n_ci, sum(k) * ki, LD]
      (column chunk, input-channel chunk, then branch k's k * ki rows from
      row k(k-1)/2 * ki, tap j and input channel i as its row j * ki + i,
      each row the chunk's CB columns); a stage is up to KS consecutive
      rows of one branch;
    - proj: [3, K*C, P] as [n_pt, K, n_cc, 3, PT, LD] (projection tile,
      branch, bank column chunk, tap d, output column n, then the chunk's
      CB bank columns); a stage is one [PT, LD] block.

    The B operands of the kernel's m16n8k16 products: bank rows k-major
    (ldmatrix .trans), proj rows n-major. A few copies per call."""
    c_in, c = bank_w[0].shape[1:]
    k_max, p = len(bank_w), proj_w.shape[-1]
    ki, n_ci, cp, pp = fp['ki'], fp['n_ci'], fp['c_pad'], fp['p_pad']
    n_cc, n_pt = cp // CB, pp // PT
    taps = k_max * (k_max + 1) // 2
    bank = F.pad(torch.cat(list(bank_w)), (0, cp - c, 0, n_ci * ki - c_in))
    bank = bank.reshape(taps, n_ci, ki, n_cc, CB).permute(3, 1, 0, 2, 4)
    pw = F.pad(proj_w.reshape(3, k_max, c, p), (0, pp - p, 0, cp - c))
    pw = pw.reshape(3, k_max, n_cc, CB, n_pt, PT).permute(4, 1, 2, 0, 5, 3)
    return (F.pad(bank, (0, LD - CB)).reshape(n_cc, n_ci, taps * ki, LD),
            F.pad(pw, (0, LD - CB)))


def _kernel(dtype):
    fn = getattr(build.library('cbhg_front'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bank_pool_proj(x: torch.Tensor, mask: torch.Tensor,
                   bank_w: Sequence[torch.Tensor],
                   bn_scale: torch.Tensor, bn_bias: torch.Tensor,
                   proj_w: torch.Tensor, proj_scale: torch.Tensor,
                   proj_bias: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`bank_pool_proj_plain`, one kernel launch on
    the GPU with the launch :func:`plan` of x's dtype. float32: C_in and C
    are padded to multiples of 4 with zero channels here, which is exact.
    bfloat16: the weights are packed by :func:`pack_weights` here (zero
    channels and columns where C_in, C or P are padded, also exact). What
    :func:`shape_error` refuses raises ``ValueError``."""
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
            or proj_scale.shape != (p,) or proj_bias.shape != (p,)):
        raise ValueError('bank_pool_proj: bad shapes')
    err = shape_error(k_max, c_in, c, p)
    if err:
        raise ValueError(f'bank_pool_proj: {err}')
    dt = x.dtype
    args = (x, mask, *bank_w, bn_scale, bn_bias, proj_w, proj_scale,
            proj_bias)
    if (dt not in _ENTRY or any(w.dtype != dt for w in bank_w)
            or proj_w.dtype != dt
            or any(a.dtype != torch.float32
                   for a in (mask, bn_scale, bn_bias, proj_scale, proj_bias))
            or any(not a.is_contiguous() or a.device != x.device
                   for a in args)):
        raise ValueError('bank_pool_proj: x and the conv weights must be '
                         'contiguous float32 or bfloat16 tensors of one '
                         'dtype, mask and the folded BatchNorms contiguous '
                         'float32, all on one device')
    fp = plan(dt, k_max, c_in, c, p)
    if dt == torch.bfloat16:
        if c_in % 8:       # rows of whole 16-byte vectors
            x = F.pad(x, (0, 8 - c_in % 8)).contiguous()
        bank, proj = pack_weights(bank_w, proj_w, fp)
        pad = (0, fp['c_pad'] - c)
        bn_scale = F.pad(bn_scale, pad).contiguous()
        bn_bias = F.pad(bn_bias, pad).contiguous()
    elif (c_in, c) != (fp['c_in_pad'], fp['c_pad']):
        x, bank_w, bn_scale, bn_bias, proj_w = pad_channels(
            x, bank_w, bn_scale, bn_bias, proj_w, fp['c_in_pad'],
            fp['c_pad'])
    if dt == torch.float32:
        bank = torch.cat([w.reshape(-1) for w in bank_w])
        proj = proj_w
    out = torch.empty(b, t, p, dtype=dt, device=x.device)
    if b == 0 or t == 0:
        return out
    status = _kernel(dt)(*(build.ptr(a) for a in (
        x, mask, bank, bn_scale, bn_bias, proj, proj_scale, proj_bias, out)),
        b, t, x.shape[-1], fp['c_pad'], p, k_max, fp['ki'], fp['n_ci'],
        fp['stages'],
        x.get_device(), build.stream_of(x))
    build.check(status, 'cbhg_front')
    global launches
    launches += 1
    return out


# ------------------------------------------------------------ pool.cu

# pool_proj1: K chunks of POOL_KCH input channels (both entries); the f32
# entry tiles the projection's columns by PROJ_TILE (its weight is padded
# to it), the bf16 entry takes them in column blocks of one of
# POOL_MMA_COLS (wgmma widths)
POOL_KCH = 32
POOL_MMA_COLS = (64, 96, 128, 192, 256)
PROJ_TILE = 64
# bf16 entry (pool_proj1_mma_kernel<N>): POOL_TILE virtual frames per CTA
# (the items' frames with one zero gap frame after each), their pooled
# rows (the taps' halo) in four 8-channel planes of 16-byte rows, the raw
# x rows behind them (the pool's left neighbour too) in a ring of
# POOL_X_STAGES stages; the main ring's stages hold the pooled rows and the
# chunk's three weight taps of N columns
POOL_TILE = 128
POOL_PLANE = (POOL_TILE + 2) * 16
POOL_X_BYTES = ((POOL_TILE + 3) * POOL_KCH * 2 + 127) // 128 * 128
POOL_X_STAGES = 4
POOL_MIN_STAGES = 2
POOL_MAX_STAGES = 8
_POOL_BARS = 256 + ((POOL_TILE + 2) * 8 + 127) // 128 * 128   # + rows table
_POOL_MASK_ENTRY = {torch.float32: 'pool_mask_f32',
                    torch.bfloat16: 'pool_mask_bf16'}
_POOL_PROJ_ENTRY = {torch.float32: 'pool_proj1_f32',
                    torch.bfloat16: 'pool_proj1_bf16'}


def _pooled(x: torch.Tensor) -> torch.Tensor:
    """max(x[t-1], x[t]) in x's dtype, x[0] at t = 0 (the -inf left pad)."""
    return torch.maximum(x, torch.cat([x[:, :1], x[:, :-1]], dim=1))


def pool_mask_plain(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MaxPool1d(2, 1, pad 1)[:T] over time, then the tail mask, as the TPU
    kernel computes it: x [B, T, KC]; mask [B, T] float32 (1.0 at valid
    frames) rounded to x's dtype and multiplied in it. Returns [B, T, KC]
    in x's dtype."""
    return _pooled(x) * mask.to(x.dtype)[:, :, None]


def pool_proj1_plain(x: torch.Tensor, mask: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """The pool and mask of :func:`pool_mask_plain`, the masked value a
    float32 product rounded to x's dtype, then proj1's k=3 convolution with
    no bias and a zero boundary: x [B, T, KC], mask [B, T] float32, w
    [3, KC, P] in x's dtype. The three taps' products are summed in float32
    and rounded once. Returns [B, T, P] in x's dtype (before ReLU/BN)."""
    dt, t = x.dtype, x.shape[1]
    pooled = (_pooled(x).float() * mask[:, :, None]).to(dt).float()
    pp = F.pad(pooled, (0, 0, 1, 1))
    acc = sum(pp[:, d:d + t] @ w[d].float() for d in range(3))
    return acc.to(dt)


def pool_proj1_shape_error(kc: int) -> Optional[str]:
    """Why the kernel cannot take a bank concat of ``kc`` channels, or None
    when it can (every B, T and P). Needs no card."""
    if kc <= 0 or kc % POOL_KCH:
        return f'KC={kc} must be a positive multiple of {POOL_KCH}'
    return None


def pack_proj_weight(w: torch.Tensor, p_pad: int) -> torch.Tensor:
    """w [3, KC, P] as the f32 kernel reads it: [3, P_pad, KC], each output
    column's inputs contiguous, zero columns from P to ``p_pad``."""
    return F.pad(w.transpose(1, 2), (0, 0, 0, p_pad - w.shape[2])).contiguous()


def pool_proj1_plan(batch: int, t_len: int, kc: int, p: int,
                    smem_limit: int = SMEM_BYTES) -> dict:
    """The bf16 kernel's launch plan. Needs no card; raises ValueError
    where the kernel cannot take the shape.

    Frames are tiled over the virtual axis of all items, each followed by
    one zero gap frame (``virtual_frames`` = B (T + 1)), ``tile`` frames per
    CTA; the P output columns in ``n_blocks`` blocks of ``n_cols`` (the
    narrowest of POOL_MMA_COLS that covers ceil(P / n_blocks), n_blocks =
    ceil(P / 256)), a CTA per (tile, block): ``grid``. K runs in ``chunks``
    of POOL_KCH channels through a main ring of ``stages`` stages (as many
    as fit, POOL_MIN_STAGES to POOL_MAX_STAGES) and a raw x ring of
    ``x_stages``. ``smem`` is the carve in bytes as pool.cu's mma_smem sums
    it (the entry refuses any other value)."""
    err = pool_proj1_shape_error(kc)
    if err:
        raise ValueError(f'pool_proj1_plan: {err}')
    if batch < 1 or t_len < 1 or p < 1:
        raise ValueError(f'pool_proj1_plan: empty shape B={batch} '
                         f'T={t_len} P={p}')
    virtual = batch * (t_len + 1)
    if virtual > 2 ** 31 - 1 - 2 * POOL_TILE:
        raise ValueError(f'pool_proj1_plan: B (T + 1) = {virtual} frames '
                         'exceed 32-bit indices')
    n_blocks = -(-p // POOL_MMA_COLS[-1])
    n = next(c for c in POOL_MMA_COLS if c * n_blocks >= p)
    stage = 4 * POOL_PLANE + 3 * n * POOL_KCH * 2
    fixed = _POOL_BARS + POOL_X_STAGES * POOL_X_BYTES
    stages = min(POOL_MAX_STAGES, (smem_limit - fixed) // stage)
    if stages < POOL_MIN_STAGES:
        raise ValueError(f'pool_proj1_plan: {fixed + 2 * stage} B of shared '
                         f'memory needed, {smem_limit} available')
    tiles = -(-virtual // POOL_TILE)
    return dict(n_cols=n, n_blocks=n_blocks, tile=POOL_TILE,
                virtual_frames=virtual, tiles=tiles, chunk=POOL_KCH,
                chunks=kc // POOL_KCH, stages=stages,
                x_stages=POOL_X_STAGES, smem=fixed + stages * stage,
                grid=tiles * n_blocks)


def pack_proj_stages(w: torch.Tensor, n: int, n_blocks: int) -> torch.Tensor:
    """w [3, KC, P] as the bf16 kernel's weight stages, each the shared-
    memory image one bulk copy moves: [n_blocks][KC / 32][3 taps][n / 8
    column groups][4 channel groups][8 columns][8 channels] (core matrices,
    K-major), zero columns from P to n x n_blocks."""
    kc, p = w.shape[1], w.shape[2]
    wp = F.pad(w, (0, n * n_blocks - p))
    return wp.reshape(3, kc // POOL_KCH, POOL_KCH // 8, 8, n_blocks, n // 8,
                      8).permute(4, 1, 0, 5, 2, 6, 3).contiguous()


def _pool_lib(entry: str, n_ptr: int, n_int: int):
    fn = getattr(build.library('pool'), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_pool_args(name, x, mask):
    if (x.dtype not in _POOL_MASK_ENTRY or mask.dtype != torch.float32
            or any(not t.is_contiguous() or t.device != x.device
                   for t in (x, mask))):
        raise ValueError(f'{name}: x must be a contiguous float32 or bfloat16 '
                         'tensor and mask a contiguous float32 one on its '
                         'device')
    if x.dim() != 3 or mask.shape != x.shape[:2]:
        raise ValueError(f'{name}: bad shapes x {tuple(x.shape)}, mask '
                         f'{tuple(mask.shape)}')


def pool_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`pool_mask_plain`, one kernel launch on the
    GPU; every B, T and KC."""
    if x.device.type == 'cpu':
        return pool_mask_plain(x, mask)
    if x.device.type != 'cuda':
        raise ValueError(f'pool_mask: unsupported device {x.device}')
    _check_pool_args('pool_mask', x, mask)
    b, t, kc = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    status = _pool_lib(_POOL_MASK_ENTRY[x.dtype], 3, 4)(
        build.ptr(x), build.ptr(mask), build.ptr(out), b, t, kc,
        x.get_device(), build.stream_of(x))
    build.check(status, 'pool_mask')
    global pool_mask_launches
    pool_mask_launches += 1
    return out


def pool_proj1(x: torch.Tensor, mask: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`pool_proj1_plain`, one kernel launch on the
    GPU; every B, T and P, KC a multiple of ``POOL_KCH``. The weight is
    packed here: bf16 by :func:`pack_proj_stages` for the launch plan of
    :func:`pool_proj1_plan`, f32 by :func:`pack_proj_weight`. What
    :func:`pool_proj1_shape_error` refuses raises ``ValueError``."""
    if x.device.type == 'cpu':
        return pool_proj1_plain(x, mask, w)
    if x.device.type != 'cuda':
        raise ValueError(f'pool_proj1: unsupported device {x.device}')
    _check_pool_args('pool_proj1', x, mask)
    b, t, kc = x.shape
    if w.dim() != 3 or w.shape[:2] != (3, kc) or w.dtype != x.dtype \
            or w.device != x.device:
        raise ValueError(f'pool_proj1: w must be [3, {kc}, P] of x\'s dtype '
                         f'on x\'s device, not {tuple(w.shape)} {w.dtype}')
    err = pool_proj1_shape_error(kc)
    if err:
        raise ValueError(f'pool_proj1: {err}')
    p = w.shape[2]
    out = torch.empty(b, t, p, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if x.dtype == torch.bfloat16:
        plan = pool_proj1_plan(b, t, kc, p)
        wpk = pack_proj_stages(w, plan['n_cols'], plan['n_blocks'])
        status = _pool_lib(_POOL_PROJ_ENTRY[x.dtype], 4, 9)(
            build.ptr(x), build.ptr(mask), build.ptr(wpk), build.ptr(out), b,
            t, kc, p, plan['n_cols'], plan['n_blocks'], plan['stages'],
            plan['smem'], x.get_device(), build.stream_of(x))
    else:
        wt = pack_proj_weight(w, -(-p // PROJ_TILE) * PROJ_TILE)
        status = _pool_lib(_POOL_PROJ_ENTRY[x.dtype], 4, 6)(
            build.ptr(x), build.ptr(mask), build.ptr(wt), build.ptr(out), b,
            t, kc, p, wt.shape[1], x.get_device(), build.stream_of(x))
    build.check(status, 'pool_proj1')
    global pool_proj1_launches
    pool_proj1_launches += 1
    return out
