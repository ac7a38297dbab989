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

SMEM_BYTES = 232448
# float32 (highway_kernel, FMA): two float32 [R, max(C_in, C)] row tiles
# in a block's shared memory, R from 32 rows down to 1 as rows widen
MAX_WIDTH = SMEM_BYTES // (2 * 1 * 4)
# bfloat16 (highway_mma_kernel): row tiles of (rows, MT, NT): MT 16-row
# tiles and NT n8 column tiles per warp; below 16 rows the 16-row tiling
# with fewer rows. Weights stream KS input channels a stage, rows of LD
# elements (KS + 8: ldmatrix without bank conflicts).
MMA_TILES = ((128, 4, 8), (64, 4, 4), (32, 2, 4), (16, 1, 4))
KS = 32
LD = KS + 8
STAGE_BYTES = 2 * 256 * LD
MIN_STAGES, MAX_STAGES = 2, 4
_BARS = 64   # the ring's mbarriers

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


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(c_in: int, c: int, smem_limit: int = SMEM_BYTES) -> dict:
    """The bfloat16 kernel's launch plan for rows of ``c_in`` channels
    (0 for ``highway_stack``, whose input is the C-wide rows) projected to
    ``c``. Needs no card. The row tile holds two bf16 activation buffers
    [rows, width + 8] and a zero row beside a ring of ``stages``
    STAGE_BYTES weight stages: the largest tile of MMA_TILES that leaves
    MIN_STAGES, with up to MAX_STAGES; past the 16-row tile, fewer rows.
    C_in is padded to ``c_in_pad`` (a multiple of KS), C to ``c_pad``
    (128). Raises ``ValueError`` where not even one row fits."""
    if c <= 0 or c_in < 0:
        raise ValueError(f'C_in={c_in}, C={c}: widths must be positive')
    c_in_p, cp = _round(c_in, KS), _round(c, 128)
    row = 2 * (max(c_in_p, cp) + 8)
    base = dict(c_in_pad=c_in_p, c_pad=cp)
    room = smem_limit - _BARS
    for rows, mt, nt in MMA_TILES:
        stages = min(MAX_STAGES, (room - (2 * rows + 1) * row) // STAGE_BYTES)
        if stages >= MIN_STAGES:
            return dict(base, rows=rows, mt=mt, nt=nt, stages=stages,
                        smem=_BARS + (2 * rows + 1) * row
                        + stages * STAGE_BYTES)
    rows = (room - MIN_STAGES * STAGE_BYTES - row) // (2 * row)
    if rows < 1:
        raise ValueError(f'C_in={c_in}, C={c}: one row of the bf16 kernel '
                         f'takes more than {smem_limit} bytes of shared '
                         'memory')
    return dict(base, rows=rows, mt=1, nt=4, stages=MIN_STAGES,
                smem=_BARS + (2 * rows + 1) * row + MIN_STAGES * STAGE_BYTES)


def pack_weights(pre_w: Optional[torch.Tensor], w: torch.Tensor,
                 hp: dict):
    """The bf16 kernel's weights for plan ``hp``: each ring stage ([256
    columns, KS k], rows of LD elements; the B operand of m16n8k16) one
    contiguous block that is its shared-memory image, zero where padded:

    - pre_w [C_in, C] (or None) as [ceil(c_pad / 256), c_in_pad / KS, 256,
      LD]: its transpose, in chunks of 256 output columns;
    - w [L, C, 2C] as [L, c_pad / 128, c_pad / KS, 128 / G, 2, G, LD]:
      each chunk of 128 output columns as 128 / G warp groups of G h
      columns (W1) then the same G g columns (W2), G = NT / 2 * 8."""
    n_layers, c = w.shape[0], w.shape[1]
    cp, gs = hp['c_pad'], hp['nt'] // 2 * 8
    layers = F.pad(w.reshape(n_layers, c, 2, c), (0, cp - c, 0, 0, 0, cp - c))
    layers = layers.reshape(n_layers, cp // KS, KS, 2, cp // 128, 128 // gs,
                            gs).permute(0, 4, 1, 5, 3, 6, 2)
    layers = F.pad(layers, (0, LD - KS))
    if pre_w is None:
        return None, layers
    c_in_p, n_pre = hp['c_in_pad'], _round(cp, 256) // 256
    pre = F.pad(pre_w, (0, n_pre * 256 - c, 0, c_in_p - pre_w.shape[0]))
    pre = pre.reshape(c_in_p // KS, KS, n_pre, 256).permute(2, 0, 3, 1)
    return F.pad(pre, (0, LD - KS)), layers


def shape_error(c_in: int, c: int) -> Optional[str]:
    """Why the kernel cannot take rows of width ``c_in`` projected to ``c``
    channels, or None when it can (``c_in`` is padded to a multiple of 4
    first), in either dtype. Needs no card: the wrapper raises with it, and
    the CBHG's gate consults it."""
    if c <= 0 or c % 4:
        return f'C={c} must be a positive multiple of 4'
    if c_in <= 0 or max(-(-c_in // 4) * 4, c) > MAX_WIDTH:
        return (f'C_in={c_in}, C={c}: the kernel holds rows of at most '
                f'{MAX_WIDTH} channels in shared memory')
    try:
        plan(c_in, c)
    except ValueError as e:
        return str(e)
    return None


def pad_input_width(a: torch.Tensor, res: torch.Tensor, pre_w: torch.Tensor,
                    c_in_pad: int):
    """a, res and pre_w with zero input columns (rows of pre_w) up to
    ``c_in_pad``: (a + res) @ pre_w gains only zero terms."""
    pc = c_in_pad - a.shape[1]
    return (F.pad(a, (0, pc)).contiguous(), F.pad(res, (0, pc)).contiguous(),
            F.pad(pre_w, (0, 0, 0, pc)).contiguous())


def _entry(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.library('highway'), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _plan_args(hp: dict):
    return hp['rows'], hp['mt'], hp['nt'], hp['stages']


def pre_highway_stack(a: torch.Tensor, res: torch.Tensor,
                      pre_w: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`pre_highway_stack_plain`, one kernel launch
    on the GPU. The kernel takes C_in in multiples of 4; others are padded
    with zero columns here, which is exact. bfloat16: the weights are
    packed for the :func:`plan` by :func:`pack_weights` here. What
    :func:`shape_error` refuses raises ``ValueError``."""
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
    if dt == torch.bfloat16:
        hp = plan(c_in, c)
        pre_t, wp = pack_weights(pre_w, w, hp)
        status = _entry(_ENTRY[dt], 6, 11)(
            *(build.ptr(t) for t in (a, res, pre_t, wp, b, out)), n, c_in,
            hp['c_in_pad'], c, hp['c_pad'], n_layers, *_plan_args(hp),
            a.get_device(), build.stream_of(a))
    else:
        status = _entry(_ENTRY[dt], 6, 5)(
            *(build.ptr(t) for t in (a, res, pre_w, w, b, out)), n, c_in, c,
            n_layers, a.get_device(), build.stream_of(a))
    build.check(status, 'pre_highway_stack')
    global launches
    launches += 1
    return out


def highway_stack(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`highway_stack_plain`, one kernel launch on
    the GPU (``highway.cu`` without its input stage; bfloat16 weights
    packed as in :func:`pre_highway_stack`). What :func:`shape_error`
    refuses raises ``ValueError``."""
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
    if dt == torch.bfloat16:
        hp = plan(0, c)
        wp = pack_weights(None, w, hp)[1]
        status = _entry(_STACK_ENTRY[dt], 4, 9)(
            *(build.ptr(t) for t in (x, wp, b, out)), n, c, hp['c_pad'],
            n_layers, *_plan_args(hp), x.get_device(), build.stream_of(x))
    else:
        status = _entry(_STACK_ENTRY[dt], 4, 4)(
            *(build.ptr(t) for t in (x, w, b, out)), n, c, n_layers,
            x.get_device(), build.stream_of(x))
    build.check(status, 'highway_stack')
    global stack_launches
    stack_launches += 1
    return out
