"""One whole HiFi-GAN MRF level: the ``mrf.cu`` kernel and its plain twin, in
float32 or bfloat16.

Port of forwardtacotron_tpu/ops/pallas/mrf.py::mrf_pallas. Per kernel size
kr, ``len(dils)`` residual units (leaky -> dilated conv(kr, d) -> leaky ->
conv(kr, 1) -> add), then the mean of the kr branches, on channels-major
x [B, C, T]. ``mrf`` launches the CUDA kernel for CUDA tensors and runs the
plain twin for CPU tensors; nothing else selects between them. There is no
gradient: the vocoder only serves, and the TPU kernel has no VJP either.

The kernel's launch plan (:func:`plan`: channels per CTA and cluster size,
time tile, ring stages, the shared-memory carve) and its bf16 weight
packing (:func:`pack_weights`: one shared-memory image per ring stage)
need no card.
"""

import ctypes
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from forwardtacotron_torch.ops.hopper import build

LRELU_SLOPE = 0.1
# the kernel's window carries this many samples of halo on each side: at
# least the accumulated span of the deepest branch (kr=11, d=(1,3,5): 60)
HALO = 64
# shared memory a block may use on an H100
SMEM_BYTES = 232448
# The narrow form: a tile's channels split over a cluster of at most
# MAX_CLUSTER CTAs of SLICES channels each, every CTA holding the full-width
# source of each convolution; C (padded to a power of two) up to
# MAX_CHANNELS.
MAX_CHANNELS = 256
MAX_CLUSTER = 8
SLICES = (64, 32, 16)
# The wide form, past MAX_CHANNELS: each CTA holds only its own slice of
# WIDE_SLICES[0] channels (WIDE_SLICES[1] past WIDE_CLUSTER of them), the
# products stream the source from the cluster's CTAs in KC-channel chunks;
# a cluster of up to WIDE_CLUSTER CTAs (past 8 a non-portable size), C
# padded to a multiple of the slice: up to MAX_WIDE_CHANNELS.
WIDE_CLUSTER = 16
WIDE_SLICES = (64, 128)
MAX_WIDE_CHANNELS = WIDE_CLUSTER * WIDE_SLICES[-1]
# time tiles the plan tries, largest first (the window is t_tile + 2 HALO
# rows, at most 384: three 64-row wgmma tiles per consumer warpgroup; at
# 128-channel slices two, so at most 256 rows)
T_TILES = (256, 192, 128, 96, 64, 48, 32, 24, 16)
# a narrower slice is taken before a tile below this many samples (a
# larger tile, less halo recomputed, beats a deeper ring: measured)
MIN_PREFERRED_TILE = 32
# the bf16 weight ring: stages of [CS, KC] bf16
KC = 64
MIN_STAGES, MAX_STAGES = 2, 8
# bf16: bytes of zeros before the window buffers (64 rows of a plane)
GUARD = 1024
# rows of input halo on each side of the ups_mrf input tile, at least (more
# where the upsampler's taps reach farther: ups_mrf.in_halo)
IN_HALO = 8
# The dilations a branch of a kernel size of at least 2 takes: every unit
# adds at least 2 samples to its branch's span, which the halo bounds. A
# 1-tap convolution reads no neighbour, so a level whose kernel sizes are
# all 1 takes any number of units. The kernel reads the branches (weight
# pointers, kernel sizes) from a table in device memory
# (:func:`branch_table`), so their number is not bounded by the launch's
# parameter block; levels of more than LEGACY_BRANCHES kernel sizes are
# taken where the Pallas kernel can hold them (:func:`pallas_vmem_bytes`).
MAX_UNITS = HALO // 2
LEGACY_BRANCHES = HALO // 2
# the tail's input channels (padded) the kernel took before its input tile
# loaded in chunks
LEGACY_IN_CHANNELS = 1024
# threads per CTA: bf16 two consumer warpgroups and a producer warp, f32
# 512 FMA threads
THREADS = {torch.bfloat16: 288, torch.float32: 512}
# f32 accumulator registers a bf16 consumer thread holds at most: three
# 64-row tiles of N = CS columns (CS / 2 each), two at CS 128
MAX_ACC_REGS = 128

# The JAX package's Pallas kernels keep every weight of a level in VMEM
# (ops/pallas/mrf.py:148-160, 325-327) and set no vmem_limit_bytes, so the
# compiler's scoped limit bounds them: 16 MiB (models/vocoder.py names it).
# Past the shapes the kernel took before (C <= MAX_CHANNELS, at most
# LEGACY_BRANCHES kernel sizes, an input tile that fits whole), the port
# takes a level exactly where the Pallas kernel can hold it by this count.
PALLAS_SCOPED_VMEM = 16 * 2 ** 20

# launches of the CUDA kernel since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: 'mrf_f32', torch.bfloat16: 'mrf_bf16'}


def padded_channels(c: int) -> int:
    """The channels the narrow form runs a level of ``c`` channels at: the
    next power of two, at least 16 (the wrapper pads with zero channels)."""
    return max(16, 1 << (c - 1).bit_length())


def wide_slices(c: int) -> Tuple[int, int]:
    """The wide form's (channel slice, cluster size) for ``c`` channels:
    C in KC-channel chunks, one chunk a CTA up to WIDE_CLUSTER chunks, two
    past that; C is padded to slice x cluster."""
    chunks = -(-c // KC)
    if chunks <= WIDE_CLUSTER:
        return WIDE_SLICES[0], chunks
    return WIDE_SLICES[1], -(-chunks // 2)


def padded_in_channels(c_in: int) -> int:
    """The upsampler's input channels as the kernel runs them: a power of
    two from 16 up to KC (a ring stage holds KC / C_in taps), a multiple of
    KC above."""
    if c_in <= KC:
        return padded_channels(c_in)
    return -(-c_in // KC) * KC


def pallas_vmem_bytes(c: int, krs: Sequence[int], n_units: int,
                      elt: int) -> int:
    """At least the VMEM one ``mrf_pallas`` step holds at its smallest tile
    (128 samples), as the JAX generator calls it (``im2col=True``): every
    weight and bias of the level, the double-buffered input window, mask
    and output blocks, and the im2col scratch, in an ``elt``-byte dtype."""
    t_tile = 128
    t_w = t_tile + 2 * HALO
    weights = sum(2 * n_units * (c * kr * c + c) for kr in krs) * elt
    blocks = 2 * (c * t_w + t_w + c * t_tile) * elt
    scratch = max(krs) * c * t_w * elt
    return weights + blocks + scratch


def pallas_error(what: str, need: int) -> Optional[str]:
    """The refusal of a level the Pallas kernel cannot hold, or None."""
    if need <= PALLAS_SCOPED_VMEM:
        return None
    return (f'{what}: the JAX package\'s Pallas kernel would hold at least '
            f'{need} bytes of VMEM at its smallest tile, past the '
            f'{PALLAS_SCOPED_VMEM}-byte scoped limit, so no shape like it '
            'runs there either')


def _al(n: int) -> int:
    return (n + 127) & ~127


def carve(elt: int, c: int, cs: int, t_tile: int, stages: int,
          c_in: int = 0, in_rows: int = 0, wide: bool = False,
          cw: int = 0) -> dict:
    """The kernel's shared-memory carve (byte offsets, ``mrf.cu``
    ``carve``). Narrow: the ring (bf16), its mbarriers, a zero guard
    (bf16), cur, ubuf (ups_mrf, when ``c_in``), src (bf16, and f32 where
    the tile's channels span a cluster), ybuf, the f32 branch sum; the
    ups_mrf input tile starts at src. Wide: the ring, its mbarriers, ubuf,
    the guard, cur, abuf (bf16: two KC-channel chunks of the source), ybuf,
    the sum; the input tile starts at cur. The input tile holds ``cw``
    input channels (default ``c_in``: whole). bf16 buffers are planar
    (8-channel planes of rows of 16 bytes), f32 rows are padded by 16
    bytes."""
    mma = elt == 2
    pad = 0 if mma else 16 // elt
    tw = t_tile + 2 * HALO
    sl = _al(tw * (cs + pad) * elt)
    cw = cw or c_in
    v = {'ring': 0, 'bars': stages * cs * KC * 2 if mma else 0}
    if wide:
        v['ubuf'] = v['bars'] + _al(2 * MAX_STAGES * 8)
        v['guard'] = v['ubuf'] + (sl if c_in else 0)
        v['cur'] = v['guard'] + (GUARD if mma else 0)
        v['abuf'] = v['src'] = v['cur'] + sl
        v['ybuf'] = v['abuf'] + (2 * _al(tw * KC * elt) if mma else 0)
        v['tile'] = v['cur']
    else:
        v['guard'] = v['bars'] + _al(2 * MAX_STAGES * 8)
        v['cur'] = v['guard'] + (GUARD if mma else 0)
        v['ubuf'] = v['cur'] + sl
        v['src'] = v['ubuf'] + (sl if c_in else 0)
        v['ybuf'] = v['src'] + (_al(tw * (c + pad) * elt) if mma or cs < c
                                else 0)
        v['abuf'] = v['ybuf']
        v['tile'] = v['src']
    v['sum'] = v['ybuf'] + sl
    v['total'] = v['sum'] + _al(t_tile * (cs + 1) * 4)
    if c_in:
        v['total'] = max(v['total'],
                         v['tile'] + _al(in_rows * (cw + pad) * elt))
    return v


def branch_span(kr: int, dils: Sequence[int]) -> int:
    """Samples of context one branch reads on each side of an output."""
    return sum((kr // 2) * d + kr // 2 for d in dils)


def level_error(c: int, krs: Sequence[int],
                dils: Sequence[int]) -> Optional[str]:
    """Why no plan can take a level of these channels, kernel sizes and
    dilations (before shared memory and the Pallas count), or None."""
    if not 0 < c <= MAX_WIDE_CHANNELS:
        return (f'C={c} is not supported: the kernel splits a tile\'s '
                f'channels over a cluster of at most {WIDE_CLUSTER} CTAs of '
                f'at most {WIDE_SLICES[-1]} channels each, which holds '
                f'C <= {MAX_WIDE_CHANNELS}')
    if not (krs and dils):
        return (f'at least one kernel size and one dilation, got '
                f'{tuple(krs)}, {tuple(dils)}')
    if min(krs) < 1 or min(dils) < 1 \
            or max(branch_span(k, dils) for k in krs) > HALO:
        return (f'kernel sizes whose span fits the {HALO}-sample halo only, '
                f'got {tuple(krs)}, {tuple(dils)}')
    # (the halo clause above already holds a kernel size of 2 or more to
    # MAX_UNITS dilations)
    return None


def _describe(c, krs, dils, dtype, c_in=0):
    return (f'C={c}{f" behind C_in={c_in}" if c_in else ""} with kernel '
            f'sizes {tuple(krs)} and {len(dils)} dilations in '
            f'{str(dtype).replace("torch.", "")}')


def _search(dtype, c, c_in, s_out, s_up, in_halo, smem_limit, wide,
            chunks):
    """The first plan of the search order (see :func:`plan`) whose carve
    fits ``smem_limit``, and the smallest carve seen. ``chunks``: for each
    shape the whole input tile, then (True) the tile in chunks."""
    elt = 2 if dtype == torch.bfloat16 else 4
    pad = 0 if elt == 2 else 16 // elt
    ci_pad = padded_in_channels(c_in) if c_in else 0
    if wide:
        cs, n = wide_slices(c)
        shapes = [(cs, t) for t in T_TILES
                  if not (elt == 2 and cs > 64 and t + 2 * HALO > 256)]
        c_pad = cs * n
    else:
        c_pad = padded_channels(c)
        shapes = [(cs, t) for floor in (MIN_PREFERRED_TILE, 0)
                  for cs in SLICES for t in T_TILES if t >= floor
                  if cs <= c_pad and c_pad // cs <= MAX_CLUSTER]
    st = MIN_STAGES if elt == 2 else 0
    smallest = None
    for (cs, t_tile), chunked in itertools.product(
            shapes, (False, True) if chunks and c_in else (False,)):
        if t_tile % s_out:
            continue
        tw = t_tile + 2 * HALO
        in_rows = (max(-(-tw // s_up), 64) + 2 * in_halo + 1) if c_in else 0
        cw, ci = ci_pad, ci_pad
        if chunked:
            # the input tile in chunks of cw channels (a multiple of KC):
            # the widest that fits, then as even as the chunk count allows
            v = carve(elt, c_pad, cs, t_tile, st, KC, in_rows, wide)
            room = (smem_limit - v['tile'] - 127) // (in_rows * elt) - pad
            widest = min(room // KC * KC, ci_pad)
            if widest < KC or widest == ci_pad:
                continue
            groups = -(-ci_pad // widest)
            cw = -(-ci_pad // groups // KC) * KC
            ci = groups * cw
        v = carve(elt, c_pad, cs, t_tile, st, ci, in_rows, wide, cw)
        smallest = min(smallest or v['total'], v['total'])
        if v['total'] > smem_limit:
            continue
        stages = st
        if elt == 2:
            stages = min(MAX_STAGES,
                         st + (smem_limit - v['total']) // (cs * KC * 2))
            v = carve(elt, c_pad, cs, t_tile, stages, ci, in_rows, wide, cw)
        mt = 2 if cs > 64 else 3
        return {'dtype': dtype, 'c': c, 'c_pad': c_pad, 'c_in': c_in,
                'c_in_pad': ci, 'cs': cs, 'cluster': c_pad // cs,
                't_tile': t_tile, 'tw': tw,
                'in_halo': in_halo if c_in else 0, 'in_rows': in_rows,
                'stages': stages, 'smem': v['total'], 'carve': v,
                'threads': THREADS[dtype],
                'acc_regs': mt * cs // 2 if elt == 2 else 32,
                'wide': wide, 'cw': cw if c_in else 0,
                'groups': ci // cw if c_in else 0}, smallest
    return None, smallest


def plan(dtype: torch.dtype, c: int, krs: Sequence[int],
         dils: Sequence[int], c_in: int = 0, s_out: int = 1, s_up: int = 1,
         smem_limit: Optional[int] = None, in_halo: int = IN_HALO,
         pallas_need: Optional[int] = None) -> dict:
    """The launch plan of one level of ``c`` channels (``c_in`` > 0: behind
    an upsample by ``s_up`` into ``s_out`` output phases, ``ups_mrf``, whose
    input tile has ``in_halo`` rows of halo on each side). Raises
    ValueError with the reason where no plan fits. Needs no card: the
    wrappers launch with it and ``shape_error`` consults it.

    The search, first fit wins. (1) The narrow form with the whole input
    tile, where C <= MAX_CHANNELS, at most LEGACY_BRANCHES kernel sizes and
    C_in <= LEGACY_IN_CHANNELS: the widest channel slice (the fewest CTAs per cluster:
    wgmma's N and the f32 threads' work) with the largest time tile of at
    least MIN_PREFERRED_TILE samples, else the same without that floor,
    whose carve fits ``smem_limit`` (default SMEM_BYTES) with at least
    MIN_STAGES ring stages (bf16); the ring takes what is left, up to
    MAX_STAGES. These are the plans of every shape the kernel took before
    the wide form. (2) Any other level only where the Pallas kernel can
    hold it (``pallas_need``, default :func:`pallas_vmem_bytes`, at most
    PALLAS_SCOPED_VMEM; else the Pallas reason): the narrow form (C <=
    MAX_CHANNELS) or the wide form (:func:`wide_slices`, C padded to a
    multiple of 64 rather than a power of two, so that the cluster stays
    within WIDE_CLUSTER; at 128-channel slices in bf16 a window of at most
    256 rows), in the order of (1), each shape with the whole input tile,
    else the input tile in chunks of input channels, the widest that fits
    (a large time tile recomputes less halo than a whole tile saves)."""
    if dtype not in THREADS:
        raise ValueError(f'the kernel takes float32 or bfloat16, got {dtype}')
    smem_limit = smem_limit or SMEM_BYTES
    err = level_error(c, krs, dils)
    if err:
        raise ValueError(err)
    elt = 2 if dtype == torch.bfloat16 else 4
    c_pad = padded_channels(c)
    ci_pad = padded_in_channels(c_in) if c_in else 0
    args = (dtype, c, c_in, s_out, s_up, in_halo, smem_limit)
    seen = []
    if c_pad <= MAX_CHANNELS and len(krs) <= LEGACY_BRANCHES \
            and ci_pad <= LEGACY_IN_CHANNELS:
        pl, smallest = _search(*args, False, False)
        if pl:
            return pl
        seen.append(smallest)
    need = pallas_vmem_bytes(c, krs, len(dils), elt) \
        if pallas_need is None else pallas_need
    err = pallas_error(_describe(c, krs, dils, dtype, c_in), need)
    if err:
        raise ValueError(err)
    pl, smallest = _search(*args, c_pad > MAX_CHANNELS, True)
    if pl:
        return pl
    seen.append(smallest)
    smallest = min((v for v in seen if v), default=None)
    ring = f' with {MIN_STAGES} ring stages' if elt == 2 else ''
    raise ValueError(
        f'no launch plan: no time tile of a {c}-channel level'
        f'{f" behind a {c_in}-channel upsample" if c_in else ""} fits '
        f'{smem_limit} bytes of shared memory per block{ring} in '
        f'{str(dtype).replace("torch.", "")} (the smallest carve takes '
        f'{smallest} bytes)')


def pack_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """Conv1d weight [C_out, C_in, k] -> [C_out, k * C_in], im2col rows
    j-major (column j * C_in + c_in), the layout of the JAX package's
    ``pack_conv_weight``."""
    c_out, c_in, k = weight.shape
    return weight.permute(0, 2, 1).reshape(c_out, k * c_in)


def _leaky(v: torch.Tensor) -> torch.Tensor:
    # max(v, s * v) with s in the activation's dtype, as the TPU kernel
    # computes it (its slope is a weakly typed constant)
    return torch.maximum(v, v * torch.tensor(LRELU_SLOPE, dtype=v.dtype))


def mrf_plain(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
              krs: Sequence[int], dils: Sequence[int]) -> torch.Tensor:
    """x [B, C, T] -> [B, C, T]. ``weights``: per kr in order (w1 [U, C,
    kr*C], b1 [U, C, 1], w2 [U, C, kr*C], b2 [U, C, 1]), packed as
    :func:`pack_conv_weight`, in x's dtype (the biases may be float32).

    Rounding points, in x's dtype: the leaky; each convolution's float32
    product, then its bias added (a float32 bias is added to the float32
    product and the sum rounded once, as the phase-stacked tail's kernel
    does); the residual add. The branch sum is taken in float32, divided by
    ``len(krs)`` and rounded. Positions outside [0, T) are zero before
    every convolution (the convolutions' zero padding)."""
    dt = x.dtype
    c = x.shape[1]

    def conv(a, w, b, kr, d):
        k = w.reshape(c, kr, c).permute(0, 2, 1)          # [C_out, C_in, kr]
        y = F.conv1d(a.float(), k.float(), padding=(kr // 2) * d,
                     dilation=d)[..., :a.shape[-1]]   # even kr: one extra
        if b.dtype == torch.float32:
            return (y + b).to(dt)
        return y.to(dt) + b

    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i, kr in enumerate(krs):
        w1, b1, w2, b2 = weights[4 * i:4 * i + 4]
        cur = x
        for u, d in enumerate(dils):
            y = conv(_leaky(cur), w1[u], b1[u], kr, d)
            cur = cur + conv(_leaky(y), w2[u], b2[u], kr, 1)
        acc = acc + cur.float()
    return (acc / len(krs)).to(dt)


def stage_images(blocks: torch.Tensor, cs: int) -> torch.Tensor:
    """Weight blocks [n, C_out, K] (K a multiple of KC) -> the ring's stage
    images, [C_out / cs, n * K * cs]: for each cluster rank (its cs output
    channels), block and K chunk of KC columns, the [cs, KC] block as wgmma
    reads B from shared memory (K-major core matrices of 8 rows x 8
    columns, column groups adjacent, then 8-row groups)."""
    t, c_out, k = blocks.shape
    return blocks.reshape(t, c_out // cs, cs // 8, 8, k // KC, KC // 8,
                          8).permute(1, 0, 4, 2, 5, 3, 6).reshape(
                              c_out // cs, -1)


def product_images(taps: torch.Tensor, cs: int, group: int = 0
                   ) -> torch.Tensor:
    """One product's taps [n, C_out, K] (K a power of two from 16, or a
    multiple of KC) -> its stage images in the kernel's order: where K <
    KC, the taps in groups of KC / K side by side along K, the last group
    padded with zero taps. ``group`` (a multiple of KC below K): the kernel
    streams the source in chunks of that many input channels, and each
    chunk's stages come together, tap by tap (chunk-major)."""
    n, c_out, k = taps.shape
    if group and group < k:
        taps = taps.reshape(n, c_out, k // group, group).permute(
            2, 0, 1, 3).reshape(-1, c_out, group)
        k = group
    tps = max(1, KC // k)
    if tps > 1:
        pad = -n % tps
        taps = torch.cat([taps, taps.new_zeros(pad, c_out, k)]) if pad \
            else taps
        taps = taps.reshape(-1, tps, c_out, k).permute(0, 2, 1, 3).reshape(
            -1, c_out, KC)
    return stage_images(taps, cs)


def conv_taps(w: torch.Tensor, kr: int) -> torch.Tensor:
    """A unit's packed weight [C, kr*C] -> its taps [kr, C_out, C_in]."""
    c = w.shape[0]
    return w.reshape(c, kr, c).permute(1, 0, 2)


def pack_weights(weights: Tuple[torch.Tensor, ...], krs: Sequence[int],
                 cs: int, wide: bool = False) -> torch.Tensor:
    """The level's convolution weights (as :func:`mrf_plain` takes them, C
    padded to the plan's) as the bf16 ring streams them to the CTAs of a
    cluster: [C / cs, stages * cs * KC], per rank in the kernel's order
    (kernel size, unit, first then second convolution, its stages:
    :func:`product_images`; in the wide form chunk-major, KC source
    channels a chunk)."""
    parts = []
    for i, kr in enumerate(krs):
        w1, w2 = weights[4 * i], weights[4 * i + 2]
        for u in range(w1.shape[0]):
            parts += [product_images(conv_taps(w1[u], kr), cs,
                                     KC if wide else 0),
                      product_images(conv_taps(w2[u], kr), cs,
                                     KC if wide else 0)]
    return torch.cat(parts, 1).contiguous()


def shape_error(c: int, krs: Sequence[int], dils: Sequence[int],
                dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """Why the kernel cannot take a level of ``c`` channels with these
    kernel sizes and dilations in ``dtype`` (default: float32 or
    bfloat16), or None when it can. Needs no card: the wrapper raises with
    it, and the generator's gate consults it with the activation's
    dtype."""
    for dt in (dtype,) if dtype else (torch.float32, torch.bfloat16):
        try:
            plan(dt, c, krs, dils)
        except ValueError as e:
            return str(e)
    return None


def _kernel(dtype):
    fn = getattr(build.library('mrf'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                            ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p] \
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pad_weights(weights, krs, c, c_pad):
    """The level's weights with zero channels up to ``c_pad``: a zero
    channel stays zero through every unit (zero weights in and out, zero
    bias), so the first C output channels are unchanged."""
    pc = c_pad - c
    out = []
    for i, kr in enumerate(krs):
        for w, b in (weights[4 * i:4 * i + 2], weights[4 * i + 2:4 * i + 4]):
            u = w.shape[0]
            w4 = F.pad(w.reshape(u, c, kr, c), (0, pc, 0, 0, 0, pc))
            out += [w4.reshape(u, c_pad, kr * c_pad).contiguous(),
                    F.pad(b, (0, 0, 0, pc)).contiguous()]
    return tuple(out)


def check_weights(name, weights, krs, u, c, dt, bias_dt, device):
    """Raise ValueError unless ``weights`` are a level's (w1, b1, w2, b2)
    per kernel size: contiguous, 16-byte aligned, on ``device``."""
    if len(weights) != 4 * len(krs):
        raise ValueError(f'{name}: {len(weights)} weight tensors for '
                         f'{len(krs)} kernel sizes (4 each)')
    for i, kr in enumerate(krs):
        for j, want in enumerate(((u, c, kr * c), (u, c, 1)) * 2):
            w = weights[4 * i + j]
            wdt = bias_dt if j % 2 else dt
            if (tuple(w.shape) != want or w.dtype != wdt
                    or w.device != device or not w.is_contiguous()
                    or w.data_ptr() % 16):
                raise ValueError(
                    f'{name}: weight {4 * i + j} must be a contiguous, '
                    f'16-byte aligned {wdt} {want} tensor on {device}, got '
                    f'{w.dtype} {tuple(w.shape)} on {w.device}')


def branch_table(weights: Tuple[torch.Tensor, ...], krs: Sequence[int],
                 dils: Sequence[int]) -> torch.Tensor:
    """The table the kernel reads its branches from (device memory, the
    read-only path): per kernel size the pointers of w1 and w2 and its
    kernel size and span (:func:`branch_span`) as kr | span << 16; int64,
    on the weights' device. (The dilations, of which a kernel size of 2 or
    more has at most MAX_UNITS, travel in the launch's parameters.)"""
    vals = []
    for i, kr in enumerate(krs):
        vals += [weights[4 * i].data_ptr(), weights[4 * i + 2].data_ptr(),
                 int(kr) | branch_span(int(kr), dils) << 16]
    return torch.tensor(vals, dtype=torch.int64, device=weights[0].device)


def pack_biases(weights: Tuple[torch.Tensor, ...],
                krs: Sequence[int]) -> torch.Tensor:
    """Every bias of the level as one tensor [n_br, 2, U, C] (b1 then b2 of
    each kernel size), in the biases' dtype: the kernel addresses a bias by
    arithmetic, with no load of a pointer."""
    return torch.stack([torch.stack([weights[4 * i + 1][..., 0],
                                     weights[4 * i + 3][..., 0]])
                        for i in range(len(krs))]).contiguous()


class Prepared(NamedTuple):
    """A level's weights as the kernel launches them (:func:`prepare`)."""
    weights: Tuple[torch.Tensor, ...]   # zero channels up to the plan's
    packed: Optional[torch.Tensor]      # the bf16 ring's stage images
    c_pad: int
    cs: int
    table: torch.Tensor                 # :func:`branch_table`
    biases: torch.Tensor                # :func:`pack_biases`
    krs: Tuple[int, ...]
    dils: Tuple[int, ...]
    wide: bool


def prepare(weights: Tuple[torch.Tensor, ...], krs: Sequence[int],
            dils: Sequence[int]) -> Prepared:
    """The level's weights (as :func:`mrf` takes them) padded to the plan's
    channels and, in bf16, packed into the ring's stage images, with the
    branch table. Fixed for a weight set: a caller that launches the level
    again passes it to :func:`mrf` as ``prepared`` and skips this work."""
    krs, dils = tuple(int(k) for k in krs), tuple(int(d) for d in dils)
    dt, c = weights[0].dtype, weights[0].shape[1]
    pl = plan(dt, c, krs, dils)
    if pl['c_pad'] != c:
        weights = pad_weights(weights, krs, c, pl['c_pad'])
    packed = pack_weights(weights, krs, pl['cs'], pl['wide']) \
        if dt == torch.bfloat16 else None
    return Prepared(weights, packed, pl['c_pad'], pl['cs'],
                    branch_table(weights, krs, dils),
                    pack_biases(weights, krs), krs, dils, pl['wide'])


def check_prepared(name: str, prepared, pl: dict,
                   krs: Optional[Sequence[int]] = None,
                   dils: Optional[Sequence[int]] = None) -> None:
    """Raise ValueError unless ``prepared`` was made for the plan ``pl``
    (and, where given, these kernel sizes and dilations)."""
    got = (prepared.c_pad, prepared.cs, prepared.wide)
    want = (pl['c_pad'], pl['cs'], pl['wide'])
    krs = prepared.krs if krs is None else tuple(krs)
    dils = prepared.dils if dils is None else tuple(dils)
    if got != want or (prepared.krs, prepared.dils) != (krs, dils):
        raise ValueError(f'{name}: the prepared weights are for (C, slice, '
                         f'wide) = {got}, kernel sizes {prepared.krs} and '
                         f'dilations {prepared.dils}; the launch plan takes '
                         f'{want}, {tuple(krs)} and {tuple(dils)}')


def launch_args(prepared, krs, dils):
    """The arguments the entries share: the branch table, the biases, the
    packed stages and their length per rank, the kernel sizes and
    dilations (the entries check them on the host)."""
    packed = prepared.packed
    rank_elems = packed.shape[1] if packed is not None else 0
    return (ctypes.c_void_p(prepared.table.data_ptr()),
            ctypes.c_void_p(prepared.biases.data_ptr()),
            ctypes.c_void_p(packed.data_ptr() if packed is not None else 0),
            rank_elems, (ctypes.c_int * len(krs))(*krs), len(krs),
            (ctypes.c_int * len(dils))(*dils), len(dils))


def mrf(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
        krs: Sequence[int], dils: Sequence[int],
        prepared: Optional[Prepared] = None) -> torch.Tensor:
    """Same contract as :func:`mrf_plain`, one kernel launch on the GPU.

    The kernel takes C as a power of two from 16 to 256 and, wider, as a
    multiple of its channel slice (:func:`plan`); other C are padded with
    zero channels, which is exact. ``prepared``: :func:`prepare` of
    these weights, made here when not given. What :func:`plan` refuses
    raises ``ValueError``."""
    if x.device.type == 'cpu':
        return mrf_plain(x, weights, krs, dils)
    if x.device.type != 'cuda':
        raise ValueError(f'mrf: unsupported device {x.device}')
    krs, dils = tuple(int(k) for k in krs), tuple(int(d) for d in dils)
    dt = x.dtype
    if dt not in _ENTRY or x.dim() != 3 or not x.is_contiguous():
        raise ValueError('mrf: x must be a contiguous float32 or bfloat16 '
                         f'[B, C, T] tensor, got {dt} {tuple(x.shape)}')
    b, c, t = x.shape
    try:
        pl = plan(dt, c, krs, dils)
    except ValueError as e:
        raise ValueError(f'mrf: {e}') from None
    check_weights('mrf', weights, krs, len(dils), c, dt, dt, x.device)
    c_pad = pl['c_pad']
    if c_pad != c:
        x = F.pad(x, (0, 0, 0, c_pad - c)).contiguous()
    out = torch.empty_like(x)
    if b == 0 or t == 0:
        return out[:, :c]
    prepared = prepared or prepare(weights, krs, dils)
    check_prepared('mrf', prepared, pl, krs, dils)
    status = _kernel(dt)(
        build.ptr(x), build.ptr(out), *launch_args(prepared, krs, dils), b,
        c_pad, t, pl['cs'], pl['t_tile'], pl['stages'], int(pl['wide']),
        x.get_device(), build.stream_of(x))
    build.check(status, 'mrf')
    global launches
    launches += 1
    return out[:, :c] if c_pad != c else out
