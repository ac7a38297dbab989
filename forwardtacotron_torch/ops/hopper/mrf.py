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
# a tile's channels split over a cluster of at most MAX_CLUSTER CTAs of
# SLICES channels each: C (padded to a power of two) is capped there
MAX_CHANNELS = 256
MAX_CLUSTER = 8
SLICES = (64, 32, 16)
# time tiles the plan tries, largest first (the window is t_tile + 2 HALO
# rows, at most 384: three 64-row wgmma tiles per consumer warpgroup)
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
# the kernel sizes (branches) and dilations (units per branch) a level's
# launch parameters hold: every unit of a kernel size of at least 2 adds at
# least 2 samples to its branch's span, so the halo holds HALO / 2 of them;
# branches are held to the same count. A 1-tap convolution reads no
# neighbour, so a level whose kernel sizes are all 1 takes any number of
# units (the kernel needs no dilation of theirs).
MAX_BRANCHES = MAX_UNITS = HALO // 2
# threads per CTA: bf16 two consumer warpgroups and a producer warp, f32
# 512 FMA threads
THREADS = {torch.bfloat16: 288, torch.float32: 512}
# f32 accumulator registers a bf16 consumer thread holds at most: three
# 64-row tiles of N = CS columns (CS / 2 each)
MAX_ACC_REGS = 96

# launches of the CUDA kernel since the count was last set to 0
launches = 0

_ENTRY = {torch.float32: 'mrf_f32', torch.bfloat16: 'mrf_bf16'}


def padded_channels(c: int) -> int:
    """The channels the kernel runs a level of ``c`` channels at: the next
    power of two, at least 16 (the wrapper pads with zero channels)."""
    return max(16, 1 << (c - 1).bit_length())


def padded_in_channels(c_in: int) -> int:
    """The upsampler's input channels as the kernel runs them: a power of
    two from 16 up to KC (a ring stage holds KC / C_in taps), a multiple of
    KC above."""
    if c_in <= KC:
        return padded_channels(c_in)
    return -(-c_in // KC) * KC


def _al(n: int) -> int:
    return (n + 127) & ~127


def carve(elt: int, c: int, cs: int, t_tile: int, stages: int,
          c_in: int = 0, in_rows: int = 0) -> dict:
    """The kernel's shared-memory carve (byte offsets, ``mrf.cu``
    ``carve``): the ring (bf16), its mbarriers, a zero guard (bf16), cur,
    ubuf (ups_mrf, when ``c_in``), src (bf16, and f32 where the tile's
    channels span a cluster), ybuf, the f32 branch sum; the ups_mrf input
    tile starts at src. bf16 buffers are planar (8-channel planes of rows
    of 16 bytes), f32 rows are padded by 16 bytes."""
    mma = elt == 2
    pad = 0 if mma else 16 // elt
    tw = t_tile + 2 * HALO
    sl = _al(tw * (cs + pad) * elt)
    v = {'ring': 0, 'bars': stages * cs * KC * 2 if mma else 0}
    v['guard'] = v['bars'] + _al(2 * MAX_STAGES * 8)
    v['cur'] = v['guard'] + (GUARD if mma else 0)
    v['ubuf'] = v['cur'] + sl
    v['src'] = v['ubuf'] + (sl if c_in else 0)
    v['ybuf'] = v['src'] + (_al(tw * (c + pad) * elt) if mma or cs < c
                            else 0)
    v['sum'] = v['ybuf'] + sl
    v['total'] = v['sum'] + _al(t_tile * (cs + 1) * 4)
    if c_in:
        v['total'] = max(v['total'],
                         v['src'] + _al(in_rows * (c_in + pad) * elt))
    return v


def branch_span(kr: int, dils: Sequence[int]) -> int:
    """Samples of context one branch reads on each side of an output."""
    return sum((kr // 2) * d + kr // 2 for d in dils)


def level_error(c: int, krs: Sequence[int],
                dils: Sequence[int]) -> Optional[str]:
    """Why no plan can take a level of these channels, kernel sizes and
    dilations (before shared memory is counted), or None."""
    if not 0 < c <= MAX_CHANNELS:
        return (f'C={c} is not supported: the kernel splits a tile\'s '
                f'channels over a cluster of at most {MAX_CLUSTER} CTAs of '
                f'at most {SLICES[0]} channels each, which holds '
                f'C <= {MAX_CHANNELS}')
    if not (krs and dils):
        return (f'at least one kernel size and one dilation, got '
                f'{tuple(krs)}, {tuple(dils)}')
    if min(krs) < 1 or min(dils) < 1 \
            or max(branch_span(k, dils) for k in krs) > HALO:
        return (f'kernel sizes whose span fits the {HALO}-sample halo only, '
                f'got {tuple(krs)}, {tuple(dils)}')
    # (the halo clause above already holds a kernel size of 2 or more to
    # MAX_UNITS dilations)
    if len(krs) > MAX_BRANCHES:
        return (f'at most {MAX_BRANCHES} kernel sizes (the launch parameters '
                f'hold as many), got {len(krs)} kernel sizes')
    return None


def plan(dtype: torch.dtype, c: int, krs: Sequence[int],
         dils: Sequence[int], c_in: int = 0, s_out: int = 1, s_up: int = 1,
         smem_limit: Optional[int] = None, in_halo: int = IN_HALO) -> dict:
    """The launch plan of one level of ``c`` channels (``c_in`` > 0: behind
    an upsample by ``s_up`` into ``s_out`` output phases, ``ups_mrf``, whose
    input tile has ``in_halo`` rows of halo on each side). The
    widest channel slice (the fewest CTAs per cluster: wgmma's N and the
    f32 threads' work) with the largest time tile of at least
    MIN_PREFERRED_TILE samples, else the same without that floor, whose
    carve fits ``smem_limit`` (default SMEM_BYTES) with at least MIN_STAGES
    ring stages (bf16); the ring takes what is left, up to MAX_STAGES.
    Raises ValueError with the reason where no plan fits. Needs no card:
    the wrappers launch with it and ``shape_error`` consults it."""
    if dtype not in THREADS:
        raise ValueError(f'the kernel takes float32 or bfloat16, got {dtype}')
    smem_limit = smem_limit or SMEM_BYTES
    err = level_error(c, krs, dils)
    if err:
        raise ValueError(err)
    elt = 2 if dtype == torch.bfloat16 else 4
    c_pad = padded_channels(c)
    ci_pad = padded_in_channels(c_in) if c_in else 0
    smallest = None
    for cs, t_tile in [(cs, t) for floor in (MIN_PREFERRED_TILE, 0)
                       for cs in SLICES for t in T_TILES if t >= floor]:
        if cs > c_pad or c_pad // cs > MAX_CLUSTER or t_tile % s_out:
            continue
        tw = t_tile + 2 * HALO
        in_rows = (max(-(-tw // s_up), 64) + 2 * in_halo + 1) if c_in else 0
        st = MIN_STAGES if elt == 2 else 0
        v = carve(elt, c_pad, cs, t_tile, st, ci_pad, in_rows)
        smallest = min(smallest or v['total'], v['total'])
        if v['total'] > smem_limit:
            continue
        if elt == 2:
            st = min(MAX_STAGES,
                     st + (smem_limit - v['total']) // (cs * KC * 2))
            v = carve(elt, c_pad, cs, t_tile, st, ci_pad, in_rows)
        return {'dtype': dtype, 'c': c, 'c_pad': c_pad, 'c_in': c_in,
                'c_in_pad': ci_pad, 'cs': cs, 'cluster': c_pad // cs,
                't_tile': t_tile, 'tw': tw,
                'in_halo': in_halo if c_in else 0, 'in_rows': in_rows,
                'stages': st, 'smem': v['total'], 'carve': v,
                'threads': THREADS[dtype],
                'acc_regs': 3 * cs // 2 if elt == 2 else 32}
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


def product_images(taps: torch.Tensor, cs: int) -> torch.Tensor:
    """One product's taps [n, C_out, K] (K a power of two from 16, or a
    multiple of KC) -> its stage images in the kernel's order: where K <
    KC, the taps in groups of KC / K side by side along K, the last group
    padded with zero taps."""
    n, c_out, k = taps.shape
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
                 cs: int) -> torch.Tensor:
    """The level's convolution weights (as :func:`mrf_plain` takes them, C
    padded to the plan's) as the bf16 ring streams them to the CTAs of a
    cluster: [C / cs, stages * cs * KC], per rank in the kernel's order
    (kernel size, unit, first then second convolution, its stages:
    :func:`product_images`)."""
    parts = []
    for i, kr in enumerate(krs):
        w1, w2 = weights[4 * i], weights[4 * i + 2]
        for u in range(w1.shape[0]):
            parts += [product_images(conv_taps(w1[u], kr), cs),
                      product_images(conv_taps(w2[u], kr), cs)]
    return torch.cat(parts, 1).contiguous()


def shape_error(c: int, krs: Sequence[int],
                dils: Sequence[int]) -> Optional[str]:
    """Why the kernel cannot take a level of ``c`` channels with these
    kernel sizes and dilations (in float32 or bfloat16), or None when it
    can. Needs no card: the wrapper raises with it, and the generator's
    gate consults it."""
    for dtype in (torch.float32, torch.bfloat16):
        try:
            plan(dtype, c, krs, dils)
        except ValueError as e:
            return str(e)
    return None


def _kernel(dtype):
    fn = getattr(build.library('mrf'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                            ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p] \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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


class Prepared(NamedTuple):
    """A level's weights as the kernel launches them (:func:`prepare`)."""
    weights: Tuple[torch.Tensor, ...]   # zero channels up to the plan's
    packed: Optional[torch.Tensor]      # the bf16 ring's stage images
    c_pad: int
    cs: int


def prepare(weights: Tuple[torch.Tensor, ...], krs: Sequence[int],
            dils: Sequence[int]) -> Prepared:
    """The level's weights (as :func:`mrf` takes them) padded to the plan's
    channels and, in bf16, packed into the ring's stage images. Fixed for a
    weight set: a caller that launches the level again passes it to
    :func:`mrf` as ``prepared`` and skips this work."""
    krs, dils = tuple(int(k) for k in krs), tuple(int(d) for d in dils)
    dt, c = weights[0].dtype, weights[0].shape[1]
    pl = plan(dt, c, krs, dils)
    if pl['c_pad'] != c:
        weights = pad_weights(weights, krs, c, pl['c_pad'])
    return Prepared(weights, pack_weights(weights, krs, pl['cs'])
                    if dt == torch.bfloat16 else None, pl['c_pad'], pl['cs'])


def check_prepared(name: str, prepared, pl: dict) -> None:
    """Raise ValueError unless ``prepared`` was made for the plan ``pl``."""
    got, want = (prepared.c_pad, prepared.cs), (pl['c_pad'], pl['cs'])
    if got != want:
        raise ValueError(f'{name}: the prepared weights are for (C, slice) '
                         f'= {got}, the launch plan takes {want}')


def launch_args(weights, packed, krs, dils):
    """The arguments the entries share: the weight and bias pointers, the
    packed stages and their length per rank, the kernel sizes and
    dilations."""
    ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    rank_elems = packed.shape[1] if packed is not None else 0
    return (ptrs, ctypes.c_void_p(packed.data_ptr() if packed is not None
                                  else 0), rank_elems,
            (ctypes.c_int * len(krs))(*krs), len(krs),
            (ctypes.c_int * len(dils))(*dils), len(dils))


def mrf(x: torch.Tensor, weights: Tuple[torch.Tensor, ...],
        krs: Sequence[int], dils: Sequence[int],
        prepared: Optional[Prepared] = None) -> torch.Tensor:
    """Same contract as :func:`mrf_plain`, one kernel launch on the GPU.

    The kernel takes C as a power of two from 16 to 256; other C are padded
    with zero channels, which is exact. ``prepared``: :func:`prepare` of
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
    check_prepared('mrf', prepared, pl)
    status = _kernel(dt)(
        build.ptr(x), build.ptr(out),
        *launch_args(prepared.weights, prepared.packed, krs, dils), b, c_pad,
        t, pl['cs'], pl['t_tile'], pl['stages'], x.get_device(),
        build.stream_of(x))
    build.check(status, 'mrf')
    global launches
    launches += 1
    return out[:, :c] if c_pad != c else out
