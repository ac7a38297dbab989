"""The card-free parts of ``mrf.cu``: the launch plans of the MRF level
(``mrf.plan``) and of the tail's level (``ups_mrf.plan``) at every width the
kernels take, their refusals, and the bf16 weight packings, held exactly
against the unpacked weights and walked stage by stage in the order and
with the window, region, clamping and phase arithmetic the kernel uses.

The walks are plain torch in float32 on float32 inputs: each product of a
ring stage is a matmul of the (clamped) window rows the kernel's ldmatrix
reads, so they agree with the twins up to the order of float32 sums (1e-5
of the output's scale).
"""

import itertools

import pytest
import torch
import torch.nn.functional as F
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.ops.hopper import mrf, ups_mrf

SMEM = 232448
TOL = 1e-5
KRS, DILS = (3, 7, 11), (1, 3, 5)
WIDTHS = (8, 16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def _close(got, want, tol=TOL):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


def _leaky(v):
    return torch.maximum(v, 0.1 * v)


# ------------------------------------------------------------------ plans

def _check_plan(pl, dtype, c, c_in=0, s_out=1, s_up=1):
    assert pl['smem'] <= SMEM and pl['smem'] == pl['carve']['total']
    assert pl['c_pad'] >= c and pl['c_pad'] in (16, 32, 64, 128, 256)
    assert pl['cs'] in mrf.SLICES and pl['c_pad'] == pl['cs'] * pl['cluster']
    assert pl['cluster'] <= mrf.MAX_CLUSTER
    assert pl['t_tile'] % s_out == 0 and pl['t_tile'] % 8 == 0
    assert pl['tw'] == pl['t_tile'] + 2 * mrf.HALO <= 384
    if dtype == torch.bfloat16:
        assert mrf.MIN_STAGES <= pl['stages'] <= mrf.MAX_STAGES
        assert pl['acc_regs'] <= mrf.MAX_ACC_REGS
        assert pl['threads'] == 288
    else:
        assert pl['stages'] == 0 and pl['threads'] == 512
    if c_in:
        assert pl['c_in_pad'] >= c_in and pl['c_in_pad'] % 16 == 0
        # the input tile: the window's input rows and in_halo + 1 more on
        # each side (walked below), in_halo IN_HALO or the taps' reach
        assert pl['in_halo'] >= ups_mrf.IN_HALO
        assert pl['in_rows'] == max(-(-pl['tw'] // s_up), 64) \
            + 2 * pl['in_halo'] + 1


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('c', WIDTHS)
@pytest.mark.parametrize('krs,dils', [
    (KRS, DILS), ((4, 6), (1, 2)), ((2, 3, 4, 5, 6, 7, 3, 5), (1,) * 8),
    ((2,), (31,)), ((65,), (1,)), (tuple(range(2, 12)), DILS),
    ((3,) * 12, (1,) * 9), ((3, 5), (1, 2) * 4 + (1,)), ((3,), (1,) * 32),
    ((3,) * 32, (1,)), ((1,), (1,) * 32), ((1,), (1,) * 256)])
def test_mrf_plan_fits(dtype, c, krs, dils):
    """Every width of 8 to 256 channels, odd and even kernel sizes, up to
    32 kernel sizes and 32 dilations, spans up to the halo, and 256
    dilations of 1-tap convolutions: a plan within the H100's shared
    memory per block and the accumulator budget, with a ring of at least
    MIN_STAGES stages in bf16; ``shape_error`` passes."""
    pl = mrf.plan(dtype, c, krs, dils)
    _check_plan(pl, dtype, c)
    assert mrf.shape_error(c, krs, dils) is None


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('s_in,s_up', [(1, 2), (2, 2), (1, 3), (1, 4)])
@pytest.mark.parametrize('c', WIDTHS)
def test_ups_plan_fits(dtype, s_in, s_up, c):
    """Rates 2, 3 and 4 with s_in * s_up <= 4, C_in = 2 C and, below 256
    channels, 2 C + 1 (at 256, 513 input channels overflow the float32
    carve); at each rate the smallest upsampler, one of 32 taps or fewer
    and the first whose taps reach past IN_HALO input rows (the tile's
    halo grows)."""
    wide = next(k for k in range(s_up, 200, 2)
                if ups_mrf.tap_reach(s_up, k) > ups_mrf.IN_HALO)
    for k_up in (s_up + 2 * ((32 - s_up) // 2), s_up, wide):
        for c_in in (2 * c, 2 * c + 1) if c < 256 else (2 * c,):
            pl = ups_mrf.plan(dtype, s_in, s_up, c_in, c, k_up, KRS, DILS)
            _check_plan(pl, dtype, c, c_in, s_in * s_up, s_up)
            assert pl['in_halo'] == ups_mrf.in_halo(s_up, k_up)
            assert ups_mrf.shape_error(s_in, s_up, c_in, c, k_up, KRS,
                                       DILS) is None


def test_plans_at_hifigan_levels():
    """HiFi-GAN v1's levels: one CTA per tile up to 64 channels, clusters
    of 2 and 4 at 128 and 256 in bf16; the tail's levels 2 and 3 keep one
    CTA per tile."""
    got = {c: (mrf.plan(torch.bfloat16, c, KRS, DILS)['cluster'],
               mrf.plan(torch.bfloat16, c, KRS, DILS)['t_tile'])
           for c in (256, 128, 64, 32)}
    assert got == {256: (4, 96), 128: (2, 192), 64: (1, 256), 32: (1, 256)}
    assert mrf.plan(torch.float32, 64, KRS, DILS)['cluster'] == 1
    for s_in, c_in, c in ((1, 128, 64), (2, 64, 32)):
        for dtype in DTYPES:
            assert ups_mrf.plan(dtype, s_in, 2, c_in, c, 4, KRS,
                                DILS)['cluster'] == 1


def test_plans_refuse():
    """C past the cap, more than 32 kernel sizes, a span past the halo
    (where more than 32 dilations of a kernel size of 2 or more land, also
    beside 1-tap convolutions), another dtype, an
    upsampler with k - s odd, C_in past the kernel's 1,024, more than 4
    phases, and a shared memory that holds fewer ring stages than the
    kernel needs: each raises with its reason, and ``shape_error`` reports
    it. (A level of 1-tap convolutions only takes any number of
    dilations, an upsampler any reach and C_in any width up to 1,024:
    tests/test_torch_mrf_gaps.py.)"""
    with pytest.raises(ValueError, match='C=512'):
        mrf.plan(torch.bfloat16, 512, KRS, DILS)
    assert 'C=512' in mrf.shape_error(512, KRS, DILS)
    assert 'at most 32 kernel sizes' in mrf.shape_error(64, (3,) * 33, DILS)
    assert 'halo' in mrf.shape_error(64, (2,), (1,) * 33)
    assert 'halo' in mrf.shape_error(64, (1, 2), (1,) * 33)
    assert 'halo' in mrf.shape_error(64, KRS, (1,) * 9)
    assert 'at least one' in mrf.shape_error(64, (), DILS)
    assert 'halo' in mrf.shape_error(64, (13,), DILS)
    assert 'halo' in mrf.shape_error(64, (2,), (64,))
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        mrf.plan(torch.float16, 64, KRS, DILS)
    assert 'kernel size 5' in ups_mrf.shape_error(1, 2, 64, 32, 5, KRS,
                                                  DILS)
    assert 'C_in=1025' in ups_mrf.shape_error(1, 2, 1025, 64, 4, KRS, DILS)
    assert 'rate 8' in ups_mrf.shape_error(1, 8, 64, 32, 16, KRS, DILS)
    assert 'phases' in ups_mrf.shape_error(2, 3, 64, 32, 5, KRS, DILS)
    # two ring stages of [64, 64] bf16 are 16,384 bytes: a limit that
    # leaves room for the buffers but not for them refuses every plan
    pl = mrf.plan(torch.bfloat16, 64, KRS, DILS)
    base = pl['smem'] - pl['stages'] * 64 * mrf.KC * 2
    with pytest.raises(ValueError, match='2 ring stages'):
        mrf.plan(torch.bfloat16, 32, KRS, DILS, smem_limit=20000)
    tight = mrf.plan(torch.bfloat16, 64, KRS, DILS,
                     smem_limit=base + 2 * 64 * mrf.KC * 2)
    assert tight['stages'] == mrf.MIN_STAGES and tight['t_tile'] == 256
    below = mrf.plan(torch.bfloat16, 64, KRS, DILS,
                     smem_limit=base + 2 * 64 * mrf.KC * 2 - 1)
    assert below['t_tile'] < 256 and below['stages'] >= mrf.MIN_STAGES


def test_carve_order():
    """The carve is in the kernel's order, 128-byte aligned, with src in
    bf16 and, in f32, only where a tile spans a cluster, ubuf only behind
    an upsample; the input tile overlays src, ybuf and the sum."""
    pl = ups_mrf.plan(torch.bfloat16, 1, 2, 512, 256, 4, KRS, DILS)
    v = pl['carve']
    order = [v[k] for k in ('ring', 'bars', 'guard', 'cur', 'ubuf', 'src',
                            'ybuf', 'sum')]
    assert order == sorted(order) and all(o % 128 == 0 for o in order)
    assert v['bars'] == pl['stages'] * pl['cs'] * mrf.KC * 2
    assert v['cur'] - v['guard'] == mrf.GUARD
    tile = pl['in_rows'] * pl['c_in_pad'] * 2
    assert v['total'] >= v['src'] + tile
    one = mrf.plan(torch.bfloat16, 64, KRS, DILS)['carve']
    assert one['ubuf'] == one['src'] < one['ybuf']
    one = mrf.plan(torch.float32, 64, KRS, DILS)['carve']
    assert one['ubuf'] == one['src'] == one['ybuf'] and one['guard'] == one['cur']


# ---------------------------------------------------------------- packing

def _weights(g, c, krs=KRS, units=3, bias_dtype=torch.float32):
    out = []
    for kr in krs:
        for _ in range(2):
            out += [torch.randn(units, c, kr * c, generator=g) / (kr * c) ** .5,
                    (0.1 * torch.randn(units, c, 1, generator=g)).to(bias_dtype)]
    return tuple(out)


class _Stream:
    """The packed stages of every cluster rank, read back in the kernel's
    order: a product's taps, each as the full [C_out, K] block."""

    def __init__(self, packed, cs):
        self.p, self.cs, self.off = packed.float(), cs, 0

    def _stage(self, cols):
        n, cs = self.p.shape[0], self.cs
        img = self.p[:, self.off:self.off + cs * cols]
        self.off += cs * cols
        return img.reshape(n, cs // 8, cols // 8, 8, 8).permute(
            0, 1, 3, 2, 4).reshape(n * cs, cols)

    def taps(self, n_taps, k):
        if k < mrf.KC:      # groups of KC / k taps, the last one padded
            tps = mrf.KC // k
            out = []
            for _ in range(-(-n_taps // tps)):
                out += list(self._stage(mrf.KC).split(k, dim=1))
            assert not any(t.any() for t in out[n_taps:])
            return out[:n_taps]
        return [torch.cat([self._stage(mrf.KC) for _ in range(k // mrf.KC)],
                          1) for _ in range(n_taps)]

    def done(self):
        return self.off == self.p.shape[1]


def test_stage_images_round_trip():
    """Every element of every tap lands once in the rank and chunk that
    owns it, in core-matrix order."""
    g = torch.Generator().manual_seed(0)
    for c, cs in ((64, 64), (128, 64), (256, 32), (16, 16), (32, 32)):
        weights = _weights(g, c, krs=(3, 4))
        packed = mrf.pack_weights(weights, (3, 4), cs)
        # taps per stage KC / c below KC: 3 and 4 taps take 2 stages each
        # at c = 32 and 1 at c = 16
        stages = sum(-(-kr * c // mrf.KC) for kr in (3, 4)) * 2 * 3
        assert packed.shape == (c // cs, stages * cs * mrf.KC)
        s = _Stream(packed, cs)
        for i, kr in enumerate((3, 4)):
            for u in range(3):
                for w in (weights[4 * i][u], weights[4 * i + 2][u]):
                    for j, tap in enumerate(s.taps(kr, c)):
                        assert torch.equal(tap, w[:, j * c:(j + 1) * c])
        assert s.done()
    # one image: element (n, k) at ((n // 8) * KC / 8 + k // 8) * 64
    # + (n % 8) * 8 + k % 8
    w = torch.arange(16 * 64, dtype=torch.float32).reshape(1, 16, 64)
    img = mrf.stage_images(w, 16)[0]
    for n, k in itertools.product(range(16), range(64)):
        at = ((n // 8) * 8 + k // 8) * 64 + (n % 8) * 8 + k % 8
        assert img[at] == w[0, n, k]


@pytest.mark.parametrize('krs,dils', [
    ((2, 3, 4, 5, 6, 7, 8, 9, 10), (1, 3)), (tuple(range(2, 12)), DILS),
    ((3,) * 12, (1,) * 9), ((3, 5), (1, 2) * 4 + (1,)),
    ((3,), (1,) * 32), ((3,) * 32, (1,))])
def test_long_lists_plan_and_pack(krs, dils):
    """9 to 32 kernel sizes or dilations within the halo: both entries
    plan in both dtypes (the tail's level behind a rate-2 upsample too),
    and the bf16 packings hold every tap of every unit once, in the
    kernel's order (after the upsampler's phases for the tail)."""
    g = torch.Generator().manual_seed(len(krs) * 100 + len(dils))
    c, cs = 32, 32
    for dtype in DTYPES:
        _check_plan(mrf.plan(dtype, c, krs, dils), dtype, c)
        _check_plan(ups_mrf.plan(dtype, 1, 2, 2 * c, c, 4, krs, dils), dtype,
                    c, 2 * c, 2, 2)
        assert mrf.shape_error(c, krs, dils) is None
        assert ups_mrf.shape_error(1, 2, 2 * c, c, 4, krs, dils) is None
    weights = _weights(g, c, krs, units=len(dils))
    up_w = torch.randn(4, c, 2 * c, generator=g)
    for packed, phases in ((mrf.pack_weights(weights, krs, cs), []),
                           (ups_mrf.pack_weights(up_w, 2, weights, krs, cs),
                            ups_mrf.up_taps(2, 4))):
        s = _Stream(packed, cs)
        for taps in phases:
            for j, tap in zip(taps, s.taps(len(taps), 2 * c)):
                assert torch.equal(tap, up_w[j])
        for i, kr in enumerate(krs):
            for u in range(len(dils)):
                for w in (weights[4 * i][u], weights[4 * i + 2][u]):
                    for j, tap in enumerate(s.taps(kr, c)):
                        assert torch.equal(tap, w[:, j * c:(j + 1) * c])
        assert s.done()


@pytest.mark.parametrize('dtype', DTYPES)
def test_prepare_pads_and_packs(dtype):
    """``prepare`` gives the plan's padded weights and, in bf16, their ring
    images, exactly as the wrappers made them per call before."""
    g = torch.Generator().manual_seed(5)
    c, c_in, s_in, s_up = 12, 24, 1, 2
    weights = tuple(w.to(dtype) for w in _weights(g, c))
    pl = mrf.plan(dtype, c, KRS, DILS)
    prep = mrf.prepare(weights, KRS, DILS)
    padded = mrf.pad_weights(weights, KRS, c, pl['c_pad'])
    assert (prep.c_pad, prep.cs) == (pl['c_pad'], pl['cs']) == (16, 16)
    assert all(torch.equal(a, b) for a, b in zip(prep.weights, padded))
    if dtype == torch.bfloat16:
        assert torch.equal(prep.packed, mrf.pack_weights(padded, KRS, 16))
    else:
        assert prep.packed is None
    up_w = torch.randn(4, c, c_in, generator=g).to(dtype)
    up_b = torch.randn(c, generator=g)
    mrf_w = tuple(w.float() if i % 2 else w for i, w in enumerate(weights))
    upl = ups_mrf.plan(dtype, s_in, s_up, c_in, c, 4, KRS, DILS)
    prep = ups_mrf.prepare(up_w, up_b, mrf_w, s_in, s_up, KRS, DILS)
    assert (prep.c_pad, prep.c_in_pad, prep.cs) == (16, 32, upl['cs'])
    assert torch.equal(prep.up_w, F.pad(up_w, (0, 8, 0, 4)))
    assert torch.equal(prep.up_b, F.pad(up_b, (0, 4)))
    if dtype == torch.bfloat16:
        assert torch.equal(prep.packed, ups_mrf.pack_weights(
            prep.up_w, s_up, prep.weights, KRS, upl['cs']))
    with pytest.raises(ValueError, match='prepared weights'):
        mrf.check_prepared('mrf', prep, mrf.plan(dtype, 64, KRS, DILS))


def _walk_branches(cur_in, src_of, stream, biases, krs, dils, valid, tw,
                   t_tile):
    """The MRF of the kernel's window: per branch the exact regions, the
    clamped shifted rows, each tap's block from the stream; returns the
    f32 branch sum over the tile's own rows."""
    halo = mrf.HALO
    summ = 0
    for i, kr in enumerate(krs):
        b1, b2 = biases[i]
        cur = cur_in.clone()
        ybuf = torch.zeros_like(cur)
        rest = sum((kr // 2) * (d + 1) for d in dils)
        for u, d in enumerate(dils):
            for first in (True, False):
                dil = d if first else 1
                rest -= (kr // 2) * dil
                lo, hi = max(0, halo - rest), min(tw, halo + t_tile + rest)
                src = _leaky(cur) if first else ybuf
                acc = 0
                for j, w in enumerate(stream.taps(kr, cur.shape[1])):
                    rows = (torch.arange(lo, hi) + (j - kr // 2) * dil).clamp(
                        0, tw - 1)
                    acc = acc + src[rows] @ w.T
                ok = valid[lo:hi, None]
                if first:
                    y = acc + b1[u]
                    ybuf[lo:hi] = torch.where(ok, _leaky(y), 0.0)
                else:
                    y = acc + b2[u]
                    cur[lo:hi] = torch.where(ok, cur[lo:hi] + y, 0.0)
        summ = summ + cur[halo:halo + t_tile]
    return summ / len(krs)


@pytest.mark.parametrize('c,t,krs,dils', [
    (64, 300, KRS, DILS), (128, 333, KRS, DILS), (256, 150, (3, 5), (1, 2)),
    (32, 200, (4, 6), (1, 2)), (16, 150, tuple(range(2, 12)), DILS),
    (32, 100, (3, 5), (1, 2) * 4 + (1,))])
def test_mrf_stage_walk_matches_twin(c, t, krs, dils):
    """The level walked tile by tile as the bf16 kernel runs it (window,
    exact regions, clamped rows, taps from the packed stages) equals the
    twin, at one CTA per tile and at clusters of 2 and 4, odd and even
    kernel sizes, 10 kernel sizes and 9 dilations."""
    g = torch.Generator().manual_seed(c + t)
    weights = _weights(g, c, krs, units=len(dils))
    x = torch.randn(c, t, generator=g)
    pl = mrf.plan(torch.bfloat16, c, krs, dils)
    assert pl['c_pad'] == c
    packed = mrf.pack_weights(weights, krs, pl['cs'])
    biases = [(weights[4 * i + 1][..., 0], weights[4 * i + 3][..., 0])
              for i in range(len(krs))]
    t_tile, tw = pl['t_tile'], pl['tw']
    out = torch.zeros(c, -(-t // t_tile) * t_tile)
    for tile0 in range(0, t, t_tile):
        pos = tile0 - mrf.HALO + torch.arange(tw)
        valid = (pos >= 0) & (pos < t)
        xw = torch.where(valid[:, None], x[:, pos.clamp(0, t - 1)].T, 0.0)
        s = _Stream(packed, pl['cs'])
        out[:, tile0:tile0 + t_tile] = _walk_branches(
            xw, None, s, biases, krs, dils, valid, tw, t_tile).T
        assert s.done()
    want = mrf.mrf_plain(x[None], weights, krs, dils)[0]
    _close(out[:, :t], want)


@pytest.mark.parametrize('s_in,s_up,k_up,c_in,c,t_ps,t_valid', [
    (1, 2, 4, 128, 64, 150, 150), (2, 2, 4, 64, 32, 97, 90),
    (1, 3, 9, 32, 16, 101, 101), (1, 4, 32, 32, 16, 50, 47),
    (1, 2, 24, 64, 32, 80, 80), (1, 2, 34, 32, 16, 60, 60),
    (2, 2, 66, 32, 16, 70, 66)])
def test_ups_stage_walk_matches_twin(s_in, s_up, k_up, c_in, c, t_ps,
                                     t_valid):
    """The tail's level walked tile by tile as the kernel runs it: the
    de-interleaved input tile from floor(pos0 / s_up) - in_halo, one
    product per output phase with its first tap, first input row and
    output rows, the upsampler's taps then the MRF's from the packed
    stages; rates 2, 3 and 4, k_up up to 66 (taps reaching 9 and 17 input
    rows, past IN_HALO), padding lanes."""
    g = torch.Generator().manual_seed(t_ps)
    x = torch.randn(s_in * c_in, t_ps, generator=g)
    up_w = torch.randn(k_up, c, c_in, generator=g) / (k_up * c_in) ** .5
    up_b = 0.1 * torch.randn(c, generator=g)
    weights = _weights(g, c)
    s_out = s_in * s_up
    pl = ups_mrf.plan(torch.bfloat16, s_in, s_up, c_in, c, k_up, KRS, DILS)
    packed = ups_mrf.pack_weights(up_w, s_up, weights, KRS, pl['cs'])
    biases = [(weights[4 * i + 1][..., 0], weights[4 * i + 3][..., 0])
              for i in range(3)]
    t_tile, tw, in_rows = pl['t_tile'], pl['tw'], pl['in_rows']
    n_out = s_out * t_ps
    out = torch.zeros(c, -(-n_out // t_tile) * t_tile)
    pad_up = k_up - 1 - (k_up - s_up) // 2
    for tile0 in range(0, n_out, t_tile):
        pos0 = tile0 - mrf.HALO
        pos = pos0 + torch.arange(tw)
        valid = (pos >= 0) & (pos < s_out * t_valid)
        in0 = pos0 // s_up - pl['in_halo']
        q = in0 + torch.arange(in_rows)
        lane = torch.div(q, s_in, rounding_mode='floor')
        r_in = q - lane * s_in
        ok_in = (q >= 0) & (lane < t_valid)
        rows = (r_in * c_in)[:, None] + torch.arange(c_in)[None]
        tin = torch.where(ok_in[:, None], _leaky(
            x[rows, lane.clamp(0, t_ps - 1)[:, None]]), 0.0)
        s = _Stream(packed, pl['cs'])
        u = torch.zeros(tw, c)
        for r in range(s_up):
            m_first = (pad_up - r) % s_up
            o_r = (r - pos0) % s_up
            n_rows = -(-(tw - o_r) // s_up)
            a0 = (pos0 + o_r - r) // s_up - in0
            off0 = (r + m_first - pad_up) // s_up
            assert (pos0 + o_r - r) % s_up == 0
            assert (r + m_first - pad_up) % s_up == 0
            acc = 0
            for j, w in enumerate(s.taps(len(range(m_first, k_up, s_up)),
                                        c_in)):
                arow = a0 + torch.arange(n_rows) + off0 + j
                assert int(arow.min()) >= 0 and int(arow.max()) < in_rows
                acc = acc + tin[arow] @ w.T
            orow = o_r + s_up * torch.arange(n_rows)
            u[orow] = torch.where(valid[orow, None], acc + up_b, 0.0)
        out[:, tile0:tile0 + t_tile] = _walk_branches(
            u, None, s, biases, KRS, DILS, valid, tw, t_tile).T
        assert s.done()
    got = ups_mrf.phase_stack(
        torch.where(torch.arange(out.shape[1]) < s_out * t_valid,
                    out, 0.0)[None, :, :n_out], s_out)[0]
    want = ups_mrf.ups_mrf_plain(x[None], up_w, up_b, weights, s_in, s_up,
                                 KRS, DILS, t_valid)[0]
    _close(got, want)
