"""The card-free parts of row 8's kernel (``lr.cu``): its launch plan
(``lr.plan``) over batches, token counts, budgets, widths and both dtypes,
with the refusals and their reasons, and a plain-Python walk of the
kernel's work, CTA by CTA, as ``lr_tile_kernel`` does it: the tile's
frames, the 32-way ballot search for its first token, the walk over the
ends from there in ballots of 32 lanes with the count of ends per frame
and its prefix sum over the lanes' frames, the copy in 16-byte words and
the zero frames. The walk is held exactly (bit for bit) against the plain
twin and against the JAX package's ``length_regulator_pallas`` in
interpret mode, on edge cases: zero, negative and half durations, an empty
item, an item far over the budget, tile boundaries inside a token's span,
tokens spanning several tiles, runs of more than 32 empty tokens and more
tokens than two probes narrow. The twin's gradient is held exactly to the
Pallas kernel's custom VJP on the same cases.
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.ops import length_regulator as port_lr
from forwardtacotron_torch.ops.hopper import lr

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
LANES = 32


def _tiles(pl, t):
    """Tiles per item, as lr.cu derives them from T and the plan's tile."""
    return -(-t // pl.tile)


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('b', [1, 4, 32, 130, 4096])
@pytest.mark.parametrize('n,t', [(1, 1), (9, 5), (92, 896), (160, 928),
                                 (160, 1024), (81, 256), (3, 3000)])
@pytest.mark.parametrize('c', [8, 4, 24, 512])
def test_plan_covers_every_frame_once(dtype, b, n, t, c):
    """Each plan's grid covers every frame of every item exactly once: one
    CTA per (item, tile), tiles of a power of two up to MAX_TILE frames
    whose rows hold at most TILE_BYTES (unless one row is more), halved to
    at least CTAS_PER_SM CTAs per SM while above MIN_TILE frames. The
    widths that are not whole 16-byte words raise with the reason."""
    dt = DTYPES[dtype]
    row_bytes = c * (2 if dt == torch.bfloat16 else 4)
    if row_bytes % 16:
        with pytest.raises(ValueError, match='16-byte words'):
            lr.plan(b, n, t, c, dt)
        return
    pl = lr.plan(b, n, t, c, dt)
    tile = pl.tile
    assert tile & (tile - 1) == 0 and 1 <= tile <= lr.MAX_TILE
    assert tile * row_bytes <= lr.TILE_BYTES or tile == 1
    assert pl.row_vecs * 16 == row_bytes
    tiles = _tiles(pl, t)
    grid = b * tiles
    if tile > lr.MIN_TILE:   # not halved further: the grid is full
        assert grid >= lr.CTAS_PER_SM * lr.N_SM
    if 2 * tile <= lr.MAX_TILE and 2 * tile * row_bytes <= lr.TILE_BYTES:
        # a larger tile was halved for the grid's sake
        assert b * -(-t // (2 * tile)) < lr.CTAS_PER_SM * lr.N_SM
    # blockIdx -> (item, t0) as the kernel takes it: every item has
    # ``tiles`` CTAs, and an item's CTAs (t0 depends on blockIdx - item *
    # tiles alone, so all items' alike) cover [t0, min(t0 + tile, T)) each,
    # every frame once
    item = torch.arange(grid) // tiles
    assert torch.equal(torch.bincount(item, minlength=b),
                       torch.full((b,), tiles))
    covered = torch.zeros(t, dtype=torch.int32)
    for block in range(tiles):
        t0 = block * tile
        covered[t0:min(t0 + tile, t)] += 1
    assert bool((covered == 1).all())


def test_plan_shapes_of_the_port():
    """The train step's shapes fill the card several times over; a batch-1
    request still gives each SM a CTA or more (896 frames in 8-frame
    tiles)."""
    bf, f32 = torch.bfloat16, torch.float32
    for (b, n, t, dt), (tile, tiles, grid) in {
            (32, 160, 1024, bf): (32, 32, 1024),
            (32, 160, 1024, f32): (16, 64, 2048),
            (32, 160, 928, bf): (32, 29, 928),
            (1, 92, 896, f32): (8, 112, 112),
            (4096, 81, 256, bf): (32, 8, 32768)}.items():
        pl = lr.plan(b, n, t, 512, dt)
        assert pl == (tile, 512 * dt.itemsize // 16)
        assert (_tiles(pl, t), b * _tiles(pl, t)) == (tiles, grid)


def test_plan_refuses_with_reasons():
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        lr.plan(2, 3, 4, 8, torch.float16)
    with pytest.raises(ValueError, match='at least one item, token'):
        lr.plan(2, 0, 4, 8, torch.float32)
    with pytest.raises(ValueError, match='at least one'):
        lr.plan(2, 3, 0, 8, torch.float32)
    with pytest.raises(ValueError, match='C a multiple of 4 in float32'):
        lr.plan(2, 3, 4, 6, torch.float32)
    with pytest.raises(ValueError, match='of 8 in bfloat16'):
        lr.plan(2, 3, 4, 12, torch.bfloat16)
    with pytest.raises(ValueError, match='grid holds at most'):
        lr.plan(2 ** 31, 1, 1, 4, torch.float32)


# ------------------------------------------------------------------- walk

def _search(e, t0, stats):
    """Warp 0's ballot search: n0 = #{n : e[n] <= t0}, 32 probes a step."""
    n = len(e)
    lo, hi = 0, n
    while lo < hi:
        stats['probes'] += 1
        step, base = -(-(hi - lo) // LANES), lo
        ballot = [base + lane * step < hi and e[base + lane * step] <= t0
                  for lane in range(LANES)]
        k = sum(ballot)
        assert ballot == [True] * k + [False] * (LANES - k)   # a prefix
        hi = min(hi, base + k * step) if k else base
        lo = min(hi, base + (k - 1) * step + 1) if k else base
    return lo


def _tokens(e, t0, t_hi, tile, stats):
    """The tile's token table as warp 0 builds it: n0, the count of ends
    per frame in ballots of 32 ends, then the prefix sum with each lane
    owning ``per`` consecutive frames."""
    n = len(e)
    n0 = _search(e, t0, stats)
    cnt = [0] * tile
    for base in range(n0, n, LANES):
        stats['ballots'] += 1
        ens = [e[k] if k < n else 2 ** 31 - 1
               for k in range(base, base + LANES)]
        for en in ens:
            if t0 < en < t_hi:
                cnt[en - t0] += 1
        if ens[-1] >= t_hi:
            break
    per = -(-tile // LANES)
    own = [sum(cnt[f] for f in range(lane * per, min(tile, lane * per + per)))
           for lane in range(LANES)]
    incl = list(np.cumsum(own))
    tok = [0] * tile
    for lane in range(LANES):
        acc = n0 + incl[lane] - own[lane]
        for f in range(lane * per, min(tile, lane * per + per)):
            acc += cnt[f]
            tok[f] = min(acc, n - 1)
    return tok


def walk(x, ends, max_len, tile=None):
    """[B, N, C] x int ends [B, N] -> [B, max_len, C], CTA by CTA as
    lr_tile_kernel computes it, with ``tile`` frames a CTA (default: the
    plan's). Returns the output and the search statistics."""
    b, n, c = x.shape
    pl = lr.plan(b, n, max_len, c, x.dtype)
    if tile is not None:
        pl = pl._replace(tile=tile)
    tiles = _tiles(pl, max_len)
    w = pl.row_vecs
    words = x.contiguous().view(torch.uint8).reshape(b, n, w, 16)
    out = torch.full((b, max_len, w, 16), 0xAB, dtype=torch.uint8)
    written = torch.zeros(b, max_len, dtype=torch.int32)
    stats = {'probes': 0, 'ballots': 0, 'searches': 0, 'max_probes': 0}
    e_all = ends.tolist()
    for block in range(b * tiles):
        bi = block // tiles
        t0 = (block - bi * tiles) * pl.tile
        e = e_all[bi]
        t_end = min(t0 + pl.tile, max_len)
        t_hi = max(t0, min(t_end, e[n - 1]))
        dst = out[bi].reshape(-1, 16)[t0 * w:]
        if t_hi > t0:
            stats['searches'] += 1
            before = stats['probes']
            tok = _tokens(e, t0, t_hi, pl.tile, stats)
            stats['max_probes'] = max(stats['max_probes'],
                                      stats['probes'] - before)
            i = torch.arange((t_hi - t0) * w)
            f = i // w
            src = torch.tensor(tok)[f]
            dst[i] = words[bi, src, i - f * w]
        dst[(t_hi - t0) * w:(t_end - t0) * w] = 0
        written[bi, t0:t_end] += 1
    assert bool((written == 1).all())
    return out.reshape(b, max_len, c * x.element_size()).view(
        x.dtype).reshape(b, max_len, c), stats


def _case(name, seed=0):
    """(float durations [B, N], C, max_len) of an edge case."""
    rs = np.random.RandomState(seed)
    if name == 'mixed':           # zero, negative and half durations, an
        dur = rs.uniform(-1.0, 5.0, (4, 9))   # empty item, one far over
        dur[0, ::3] = 0.0
        dur[0, 1] = 0.5
        dur[0, 2] = 1.5
        dur[1] = 30.0
        dur[2] = -2.0
        return dur, 8, 100
    if name == 'long_tokens':     # tokens spanning several tiles, tile
        dur = np.array([[3, 70, 0, 0, 5, 130, 1],   # boundaries inside
                        [40, 1, 1, 1, 200, 0, 9]], np.float32)  # spans
        return dur, 24, 300
    if name == 'empty_runs':      # runs of more than 32 empty tokens
        dur = np.zeros((2, 100), np.float32)
        dur[0, [0, 40, 41, 99]] = (3.0, 2.0, 7.0, 4.0)
        dur[1, 70:] = 2.0
        return dur, 8, 80
    if name == 'many_tokens':     # 2,000 tokens: the search takes 3 probes
        dur = (rs.rand(2, 2000) < 0.3).astype(np.float32)
        dur[1, 1500:] = 0.0
        return dur, 8, 700
    if name == 'one_token':
        return np.array([[5.0], [0.0], [0.49]], np.float32), 8, 7
    raise ValueError(name)


CASES = ['mixed', 'long_tokens', 'empty_runs', 'many_tokens', 'one_token']


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('tile', [None, 1, 8, 32, 256])
def test_walk_matches_twin(dtype, case, tile):
    """The kernel's walk at the plan's tile and at tiles of 1 to 256
    frames gives the twin's output bit for bit, searching once per tile
    that holds a token's frame, in at most ceil(log32 N) + 1 probes."""
    dur, c, max_len = _case(case)
    dt = DTYPES[dtype]
    c = c if dt == torch.bfloat16 else c // 2
    _, ends = port_lr.duration_spans(torch.from_numpy(dur))
    ends = ends.to(torch.int32)
    rs = np.random.RandomState(len(case))
    x = torch.from_numpy(rs.randn(dur.shape[0], dur.shape[1], c).astype(
        np.float32)).to(dt)
    got, stats = walk(x, ends, max_len, tile)
    want = lr.length_regulator_plain(x, ends, max_len)
    assert torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dt == torch.bfloat16
                                 else torch.int32))
    n = dur.shape[1]
    assert stats['max_probes'] <= int(np.ceil(np.log(n) / np.log(32))) + 1
    pl = lr.plan(dur.shape[0], n, max_len, c, dt)
    t_tile = tile or pl.tile
    tiles_with_tokens = sum(
        len(range(0, min(max_len, int(e[-1])), t_tile)) for e in ends)
    assert stats['searches'] == tiles_with_tokens


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', CASES)
def test_walk_and_twin_match_pallas(dtype, case):
    """The walk (at 8-frame tiles and at the plan's) and the twin against
    ``length_regulator_pallas`` in interpret mode, exactly; the twin's
    gradient (``ops.length_regulator``, the autograd route the model
    takes) against the kernel's custom VJP, exactly, with incoming
    gradients of multiples of 1/4 (sums exact in any order)."""
    import jax
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.length_regulator import \
        length_regulator_pallas

    dur, c, max_len = _case(case, seed=1)
    dt = DTYPES[dtype]
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    rs = np.random.RandomState(7)
    x = rs.randn(dur.shape[0], dur.shape[1], c).astype(np.float32)
    g = (rs.randint(-2, 3, (dur.shape[0], max_len, c)) / 4).astype(
        np.float32)
    ref, vjp = jax.vjp(
        lambda xx: length_regulator_pallas(xx, jnp.asarray(dur), max_len,
                                           interpret=True),
        jnp.asarray(x).astype(jdt))
    (ref_dx,) = vjp(jnp.asarray(g).astype(jdt))
    ref = np.asarray(ref, np.float32)

    xt = torch.from_numpy(x).to(dt)
    _, ends = port_lr.duration_spans(torch.from_numpy(dur))
    for tile in (8, None):
        got, _ = walk(xt, ends.to(torch.int32), max_len, tile)
        np.testing.assert_array_equal(got.float().numpy(), ref)
    xg = xt.clone().requires_grad_()
    out = port_lr.length_regulator(xg, torch.from_numpy(dur), max_len)
    out.backward(torch.from_numpy(g).to(dt))
    np.testing.assert_array_equal(out.detach().float().numpy(), ref)
    np.testing.assert_array_equal(xg.grad.float().numpy(),
                                  np.asarray(ref_dx, np.float32))
