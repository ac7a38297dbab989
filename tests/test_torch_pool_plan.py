"""pool.cu's bf16 ``pool_proj1`` schedule and launch plan, without a card.

The model below walks ``pool_proj1_mma_kernel`` in plain torch: frames
tiled over the virtual axis of all items with one zero gap frame after each
(``cbhg.pool_proj1_plan``), per CTA tile the raw x rows its producer loads
(the real frames of virtual frames v0-2 .. v0+128, from the first one at
or after v0-2), the 130 pooled rows its pool warps make from them (zero at
gaps and outside), the three taps as the same rows shifted by one, and K in
chunks of 32 channels with each chunk's weight taps read from the stage
images ``cbhg.pack_proj_stages`` packs. It is held to the twin
(``cbhg.pool_proj1_plain``) and to ``pool_proj1_pallas`` in interpret mode.

Tolerances: float32, 1e-5 of the scale max(1, max |want|) (the same
products summed by chunk and tap instead of by tap); bfloat16, the card
tests' 3e-2 of the scale (one bf16 rounding of a float32 sum taken in
another order).

The plans, at 232,448 B of shared memory: at every width the published
config and the card tests use, the carve fits and is the kernel's sum,
every frame falls in one tile, the column blocks cover P, and no shape the
previous kernel took (every B, T and P, KC a multiple of 32) is refused.
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.ops.hopper import cbhg

SMEM = 232_448


def _stage_taps(stage, n):
    """A weight stage image [3][n/8][4][8][8] -> the taps [3, 32, n] (channel,
    column) the kernel's B descriptors read."""
    return stage.reshape(3, n // 8, 4, 8, 8).permute(0, 2, 4, 1, 3).reshape(
        3, 32, n)


def _model(x, mask, w):
    """pool_proj1_mma_kernel's order of operations: returns [B, T, P] in
    x's dtype."""
    batch, t_len, kc = x.shape
    p = w.shape[2]
    plan = cbhg.pool_proj1_plan(batch, t_len, kc, p)
    n, n_blocks, tile = plan['n_cols'], plan['n_blocks'], plan['tile']
    wpk = cbhg.pack_proj_stages(w, n, n_blocks).float()
    t1 = t_len + 1
    nv = batch * t1
    flat = x.reshape(batch * t_len, kc)
    mflat = mask.reshape(-1)
    out = torch.full((batch * t_len, p), float('nan'))
    tiles = plan['tiles']
    for blk in range(plan['grid']):
        nb, v0 = blk // tiles, (blk % tiles) * tile
        fr0 = 0
        if v0 >= 2:
            b, t = divmod(v0 - 2, t1)
            fr0 = b * t_len + min(t, t_len)
        raw = torch.zeros(tile + 3, kc, dtype=x.dtype)   # the producer's box
        rows = flat[fr0:fr0 + tile + 3]
        raw[:len(rows)] = rows
        pooled = torch.zeros(tile + 2, kc, dtype=x.dtype)
        for j in range(tile + 2):
            v = v0 - 1 + j
            if v < 0 or v >= nv:
                continue
            b, t = divmod(v, t1)
            if t == t_len:
                continue                                 # the gap frame
            f = b * t_len + t
            r = f - fr0
            assert 0 <= r < tile + 3 and (t == 0 or r >= 1)
            cur = raw[r]
            if t > 0:
                cur = torch.maximum(raw[r - 1], cur)
            pooled[j] = (cur.float() * mflat[f]).to(x.dtype)
        acc = torch.zeros(tile, n)
        for c in range(plan['chunks']):
            taps = _stage_taps(wpk[nb, c], n)
            a = pooled[:, c * 32:(c + 1) * 32].float()
            for d in range(3):
                acc += a[d:d + tile] @ taps[d]
        for m in range(tile):
            v = v0 + m
            if v >= nv or v % t1 == t_len:
                continue
            b, t = divmod(v, t1)
            cols = slice(nb * n, min(p, nb * n + n))
            out[b * t_len + t, cols] = acc[m, :cols.stop - cols.start]
    assert not torch.isnan(out).any()            # every (frame, column) once
    return out.to(x.dtype).reshape(batch, t_len, p)


def _inputs(batch, t_len, kc, p, dtype, valid=None, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, t_len, kc).astype(np.float32)
    lens = valid if valid is not None else [t_len] * batch
    mask = (np.arange(t_len)[None] < np.asarray(lens)[:, None]).astype(
        np.float32)
    w = (rs.randn(3, kc, p) / np.sqrt(3 * kc)).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(mask),
            torch.from_numpy(w).to(dtype))


def _close(got, want, tol):
    want = torch.as_tensor(np.array(want, np.float32)).float() \
        if not torch.is_tensor(want) else want.float()
    scale = max(1.0, float(want.abs().max()))
    assert got.shape == want.shape
    assert float((got.float() - want).abs().max()) <= tol * scale


# (B, T, KC, P, valid lengths): one frame per item (64 items per tile),
# items that straddle tiles with tail masks, a tile boundary inside an
# item, a P over two column blocks and one that is not a wgmma width
MODEL_SHAPES = [(5, 1, 64, 24, None), (3, 37, 64, 80, [37, 20, 1]),
                (2, 130, 32, 16, [130, 127]), (2, 9, 32, 300, None),
                (1, 129, 96, 8, None)]


@pytest.mark.parametrize('batch,t_len,kc,p,valid', MODEL_SHAPES)
def test_model_matches_twin(batch, t_len, kc, p, valid):
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        x, mask, w = _inputs(batch, t_len, kc, p, dtype, valid)
        _close(_model(x, mask, w), cbhg.pool_proj1_plain(x, mask, w), tol)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_model_matches_pallas(dtype):
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.cbhg import pool_proj1_pallas

    dt, jdt, tol = {'f32': (torch.float32, jnp.float32, 1e-5),
                    'bf16': (torch.bfloat16, jnp.bfloat16, 3e-2)}[dtype]
    x, mask, w = _inputs(3, 37, 128, 24, dt, [37, 12, 30], seed=1)
    ref = pool_proj1_pallas(jnp.asarray(x.float().numpy(), jdt),
                            jnp.asarray(mask.numpy()),
                            jnp.asarray(w.float().numpy(), jdt),
                            interpret=True)
    _close(_model(x, mask, w), np.asarray(ref.astype(jnp.float32)), tol)


def test_stages_hold_the_weight_taps():
    """pack_proj_stages: stage (block, chunk) holds w[d, 32 chunk + k,
    n block + col] at tap d, channel k, column col; zero past P."""
    kc, p, n, n_blocks = 64, 200, 128, 2
    w = torch.arange(3 * kc * p, dtype=torch.float32).view(3, kc, p) + 1
    wpk = cbhg.pack_proj_stages(w, n, n_blocks)
    assert wpk.shape == (n_blocks, kc // 32, 3, n // 8, 4, 8, 8)
    for nb in range(n_blocks):
        for c in range(kc // 32):
            taps = _stage_taps(wpk[nb, c], n)
            cols = min(p, (nb + 1) * n) - nb * n
            assert torch.equal(taps[:, :, :cols],
                               w[:, c * 32:(c + 1) * 32, nb * n:nb * n + cols])
            assert not taps[:, :, cols:].any()


# the published config at serving (postnet T 256, KC 2048; prenet T 81,
# KC 4096; P 256), its requests, and widths of the card tests
@pytest.mark.parametrize('kc', [32, 2048, 4096])
@pytest.mark.parametrize('p', [8, 80, 256, 300, 384])
@pytest.mark.parametrize('t_len', [1, 81, 256, 512])
def test_plan_fits_and_covers(kc, p, t_len):
    for batch in (1, 3, 4096):
        plan = cbhg.pool_proj1_plan(batch, t_len, kc, p, SMEM)
        n, n_blocks = plan['n_cols'], plan['n_blocks']
        assert n in cbhg.POOL_MMA_COLS and n * n_blocks >= p
        assert n * (n_blocks - 1) < p and n_blocks == -(-p // 256)
        # the carve is pool.cu's mma_smem and fits; the rings' depths
        stage = 4 * 130 * 16 + 3 * n * 32 * 2
        assert plan['smem'] == (256 + 1152 + plan['x_stages'] * 8448
                                + plan['stages'] * stage) <= SMEM
        assert cbhg.POOL_MIN_STAGES <= plan['stages'] <= cbhg.POOL_MAX_STAGES
        # every real frame in exactly one tile, each tile's x rows in its box
        assert plan['virtual_frames'] == batch * (t_len + 1)
        assert plan['tiles'] * 128 >= plan['virtual_frames'] \
            > (plan['tiles'] - 1) * 128
        assert plan['grid'] == plan['tiles'] * n_blocks
        assert (3 * n * 32 * 2) % 16 == 0   # one bulk copy per stage
        assert plan['chunks'] * 32 == kc


def test_plan_takes_every_old_shape():
    """The previous kernel took every B, T and P with KC a multiple of 32;
    so does the plan, and it refuses what shape_error refuses."""
    for kc in range(32, 4097, 32):
        for p in (1, 7, 64, 255, 256, 257, 512, 1000):
            cbhg.pool_proj1_plan(2, 3, kc, p, SMEM)
    for kc in (0, 16, 48):
        with pytest.raises(ValueError, match='multiple of 32'):
            cbhg.pool_proj1_plan(2, 3, kc, 64, SMEM)
    with pytest.raises(ValueError, match='shared memory'):
        cbhg.pool_proj1_plan(2, 3, 64, 256, 100_000)
