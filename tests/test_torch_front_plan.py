"""The card-free parts of the two bf16 tensor-core kernels, on the CPU:
the launch plans of ``cbhg_front.cu`` (``cbhg.plan``) and ``highway.cu``
(``highway.plan``), their weight packings, held exactly against the
unpacked weights and walked stage by stage in the order and with the
offsets the kernels use, and the front's twin at a projection wider than
256 columns against the JAX ``bank_pool_proj_pallas`` in interpret mode.

The stage walks are plain torch in float32 on float32 inputs: each
product of a ring stage is a matmul of the rows the kernel's ldmatrix
reads, so they agree with the twins up to the order of float32 sums
(1e-5 of the output's scale).
"""

import numpy as np
import pytest
import torch

from forwardtacotron_torch.ops.hopper import cbhg, highway

SMEM = 232448
TOL = 1e-5


def _close(got, want, tol=TOL):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


# ------------------------------------------------------------- the front

SERVING_FRONTS = [(8, 80, 256, 256), (16, 256, 256, 256)]


@pytest.mark.parametrize('k_max,c_in,c,p', SERVING_FRONTS + [
    (8, 80, 256, 320), (8, 80, 256, 512), (4, 80, 128, 320),
    (17, 512, 128, 256), (3, 2048, 64, 64), (1, 6, 10, 12)])
def test_front_plan_fits(k_max, c_in, c, p):
    """Shared memory within the H100's 232,448 bytes, a ring of at least 2
    stages and a 128-frame tile in bf16; the input channels covered by the
    chunks; C and P padded to the kernel's chunks and tiles."""
    bf = cbhg.plan(torch.bfloat16, k_max, c_in, c, p)
    assert bf['smem'] <= SMEM and 2 <= bf['stages'] <= cbhg.MAX_STAGES
    assert bf['tile'] == cbhg.TM >= 128
    assert bf['ki'] % 16 == 0 and bf['ki'] * bf['n_ci'] >= c_in
    assert bf['ki'] * (bf['n_ci'] - 1) < c_in
    assert bf['c_pad'] % cbhg.CB == 0 and bf['c_pad'] - c < cbhg.CB
    assert bf['p_pad'] % cbhg.PT == 0 and bf['p_pad'] - p < cbhg.PT
    halo = 2 * (cbhg.BANK_ROWS + k_max - 1) * (bf['ki'] + 8)
    assert bf['smem'] == (64 + 4 * (131 * 72 + 132 + 128) + 2 * 130 * 72
                          + halo + bf['stages'] * cbhg.STAGE_BYTES)
    f32 = cbhg.plan(torch.float32, k_max, c_in, c, p)
    assert f32['smem'] <= SMEM and f32['ki'] % 4 == 0
    assert f32['ki'] * f32['n_ci'] >= f32['c_in_pad'] >= c_in
    assert cbhg.shape_error(k_max, c_in, c, p) is None


def test_front_plan_at_serving_shapes():
    """The postnet front keeps its whole input halo resident and a ring of
    4 stages; the K=16 prenet front its halo and 2."""
    post = cbhg.plan(torch.bfloat16, *SERVING_FRONTS[0])
    pre = cbhg.plan(torch.bfloat16, *SERVING_FRONTS[1])
    assert (post['n_ci'], post['stages'], post['ki']) == (1, 4, 80)
    assert (pre['n_ci'], pre['stages'], pre['ki']) == (1, 2, 256)


def test_front_plan_refuses():
    """A bank wider than the JAX gate's halo, empty shapes, another dtype
    and a shared memory that holds no halo raise with the reason;
    ``shape_error`` reports the first."""
    with pytest.raises(ValueError, match='K=18'):
        cbhg.plan(torch.bfloat16, 18, 80, 256, 256)
    assert 'K=18' in cbhg.shape_error(18, 80, 256, 256)
    with pytest.raises(ValueError, match='positive'):
        cbhg.plan(torch.float32, 8, 0, 256, 256)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        cbhg.plan(torch.float16, 8, 80, 256, 256)
    with pytest.raises(ValueError, match='2 ring stages'):
        cbhg.plan(torch.bfloat16, 8, 80, 256, 256, smem_limit=100000)
    with pytest.raises(ValueError, match='halo'):
        cbhg.plan(torch.float32, 8, 80, 256, 256, smem_limit=35000)


def _front_inputs(g, b, t, k_max, c_in, c, p, dtype=torch.float32):
    mask = torch.ones(b, t)
    mask[-1, t // 2:] = 0.0
    x = torch.randn(b, t, c_in, generator=g) * mask[:, :, None]
    bank = [torch.randn(k, c_in, c, generator=g) * (k * c_in) ** -0.5
            for k in range(1, k_max + 1)]
    proj = torch.randn(3, k_max * c, p, generator=g) * (3 * k_max * c) ** -.5
    return (x.to(dtype), mask, [w.to(dtype) for w in bank],
            torch.rand(k_max, c, generator=g) + 0.5,
            0.1 * torch.randn(k_max, c, generator=g), proj.to(dtype),
            torch.rand(p, generator=g) + 0.5,
            0.1 * torch.randn(p, generator=g))


def test_front_packing_is_exact():
    """Every element of both packed streams is the weight it stands for,
    or zero where C_in, C or P are padded."""
    g = torch.Generator().manual_seed(0)
    k_max, c_in, c, p = 3, 40, 80, 300
    _, _, bank_w, _, _, proj_w, _, _ = _front_inputs(g, 1, 4, k_max, c_in,
                                                     c, p)
    fp = cbhg.plan(torch.bfloat16, k_max, c_in, c, p, smem_limit=160000)
    ki, n_ci, cp, pp = fp['ki'], fp['n_ci'], fp['c_pad'], fp['p_pad']
    assert n_ci == 1 and (ki, cp, pp) == (48, 128, 512)
    bank, proj = cbhg.pack_weights(bank_w, proj_w, fp)
    cb, ld = cbhg.CB, cbhg.LD
    n_cc, n_pt = cp // cb, pp // cbhg.PT
    assert bank.shape == (n_cc, n_ci, 6 * ki, ld)
    assert not bank[..., cb:].any()
    for k, w in enumerate(bank_w, 1):
        rows = slice(k * (k - 1) // 2 * ki, k * (k + 1) // 2 * ki)
        want = torch.zeros(k, n_ci * ki, cp)
        want[:, :c_in, :c] = w
        for cc in range(n_cc):
            for q in range(n_ci):
                blk = want[:, q * ki:(q + 1) * ki, cc * cb:(cc + 1) * cb]
                assert torch.equal(bank[cc, q, rows, :cb],
                                   blk.reshape(k * ki, cb))
    want = torch.zeros(3, k_max, cp, pp)
    want[:, :, :c, :p] = proj_w.view(3, k_max, c, p)
    assert proj.shape == (n_pt, k_max, n_cc, 3, cbhg.PT, ld)
    assert not proj[..., cb:].any()
    for pt in range(n_pt):
        for k in range(k_max):
            for cc in range(n_cc):
                for d in range(3):
                    blk = want[d, k, cc * cb:(cc + 1) * cb,
                               pt * cbhg.PT:(pt + 1) * cbhg.PT]
                    assert torch.equal(proj[pt, k, cc, d, :, :cb], blk.T)


def _walk_front(x, mask, bank_w, bn_scale, bn_bias, proj_w, ps, pb, fp):
    """The bf16 kernel's schedule on float32 values: per (item, frame tile,
    P tile) the input halo, per branch and bank column chunk the bank's
    ring stages (16 rows of (tap, channel) at a time, rows shifted by
    j + K/2 - k/2), ReLU/BN, the pool and mask, the pooled rows rounded to
    x's dtype, and the three proj stages into the accumulator; every stage
    read from the packed streams at the kernel's flat offsets."""
    tm, rows, cb, pt_w, ks, ld = (cbhg.TM, cbhg.BANK_ROWS, cbhg.CB, cbhg.PT,
                                  cbhg.KS, cbhg.LD)
    b, t, c_in = x.shape
    k_max, c, p = len(bank_w), bank_w[0].shape[-1], proj_w.shape[-1]
    ki, n_ci, cp, pp = fp['ki'], fp['n_ci'], fp['c_pad'], fp['p_pad']
    n_cc, n_pt, left = cp // cb, pp // pt_w, k_max // 2
    bank, proj = (s.float().reshape(-1)
                  for s in cbhg.pack_weights(bank_w, proj_w, fp))
    scale = torch.nn.functional.pad(bn_scale, (0, cp - c))
    bias = torch.nn.functional.pad(bn_bias, (0, cp - c))
    xf = torch.nn.functional.pad(x.float(), (0, n_ci * ki - c_in))
    out = torch.zeros(b, t, p)
    for item in range(b):
        for t0 in range(0, t, tm):
            frames = torch.arange(rows + k_max - 1) + t0 - 2 - left
            ok = (frames >= 0) & (frames < t)
            halo = torch.zeros(len(frames), n_ci * ki)
            halo[ok] = xf[item, frames[ok]]
            for ptile in range(n_pt):
                acc = torch.zeros(tm, pt_w)
                for k in range(1, k_max + 1):
                    off, krows = left - k // 2, k * ki
                    for cc in range(n_cc):
                        y = torch.zeros(rows, cb)
                        for q in range(n_ci):
                            for kr0 in range(0, krows, ks):
                                width = min(ks, krows - kr0)
                                taps = k_max * (k_max + 1) // 2
                                base = ((((cc * n_ci + q) * taps
                                          + k * (k - 1) // 2) * ki + kr0)
                                        * ld)
                                st = bank[base:base + width * ld].view(
                                    width, ld)
                                for kk in range(0, width, 16):
                                    j, ci = divmod(kr0 + kk, ki)
                                    y += halo[j + off:j + off + rows,
                                              q * ki + ci:q * ki + ci + 16] \
                                        @ st[kk:kk + 16, :cb]
                        cols = slice(cc * cb, (cc + 1) * cb)
                        y = (torch.relu(y[:tm + 3]) * scale[k - 1, cols]
                             + bias[k - 1, cols])
                        u = torch.arange(tm + 2) + t0 - 1
                        pooled = torch.maximum(y[:-1], y[1:])
                        pooled[u == 0] = y[1:][u == 0]
                        live = (u >= 0) & (u < t)
                        m = torch.zeros(tm + 2)
                        m[live] = mask[item, u[live]]
                        pooled = (pooled * m[:, None]).to(x.dtype).float()
                        for d in range(3):
                            base = ((((ptile * k_max + k - 1) * n_cc + cc) * 3
                                     + d) * ks * ld)
                            st = proj[base:base + pt_w * ld].view(pt_w, ld)
                            acc += pooled[d:d + tm] @ st[:, :cb].T
                cols = torch.arange(ptile * pt_w, (ptile + 1) * pt_w)
                live = cols < p
                n = min(tm, t - t0)
                out[item, t0:t0 + n, cols[live]] = (
                    torch.relu(acc[:n, live]) * ps[cols[live]]
                    + pb[cols[live]])
    return out.to(x.dtype)


@pytest.mark.parametrize('b,t,k_max,c_in,c,p,limit', [
    (2, 150, 3, 40, 80, 300, SMEM),       # two frame tiles, two P tiles
    (1, 9, 4, 24, 64, 40, SMEM),          # one short tile, one chunk
    (1, 130, 2, 200, 16, 8, 170000)])     # input channels in 2 chunks
def test_front_stage_walk_matches_twin(b, t, k_max, c_in, c, p, limit):
    g = torch.Generator().manual_seed(t)
    args = _front_inputs(g, b, t, k_max, c_in, c, p)
    fp = cbhg.plan(torch.bfloat16, k_max, c_in, c, p, smem_limit=limit)
    assert fp['n_ci'] == (2 if limit < SMEM else 1)
    _close(_walk_front(*args, fp), cbhg.bank_pool_proj_plain(*args))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_front_twin_at_p320_matches_pallas(dtype):
    """P = 320, which the JAX gate admits and the kernel now takes: the
    twin that the card tests hold the kernel to agrees with the Pallas
    kernel (float32 1e-5; bf16 within one bf16 step of the output's
    scale, the two rounding their sums in other orders)."""
    import jax.numpy as jnp

    from forwardtacotron_tpu.ops.pallas.cbhg import bank_pool_proj_pallas

    g = torch.Generator().manual_seed(320)
    k_max, c_in, c, p = 4, 16, 32, 320
    args = _front_inputs(g, 2, 37, k_max, c_in, c, p, dtype)
    x, mask, bank_w, bs, bb, proj_w, ps, pb = args

    def jx(t):
        return jnp.asarray(t.float().numpy(),
                           jnp.bfloat16 if t.dtype == torch.bfloat16
                           else jnp.float32)
    ref = bank_pool_proj_pallas(
        jx(x), jx(mask), tuple(jx(w) for w in bank_w), jx(bs), jx(bb),
        jx(proj_w), jx(ps), jx(pb), ks=tuple(range(1, k_max + 1)),
        interpret=True)
    got = cbhg.bank_pool_proj(*args)
    assert got.shape == (2, 37, p) and got.dtype == dtype
    want = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
    _close(got.float(), want, TOL if dtype == torch.float32 else 2 ** -7)


# ------------------------------------------------------- the highway stack

@pytest.mark.parametrize('c_in,c', [(80, 256), (256, 256), (0, 256),
                                    (6, 128), (80, 1024), (256, 2048),
                                    (0, 29056), (29052, 128)])
def test_highway_plan_fits(c_in, c):
    """Shared memory within 232,448 bytes and a ring of at least 2 stages
    at every width the float32 entry takes (C_in 0: ``highway_stack``),
    128-row tiles at the CBHGs' serving shapes."""
    hp = highway.plan(c_in, c)
    assert hp['smem'] <= SMEM
    assert highway.MIN_STAGES <= hp['stages'] <= highway.MAX_STAGES
    width = max(hp['c_in_pad'], hp['c_pad'])
    assert hp['c_in_pad'] % highway.KS == 0 and hp['c_pad'] % 128 == 0
    assert hp['smem'] == (64 + (2 * hp['rows'] + 1) * 2 * (width + 8)
                          + hp['stages'] * highway.STAGE_BYTES)
    if (hp['mt'], hp['nt']) == (1, 4):
        assert 1 <= hp['rows'] <= 16
    else:
        assert (hp['rows'], hp['mt'], hp['nt']) in highway.MMA_TILES
    if c == 256 and c_in <= 256:
        assert hp['rows'] == 128 and hp['stages'] == 4
    assert highway.shape_error(max(c_in, 4), c) is None


def test_highway_plan_refuses():
    with pytest.raises(ValueError, match='positive'):
        highway.plan(80, 0)
    with pytest.raises(ValueError, match='one row'):
        highway.plan(80, 256, smem_limit=40000)
    assert 'shared memory' in highway.shape_error(80, 29060)


def _walk_highway(a, res, pre_w, w, b, hp):
    """The bf16 kernel's schedule on float32 values: the pre-projection in
    chunks of 256 columns and each layer in chunks of 128 output columns,
    each chunk's [256, c_pad] weight block read from the packed weights at
    the kernel's flat offsets, the h and g columns of each warp group
    blended as the kernel blends them. ``a`` is the input rows (``res``,
    ``pre_w`` None for ``highway_stack``)."""
    dt = a.dtype
    n, c = a.shape[0], w.shape[1]
    cp, gs, ks, ld = hp['c_pad'], hp['nt'] // 2 * 8, highway.KS, highway.LD
    stage = 256 * ld
    pre_t, wp = highway.pack_weights(pre_w, w, hp)
    wp = wp.float().reshape(-1)

    def product(x, blocks, first, kdim):
        """x[:, :kdim] against the chunk's kdim / KS stages from ``first``"""
        acc = torch.zeros(x.shape[0], 256)
        for s in range(kdim // ks):
            st = blocks[(first + s) * stage:(first + s + 1) * stage]
            acc += x[:, s * ks:(s + 1) * ks] @ st.view(256, ld)[:, :ks].T
        return acc

    x = torch.zeros(n, max(hp['c_in_pad'], cp))
    if pre_w is not None:
        c_in_p = hp['c_in_pad']
        x[:, :a.shape[1]] = (a.float() + res.float()).to(dt).float()
        pre_t = pre_t.float().reshape(-1)
        y = torch.zeros_like(x)
        for oc in range(-(-cp // 256)):
            acc = product(x, pre_t, oc * (c_in_p // ks), c_in_p)
            hi = min(256, cp - oc * 256)
            y[:, oc * 256:oc * 256 + hi] = acc[:, :hi].to(dt).float()
        x = y
    else:
        x[:, :c] = a.float()
    bias = torch.zeros(w.shape[0], 2, cp)
    bias[:, :, :c] = b.view(-1, 2, c)
    for layer in range(w.shape[0]):
        y = torch.zeros_like(x)
        for oc in range(cp // 128):
            acc = product(x, wp, (layer * (cp // 128) + oc) * (cp // ks), cp)
            for grp in range(128 // gs):
                cols = slice(oc * 128 + grp * gs, oc * 128 + (grp + 1) * gs)
                h = torch.relu(acc[:, 2 * grp * gs:(2 * grp + 1) * gs]
                               + bias[layer, 0, cols])
                gv = torch.sigmoid(acc[:, (2 * grp + 1) * gs:
                                       (2 * grp + 2) * gs]
                                   + bias[layer, 1, cols])
                y[:, cols] = (x[:, cols] + gv * (h - x[:, cols])).to(
                    dt).float()
        x = y
    return x[:, :c].to(dt)


@pytest.mark.parametrize('n,c_in,c,layers,limit', [
    (37, 80, 256, 4, SMEM),      # the postnet's stack, 128-row tiles
    (20, 40, 200, 2, SMEM),      # C padded to 256: one pre chunk, 2 layers
    (9, 24, 384, 1, SMEM),       # 64-row tiles (16-column warp groups)
    (5, 16, 128, 0, SMEM)])      # no layers
def test_highway_stage_walk_matches_twin(n, c_in, c, layers, limit):
    g = torch.Generator().manual_seed(n)
    a, res = torch.randn(n, c_in, generator=g), torch.randn(n, c_in,
                                                            generator=g)
    pre_w = torch.randn(c_in, c, generator=g) * c_in ** -0.5
    w = torch.randn(layers, c, 2 * c, generator=g) * c ** -0.5
    b = 0.1 * torch.randn(layers, 2 * c, generator=g)
    hp = highway.plan(c_in, c, smem_limit=limit)
    _close(_walk_highway(a, res, pre_w, w, b, hp),
           highway.pre_highway_stack_plain(a, res, pre_w, w, b))
    hp = highway.plan(0, c, smem_limit=limit)
    _close(_walk_highway(a.new_zeros(n, c) + pre_w[0], None, None, w, b, hp),
           highway.highway_stack_plain(a.new_zeros(n, c) + pre_w[0], w, b))


def test_highway_packing_is_exact():
    """Each packed layer block holds W1's and W2's columns of one warp
    group in turn, transposed; the pre-projection its transpose; zero
    where padded."""
    g = torch.Generator().manual_seed(3)
    c_in, c, layers = 40, 200, 2
    pre_w = torch.randn(c_in, c, generator=g)
    w = torch.randn(layers, c, 2 * c, generator=g)
    for limit in (SMEM, 150000):
        hp = highway.plan(c_in, c, smem_limit=limit)
        gs = hp['nt'] // 2 * 8
        pre_t, wp = highway.pack_weights(pre_w, w, hp)
        ks = highway.KS
        assert pre_t.shape == (1, 2, 256, highway.LD)
        assert not pre_t[..., ks:].any() and not wp[..., ks:].any()
        pre = pre_t[..., :ks].permute(0, 2, 1, 3).reshape(256, 2 * ks)
        assert torch.equal(pre[:c, :c_in], pre_w.T)
        assert not pre[c:].any() and not pre[:, c_in:].any()
        assert wp.shape == (layers, 2, 256 // ks, 128 // gs, 2, gs,
                            highway.LD)
        for grp in range(256 // gs):
            oc, gi = divmod(grp, 128 // gs)
            cols = torch.arange(grp * gs, (grp + 1) * gs)
            live = cols < c
            for half in range(2):
                blk = wp[:, oc, :, gi, half, :, :ks].permute(0, 2, 1, 3) \
                    .reshape(layers, gs, 256)
                assert torch.equal(blk[:, live, :c],
                                   w[:, :, half * c + cols[live]]
                                   .transpose(1, 2))
                assert not blk[:, ~live].any() and not blk[:, :, c:].any()
