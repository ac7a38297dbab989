"""The HiFi-GAN and MelGAN generators (inference), as PyTorch modules.

Port of forwardtacotron_tpu/models/vocoder.py. HiFi-GAN: the
jik876/hifigan ``Generator`` (conv_pre(k=7) -> [leaky -> ConvTranspose1d
upsample -> mean of the dilated ResBlocks of every kernel size]* -> leaky
(slope 0.01) -> conv_post(k=7) -> tanh), with ``ResBlock1`` (two-conv
residual units) and ``ResBlock2`` (one-conv units), in the reference's op
order. Parameter names are the published state_dict's
(``conv_pre.weight`` [C_out, C_in, K], ``ups.{i}.weight`` [C_in, C_out, K],
``resblocks.{r}.convs1.{j}.weight``, ...), so a checkpoint whose weight norm
is folded loads with ``load_state_dict`` (utils/vocoder_checkpoints.py).

Inside, activations are torch's channels-major [B, C, T], which is also the
layout of the fused MRF kernel (``ops/hopper/mrf.py``): a level whose
channel count is at most ``fuse_mrf_max_ch`` runs its three ``ResBlock1``
branches and their mean (18 convolutions) as one kernel launch, without a
transpose. With ``fuse_ups_tail_max_ch``, the levels from the first whose
output has at most that many channels run as the JAX package's
phase-stacked tail: each level (leaky, upsample, MRF) is one ``ups_mrf``
launch on [B, s*C, T] activations (``ops/hopper/ups_mrf.py``), and the
samples are interleaved once, before ``conv_post``. With
``fuse_tail_max_ch``, the levels from the first whose output has at most
that many channels run as the JAX package's channels-major tail: each
level's upsampler is one polyphase GEMM (``_up_cm``) and its MRF one
``mrf`` launch. The public call keeps the JAX contract: mel [B, T, n_mels]
-> wav [B, T * hop].

MelGAN: seungwonpark/melgan's ``Generator`` (reflection-padded conv(k=7) ->
4 x [leaky 0.2 -> ConvTranspose1d -> ResStack] -> leaky 0.2 -> reflection-
padded conv(k=7) -> tanh), with the published 10-frame tail pad in
``MelGANGenerator.inference``. Its parameters carry the JAX module names
(``conv_pre``, ``ups.{i}``, ``res.{i}.blocks_conv1.{j}``, ...);
utils/vocoder_checkpoints.py maps the published ``Sequential`` indices to
them.

Every convolution adds its bias as an operation of its own (as flax does):
in bfloat16 the product is rounded before the bias is added. Leaky ReLU is
max(x, s * x) with s in the activation's dtype, as in the JAX package.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from forwardtacotron_torch.models.layers import Conv, kernel_gap
from forwardtacotron_torch.ops.hopper import mrf as mrf_ops
from forwardtacotron_torch.ops.hopper import ups_mrf as ups_ops

PAD_VALUE = -11.5129

# The exact polyphase form of the transposed-convolution upsamplers (see
# TransposedConv1d), the JAX package's module switch: off by default, as
# there.
POLYPHASE = False


def _same_pad(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """where(x >= 0, x, s * x) with the slope s rounded to x's dtype, as
    JAX's weakly typed constant is (for 0 < s < 1, max(x, s * x))."""
    return torch.maximum(x, x * torch.tensor(slope, dtype=x.dtype))


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


class TransposedConv1d(nn.ConvTranspose1d):
    """torch ``ConvTranspose1d`` with its bias added as an operation of its
    own (the JAX package's ``TransposedConv1d``: one input-dilated
    convolution, then ``+ bias``). With ``POLYPHASE`` set and the
    exact-upsampler geometry (k - s == 2p), the s output phases are one
    stride-1 convolution of s*F channels, interleaved along time: the same
    sums, without the stuffed zeros."""

    def flax_kernel(self) -> torch.Tensor:
        """The weight as the JAX package stores it: [k, C_in, C_out], taps
        reversed."""
        return self.weight.permute(2, 0, 1).flip(0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        if POLYPHASE and s > 1 and k - s == 2 * p:
            y = self._polyphase(x)
        else:
            y = F.conv_transpose1d(x, self.weight, None, self.stride,
                                   self.padding)
        return y + self.bias[:, None]

    def _polyphase(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        comb, dmin, dmax = polyphase_comb(self.flax_kernel(),
                                          self.kernel_size[0], s,
                                          self.padding[0])
        y = F.conv1d(F.pad(x, (-dmin, dmax)), comb.permute(2, 1, 0))
        return ups_ops.phase_unstack(y, s)


def polyphase_comb(kernel: torch.Tensor, k: int, s: int, padding: int):
    """The polyphase kernel of a ``ConvTranspose1d(k, s, p)`` with the
    exact-upsampler geometry k - s == 2p, from its JAX-layout kernel
    [k, C_in, F] (taps reversed): a stride-1 kernel [taps, C_in, s*F]
    whose s*F outputs at step q are the output phases y[q*s + r] (phase-
    major channels), and the tap offsets (dmin, dmax). Shared by the
    ``POLYPHASE`` convolution and the channels-major tail's GEMM."""
    taps_k, in_ch, features = kernel.shape
    assert taps_k == k
    pad = k - 1 - padding
    # output sample q*s + r reads x[q + d_r + m] * kernel[j0_r + m*s]
    j0s = [(pad - r) % s for r in range(s)]
    ns = [-(-(k - j0) // s) for j0 in j0s]
    ds = [(r + j0 - pad) // s for r, j0 in zip(range(s), j0s)]
    dmin = min(ds)
    dmax = max(d + n - 1 for d, n in zip(ds, ns))
    comb = kernel.new_zeros(dmax - dmin + 1, in_ch, s, features)
    for r in range(s):
        lo = ds[r] - dmin
        comb[lo:lo + ns[r], :, r, :] = kernel[j0s[r]::s]
    return comb.reshape(-1, in_ch, s * features), dmin, dmax


def _shift_cm(x: torch.Tensor, delta: int) -> torch.Tensor:
    """[B, C, T] -> the same shape, out[..., t] = x[..., t + delta], zeros
    outside (a convolution's zero boundary)."""
    t = x.shape[-1]
    if delta == 0:
        return x
    if delta > 0:
        return F.pad(x[:, :, delta:], (0, delta))
    return F.pad(x[:, :, :t + delta], (-delta, 0))


def _im2col_cm(x: torch.Tensor, shifts) -> torch.Tensor:
    """[B, C, T] -> [B, len(shifts)*C, T], rows shift-major (the column
    order of ``mrf.pack_conv_weight``)."""
    return torch.cat([_shift_cm(x, d) for d in shifts], dim=1)


class ResBlock1(nn.Module):
    """HiFi-GAN MRF unit, ``resblock: '1'``: per dilation d, a
    (leaky -> dilated conv -> leaky -> conv) residual pair."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            Conv(channels, channels, kernel_size, dilation=d,
                 padding=_same_pad(kernel_size, d)) for d in dilation])
        self.convs2 = nn.ModuleList([
            Conv(channels, channels, kernel_size,
                 padding=_same_pad(kernel_size)) for _ in dilation])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(leaky_relu(c1(leaky_relu(x, 0.1)), 0.1))
        return x


class ResBlock2(nn.Module):
    """HiFi-GAN MRF unit, ``resblock: '2'``: per dilation d, a single
    (leaky -> dilated conv) residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv(channels, channels, kernel_size, dilation=d,
                 padding=_same_pad(kernel_size, d)) for d in dilation])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(leaky_relu(x, 0.1))
        return x


class HiFiGANGenerator(nn.Module):
    """jik876/hifigan Generator (v1/v2/v3 through the arguments).

    ``fuse_mrf_max_ch`` (default 0, as in the JAX package): a level with at
    most this many channels, ``resblock '1'``, one dilation tuple for every
    kernel size and a span that fits the halo runs as one ``mrf`` launch
    when its activation lies on a CUDA device. The kernels take every level
    of 256 channels or fewer, and past that any level the JAX package's
    Pallas kernel can hold (``mrf.plan``), in the activation's dtype.
    ``fuse_ups_tail_max_ch`` (default 0, as in the JAX package): from the
    first level whose output has at most this many channels, each level runs
    as one ``ups_mrf`` launch on phase-stacked activations, where the JAX
    package's gate admits the tail (``_ups_tail_fusable``) and the
    activation lies on a CUDA device. Where either gate admits a level that
    its kernel does not take (past the Pallas kernel's VMEM), the forward
    raises ``NotImplementedError`` rather than run it on plain operations.
    ``fuse_tail_max_ch`` (default 0, as in the JAX package): from the
    first level whose output has at most this many channels, each level
    runs its upsampler as one polyphase GEMM (``_up_cm``) and its MRF as
    one ``mrf`` launch, where the JAX package's gate admits the tail
    (``_tail_fusable``) and the activation lies on a CUDA device. The
    phase-stacked tail's gate is read first."""

    def __init__(self, resblock: str = '1',
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 num_mels: int = 80,
                 fuse_mrf_max_ch: int = 0,
                 fuse_tail_max_ch: int = 0,
                 fuse_ups_tail_max_ch: int = 0):
        super().__init__()
        self.resblock = str(resblock)
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.upsample_initial_channel = int(upsample_initial_channel)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(
            tuple(d) for d in resblock_dilation_sizes)
        self.num_mels = int(num_mels)
        self.fuse_mrf_max_ch = int(fuse_mrf_max_ch)
        self.fuse_tail_max_ch = int(fuse_tail_max_ch)
        self.fuse_ups_tail_max_ch = int(fuse_ups_tail_max_ch)
        # the fused levels' launch weights (:meth:`_launch_weights`)
        self._launch_cache = {}

        ch = self.upsample_initial_channel
        self.conv_pre = Conv(self.num_mels, ch, 7, padding=3)
        block = ResBlock1 if self.resblock == '1' else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(self.upsample_rates, self.upsample_kernel_sizes):
            self.ups.append(TransposedConv1d(ch, ch // 2, k, u,
                                             padding=(k - u) // 2))
            ch //= 2
            for kr, dr in zip(self.resblock_kernel_sizes,
                              self.resblock_dilation_sizes):
                self.resblocks.append(block(ch, kr, dr))
        self.conv_post = Conv(ch, 1, 7, padding=3)

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out

    def _mrf_fusable(self, ch: int, x: torch.Tensor) -> bool:
        """The JAX package's gate (models/vocoder.py ``_mrf_fusable``), with
        "the activation is on a CUDA device" for its TPU-backend clause. A
        level it admits that the ``mrf`` kernel does not take raises."""
        if self.resblock != '1' or not 0 < ch <= self.fuse_mrf_max_ch:
            return False
        krs, dils = self.resblock_kernel_sizes, self.resblock_dilation_sizes
        if any(d != dils[0] for d in dils):
            return False
        if mrf_ops.branch_span(max(krs), dils[0]) > mrf_ops.HALO:
            return False
        if not _on_cuda(x):
            return False
        err = mrf_ops.shape_error(ch, krs, dils[0], x.dtype)
        if err:
            raise kernel_gap(f'HiFi-GAN MRF level of {ch} channels (mrf.cu)',
                             err)
        return True

    def _tail_fusable(self, ch_out: int, level: int,
                      x: torch.Tensor) -> bool:
        """The JAX package's gate of the channels-major tail
        (models/vocoder.py ``_tail_fusable``) entered at ``level``, with
        "the activation is on a CUDA device" for its TPU-backend clause. A
        tail it admits with a level that the ``mrf`` kernel does not take
        raises, before any launch."""
        if not 0 < ch_out <= self.fuse_tail_max_ch or self.resblock != '1':
            return False
        krs, dils = self.resblock_kernel_sizes, self.resblock_dilation_sizes
        if any(d != dils[0] for d in dils):
            return False
        if mrf_ops.branch_span(max(krs), dils[0]) > mrf_ops.HALO:
            return False
        # every remaining upsampler has the polyphase geometry
        for k, s in zip(self.upsample_kernel_sizes[level:],
                        self.upsample_rates[level:]):
            if s <= 1 or (k - s) % 2:
                return False
        if not _on_cuda(x):
            return False
        for j, up in enumerate(self.ups[level:]):
            err = mrf_ops.shape_error(up.out_channels, krs, dils[0],
                                      x.dtype)
            if err:
                raise kernel_gap(f'HiFi-GAN channels-major tail level '
                                 f'{level + j} (mrf.cu)', err)
        return True

    def _ups_tail_fusable(self, ch_out: int, level: int,
                          x: torch.Tensor) -> bool:
        """The JAX package's gate (models/vocoder.py ``_ups_tail_fusable``)
        for a tail entered at ``level`` with activation x [B, C, T] (T is
        JAX's ``t_in``), with "the activation is on a CUDA device" for its
        TPU-backend clause. A tail it admits with a level that the
        ``ups_mrf`` kernel does not take raises."""
        if not 0 < ch_out <= self.fuse_ups_tail_max_ch \
                or self.resblock != '1':
            return False
        dils = self.resblock_dilation_sizes
        if any(d != dils[0] for d in dils):
            return False
        rates = self.upsample_rates[level:]
        sizes = self.upsample_kernel_sizes[level:]
        if any(s <= 1 or (k - s) % 2 for k, s in zip(sizes, rates)):
            return False
        # at most 4 phases, and a length the phases divide
        s_total = math.prod(rates)
        if s_total > 4 or x.shape[-1] % s_total:
            return False
        if not _on_cuda(x):
            return False
        s_in = 1
        for j, (up, s) in enumerate(zip(self.ups[level:], rates)):
            err = ups_ops.shape_error(s_in, s, up.in_channels,
                                      up.out_channels, up.kernel_size[0],
                                      self.resblock_kernel_sizes, dils[0],
                                      x.dtype)
            if err:
                raise kernel_gap(f'HiFi-GAN tail level {level + j} '
                                 '(ups_mrf in mrf.cu)', err)
            s_in *= s
        return True

    def mrf_weights(self, level: int, dtype: torch.dtype,
                    bias_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, ...]:
        """The level's ResBlock1 weights packed for ``mrf``: per kernel
        size (w1, b1, w2, b2), weights [U, C, kr*C] in ``dtype``, biases
        [U, C, 1] in ``bias_dtype`` (``dtype`` unless given)."""
        num_kernels = len(self.resblock_kernel_sizes)
        weights = []
        for j in range(num_kernels):
            rb = self.resblocks[level * num_kernels + j]
            for convs in (rb.convs1, rb.convs2):
                weights.append(torch.stack(
                    [mrf_ops.pack_conv_weight(c.weight) for c in convs]
                ).to(dtype).contiguous())
                weights.append(torch.stack(
                    [c.bias for c in convs])[:, :, None]
                    .to(bias_dtype or dtype).contiguous())
        return tuple(weights)

    def ups_mrf_weights(self, level: int, dtype: torch.dtype
                        ) -> Tuple[torch.Tensor, ...]:
        """The level's weights for ``ups_mrf``: the upsampler's [k, C, C_in]
        (``pack_up_weight``) in ``dtype`` and its bias [C] in float32, then
        the MRF's as :meth:`mrf_weights` packs them, with float32 biases (as
        the JAX package's ``_ups_mrf_level`` stacks them)."""
        up = self.ups[level]
        return (ups_ops.pack_up_weight(up.weight).to(dtype).contiguous(),
                up.bias.float().contiguous(),
                *self.mrf_weights(level, dtype, torch.float32))

    def _launch_weights(self, key: tuple, modules, make):
        """``make()``: what a fused level launches with (its weights stacked
        and cast, padded and packed for the kernel), made once per state of
        the weights. Kept until a parameter of ``modules`` is written in
        place (its version counter moves; a write through ``.data`` does
        not count) or is moved or replaced (its storage changes)."""
        stamp = tuple((p.data_ptr(), p._version)
                      for m in modules for p in m.parameters())
        hit = self._launch_cache.get(key)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hit = self._launch_cache[key] = (stamp, make())
        return hit[1]

    def _level_blocks(self, level: int):
        n = len(self.resblock_kernel_sizes)
        return list(self.resblocks[level * n:(level + 1) * n])

    def _mrf_fused(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """The level's ResBlock1 branches and their mean as one ``mrf``
        call on channels-major x [B, C, T]."""
        krs = self.resblock_kernel_sizes
        dils = self.resblock_dilation_sizes[0]

        def make():
            weights = self.mrf_weights(level, x.dtype)
            return weights, (mrf_ops.prepare(weights, krs, dils)
                             if x.device.type == 'cuda' else None)
        weights, prepared = self._launch_weights(
            ('mrf', level, x.dtype), self._level_blocks(level), make)
        return mrf_ops.mrf(x.contiguous(), weights, krs, dils,
                           prepared=prepared)

    def _up_cm(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """The level's upsampler on channels-major x [B, C_in, T]: the s
        output phases as one [s*F, taps*C_in] GEMM against the shifted
        copies of x (``torch.matmul``, as the JAX package's einsum is a
        plain product), interleaved along time -> [B, F, s*T]."""
        up = self.ups[level]
        k, s = self.upsample_kernel_sizes[level], self.upsample_rates[level]

        def make():
            comb, dmin, _ = polyphase_comb(up.flax_kernel().to(x.dtype), k,
                                           s, (k - s) // 2)
            return (mrf_ops.pack_conv_weight(comb.permute(2, 1, 0))
                    .contiguous(), dmin, up.bias.to(x.dtype))
        w, dmin, bias = self._launch_weights(('up_cm', level, x.dtype),
                                             [up], make)
        taps = w.shape[1] // x.shape[1]
        y = torch.matmul(w, _im2col_cm(x, range(dmin, dmin + taps)))
        return ups_ops.phase_unstack(y, s) + bias[None, :, None]

    def _ups_mrf_level(self, x: torch.Tensor, level: int,
                       s_in: int) -> torch.Tensor:
        """One level of the phase-stacked tail (leaky, upsample, MRF) as one
        ``ups_mrf`` call: [B, s_in*C_in, T] -> [B, s_in*s*C, T]."""
        s_up, krs = self.upsample_rates[level], self.resblock_kernel_sizes
        dils = self.resblock_dilation_sizes[0]

        def make():
            up_w, up_b, *weights = self.ups_mrf_weights(level, x.dtype)
            return up_w, up_b, tuple(weights), (
                ups_ops.prepare(up_w, up_b, tuple(weights), s_in, s_up, krs,
                                dils) if x.device.type == 'cuda' else None)
        up_w, up_b, weights, prepared = self._launch_weights(
            ('ups_mrf', level, x.dtype, s_in),
            [self.ups[level]] + self._level_blocks(level), make)
        return ups_ops.ups_mrf(x.contiguous(), up_w, up_b, weights, s_in,
                               s_up, krs, dils, x.shape[-1],
                               prepared=prepared)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, n_mels] -> wav [B, T * hop_length]."""
        num_kernels = len(self.resblock_kernel_sizes)
        x = self.conv_pre(mel.to(self.conv_pre.weight.dtype).transpose(1, 2))
        tail, s_in = False, 1     # the phase-stacked tail, its phases
        cm = False                # the channels-major tail
        for i, up in enumerate(self.ups):
            if not tail and not cm \
                    and self._ups_tail_fusable(up.out_channels, i, x):
                tail = True       # x [B, C, T] is its input with 1 phase
            if tail:
                x = self._ups_mrf_level(x, i, s_in)
                s_in *= self.upsample_rates[i]
                continue
            if not cm and self._tail_fusable(up.out_channels, i, x):
                cm = True         # x is channels-major already
            if cm:
                x = self._mrf_fused(self._up_cm(leaky_relu(x, 0.1), i), i)
                continue
            x = up(leaky_relu(x, 0.1))
            if self._mrf_fusable(x.shape[1], x):
                x = self._mrf_fused(x, i)
            else:
                xs = self.resblocks[i * num_kernels](x)
                for j in range(1, num_kernels):
                    xs = xs + self.resblocks[i * num_kernels + j](x)
                x = xs / num_kernels
        if tail:
            x = ups_ops.phase_unstack(x, s_in)    # interleave once
        x = torch.tanh(self.conv_post(leaky_relu(x, 0.01)))
        return x[:, 0]

    @classmethod
    def from_config(cls, config: dict, **kwargs) -> 'HiFiGANGenerator':
        """Accepts the official hifigan config.json key names; ``kwargs``
        (e.g. ``fuse_mrf_max_ch``, ``fuse_tail_max_ch``,
        ``fuse_ups_tail_max_ch``) pass on to the constructor."""
        return cls(
            resblock=str(config.get('resblock', '1')),
            upsample_rates=tuple(config.get('upsample_rates', (8, 8, 2, 2))),
            upsample_kernel_sizes=tuple(
                config.get('upsample_kernel_sizes', (16, 16, 4, 4))),
            upsample_initial_channel=int(
                config.get('upsample_initial_channel', 512)),
            resblock_kernel_sizes=tuple(
                config.get('resblock_kernel_sizes', (3, 7, 11))),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in config.get(
                    'resblock_dilation_sizes',
                    ((1, 3, 5), (1, 3, 5), (1, 3, 5)))),
            num_mels=int(config.get('num_mels', 80)), **kwargs)


def _reflect_conv(x: torch.Tensor, conv: nn.Conv1d, pad: int) -> torch.Tensor:
    return conv(F.pad(x, (pad, pad), mode='reflect'))


class MelGANResStack(nn.Module):
    """seungwonpark/melgan ResStack: 3 residual units, each a 3**i-dilated
    k=3 reflection-padded convolution and a 1x1 one (leaky 0.2 before
    each), summed with a 1x1 shortcut convolution of the input."""

    def __init__(self, channels: int):
        super().__init__()
        self.blocks_conv1 = nn.ModuleList([
            Conv(channels, channels, 3, dilation=3 ** i) for i in range(3)])
        self.blocks_conv2 = nn.ModuleList([
            Conv(channels, channels, 1) for _ in range(3)])
        self.shortcuts = nn.ModuleList([
            Conv(channels, channels, 1) for _ in range(3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            xt = _reflect_conv(leaky_relu(x, 0.2), self.blocks_conv1[i],
                               3 ** i)
            xt = self.blocks_conv2[i](leaky_relu(xt, 0.2))
            x = self.shortcuts[i](x) + xt
        return x


class MelGANGenerator(nn.Module):
    """seungwonpark/melgan Generator (hop 256 = 8*8*2*2): mel
    [B, T, mel_channels] -> wav [B, T * 256]. :meth:`inference` adds the
    published 10 frames of log(1e-5) = -11.5129 before the call and crops
    their samples off after it."""

    def __init__(self, mel_channels: int = 80, base_channels: int = 512,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2)):
        super().__init__()
        self.mel_channels = int(mel_channels)
        self.base_channels = int(base_channels)
        self.upsample_rates = tuple(upsample_rates)
        ch = self.base_channels
        self.conv_pre = Conv(self.mel_channels, ch, 7)
        self.ups = nn.ModuleList()
        self.res = nn.ModuleList()
        for u in self.upsample_rates:
            self.ups.append(TransposedConv1d(ch, ch // 2, 2 * u, u,
                                             padding=u // 2))
            ch //= 2
            self.res.append(MelGANResStack(ch))
        self.conv_post = Conv(ch, 1, 7)

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsample_rates)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = _reflect_conv(mel.to(self.conv_pre.weight.dtype).transpose(1, 2),
                          self.conv_pre, 3)
        for up, stack in zip(self.ups, self.res):
            x = stack(up(leaky_relu(x, 0.2)))
        x = _reflect_conv(leaky_relu(x, 0.2), self.conv_post, 3)
        return torch.tanh(x)[:, 0]

    def inference(self, mel: torch.Tensor, pad_frames: int = 10
                  ) -> torch.Tensor:
        tail = mel.new_full((mel.shape[0], pad_frames, mel.shape[2]),
                            PAD_VALUE)
        wav = self(torch.cat([mel, tail], dim=1))
        return wav[:, :mel.shape[1] * self.hop_length]
