"""Core blocks of the ForwardTacotron models, as PyTorch modules.

Port of forwardtacotron_tpu/models/layers.py for the serving and training
paths: BatchNormConv (ReLU before BN), HighwayNetwork, the bidirectional
GRU/LSTM with exact-length semantics, ``multi_bigru``, the frame trunk, CBHG
and ``make_len_mask``. Public functions keep the JAX package's batch-first
channels-last [B, T, C] layout; parameter names are the reference's
state_dict names, so reference checkpoints load with ``load_state_dict``.

In bfloat16 the recurrences take the ``rnn`` kernels and the frame trunk the
``lr_bidir`` + ``rnn`` kernels wherever the JAX package's gates send them to
its Pallas kernels (``rnn_kernel_eligible``); in float32 they stay per-step
loops, as the JAX package's float32 path stays ``lax.scan``. The frame
trunk's length regulator takes the ``lr`` kernel in both.

A module in training mode (``nn.Module.train()``) normalizes with batch
statistics and updates the running ones as flax's BatchNorm does, drops
where the JAX modules drop, and keeps the CBHG on plain operations; the
trainer sets ``rnn_train.rnn_mode('train')`` so that the eligible
recurrences take the differentiable kernels of ``ops/hopper/rnn_train.py``.
"""

import functools
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from forwardtacotron_torch.ops.hopper import lr_bidir
from forwardtacotron_torch.ops.hopper import rnn as rnn_ops
from forwardtacotron_torch.ops.hopper import rnn_train
from forwardtacotron_torch.ops.hopper import cbhg as cbhg_ops
from forwardtacotron_torch.ops.hopper import highway as highway_ops
from forwardtacotron_torch.ops.length_regulator import (duration_spans,
                                                        length_regulator)
from forwardtacotron_torch.parallel.mesh import data_parallel, global_sum_grad

BN_EPS = 1e-5
# flax's BatchNorm momentum: running = 0.9 * running + 0.1 * batch
BN_MOMENTUM = 0.9


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


def kernel_gap(what: str, err: str) -> NotImplementedError:
    """The error a gate raises for a CUDA tensor where the JAX package's gate
    sends the work to its Pallas kernel but the CUDA kernel does not take
    the shape: the port does not give way to plain operations on the card."""
    return NotImplementedError(
        f'{what}: the JAX package runs its Pallas kernel here, but the CUDA '
        f'kernel does not take this shape yet ({err}); see ROADMAP.md '
        'Queue 3, "kernel shapes not covered"')


class Dense(nn.Linear):
    """nn.Linear that adds its bias as an operation of its own, as flax's
    ``nn.Dense`` does (``y = x @ W; y += b``): in bfloat16 the product is
    rounded before the bias is added (nn.Linear rounds once). The same
    parameters and state_dict names as nn.Linear."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.linear(x, self.weight)
        return y if self.bias is None else y + self.bias


class Conv(nn.Conv1d):
    """nn.Conv1d that adds its bias as an operation of its own, as flax's
    ``nn.Conv`` does (see :class:`Dense`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x, self.weight, None)
        return y if self.bias is None else y + self.bias[:, None]


def conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """[B, T, C] conv with torch's ``padding=k//2``; an even kernel emits
    T+1 frames, truncated to T."""
    t = x.shape[1]
    return conv(x.transpose(1, 2))[:, :, :t].transpose(1, 2)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """flax's BatchNorm in training on [B, T, C]: statistics over every
    frame (padding included) in float32, the biased variance
    E[x^2] - E[x]^2 clipped at 0, the output in x's dtype; the running
    statistics move by momentum 0.9 with that biased variance (torch's
    BatchNorm1d uses 0.1 and the unbiased one). In a data-parallel step the
    statistics cover every rank's frames: the sums and the count go
    through one differentiable all-reduce, so every rank normalizes alike
    and keeps the same running statistics."""
    xf = x.float()
    if data_parallel():
        c = xf.shape[-1]
        stats = global_sum_grad(torch.cat([
            xf.sum(dim=(0, 1)), (xf * xf).sum(dim=(0, 1)),
            xf.new_full((1,), float(xf.shape[0] * xf.shape[1]))]))
        mean, mean_sq = stats[:c] / stats[-1], stats[c:2 * c] / stats[-1]
    else:
        mean = xf.mean(dim=(0, 1))
        mean_sq = (xf * xf).mean(dim=(0, 1))
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + BN_EPS) * bn.weight.float()) \
        + bn.bias.float()
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1.0 - BN_MOMENTUM) * var)
        bn.num_batches_tracked += 1
    return y.to(x.dtype)


class BatchNormConv(nn.Module):
    """Conv (no bias) -> optional ReLU -> BatchNorm. The ReLU runs BEFORE
    the norm, as in the reference. Training mode normalizes with batch
    statistics (``batch_norm_train``), eval mode with the running ones."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel, stride=1,
                              padding=kernel // 2, bias=False)
        self.bnorm = nn.BatchNorm1d(out_channels, eps=BN_EPS)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv1d(x, self.conv)
        if self.relu:
            x = torch.relu(x)
        bn = self.bnorm
        if self.training:
            return batch_norm_train(x, bn)
        return (x - bn.running_mean) * (torch.rsqrt(bn.running_var + BN_EPS)
                                        * bn.weight) + bn.bias

    def folded_bn(self):
        """(scale', bias') with BN(y) = y * scale' + bias', folded in
        float32 from the statistics in whatever dtype they are kept."""
        bn = self.bnorm
        s = torch.rsqrt(bn.running_var.float() + BN_EPS) * bn.weight.float()
        return s, bn.bias.float() - bn.running_mean.float() * s


class HighwayNetwork(nn.Module):
    """y = g * relu(W1 x) + (1 - g) * x, g = sigmoid(W2 x)."""

    def __init__(self, size: int):
        super().__init__()
        self.W1 = Dense(size, size)
        self.W2 = Dense(size, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.sigmoid(self.W2(x))
        return g * torch.relu(self.W1(x)) + (1.0 - g) * x


# ----------------------------------------------------------------------- RNNs


def flip_sequences(x: torch.Tensor,
                   lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Reverse along time; with ``lengths`` only each item's valid prefix is
    reversed, so a backward RNN starts at the true last frame. Indices are
    clamped to T-1: lengths may exceed T when durations outrun the frame
    budget, and ``gather`` raises on an out-of-range index."""
    if lengths is None:
        return torch.flip(x, dims=[1])
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    lens = lengths[:, None].to(pos.dtype)
    idx = torch.where(pos < lens, lens - 1 - pos, pos).clamp(max=t - 1)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def rnn_kernel_eligible(dtype: torch.dtype, in_dim: int, hidden: int) -> bool:
    """The JAX package's gate for its recurrent kernels
    (ops/pallas/rnn.py ``eligible``), kept so both packages route alike:
    bfloat16 only, H a multiple of 128, the input width of 16, and the
    kernels not switched off (``rnn_train.rnn_mode('off')``)."""
    return (rnn_train.current_mode() != 'off' and dtype == torch.bfloat16
            and hidden % 128 == 0 and in_dim % 16 == 0)


def time_major(x: torch.Tensor,
               lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, C] -> the recurrent kernels' [T, 2, B, C]: direction 0 as it
    is, direction 1 flipped per item."""
    return torch.stack([x, flip_sequences(x, lengths)]).permute(
        2, 0, 1, 3).contiguous()


def unstack(hs: torch.Tensor,
            lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[T, 2, B, H] -> [B, T, 2H] with the backward half flipped back."""
    return torch.cat([hs[:, 0].transpose(0, 1),
                      flip_sequences(hs[:, 1].transpose(0, 1), lengths)],
                     dim=-1)


def _gru_step(carry, xp_t, wh, bh):
    """carry (h [2, B, H],); xp_t [2, B, 3H]; wh [2, H, 3H]; bh [2, 1, 3H]."""
    (h,) = carry
    hproj = torch.baddbmm(bh, h, wh)
    xr, xz, xn = xp_t.chunk(3, dim=-1)
    hr, hz, hn = hproj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    hnew = (1.0 - z) * n + z * h
    return (hnew,), hnew


def _lstm_step(carry, xp_t, wh, bh):
    """carry (h, c), each [2, B, H]; xp_t [2, B, 4H]; wh [2, H, 4H]."""
    h, c = carry
    gates = xp_t + torch.baddbmm(bh, h, wh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return (h_new, c_new), h_new


def _scan(xp2: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor, step_fn,
          n_carry: int) -> torch.Tensor:
    """Per-step loop over time-major input projections xp2 [T, 2, B, G]:
    both directions advance together as a batch axis. Returns
    [T, 2, B, H]."""
    zeros = xp2.new_zeros(2, xp2.shape[2], wh.shape[1])
    carry = tuple(zeros for _ in range(n_carry))
    hs = []
    for step in range(xp2.shape[0]):
        carry, h = step_fn(carry, xp2[step], wh, bh[:, None])
        hs.append(h)
    return torch.stack(hs)


def bidir_rnn_trainable(x: torch.Tensor, lengths: Optional[torch.Tensor],
                        wi: torch.Tensor, wh: torch.Tensor, bi: torch.Tensor,
                        bh: torch.Tensor, cell: str) -> torch.Tensor:
    """Differentiable bidirectional GRU/LSTM, [B, T, I] -> [B, T, 2H], on
    the stacked weights (wi [2, I, G], wh [2, H, G], bi/bh [2, G]), through
    ``rnn_train.GruCore`` / ``LstmCore``. As the JAX function does, the
    batch is padded to a multiple of 16 (padded items of length 1), the
    backward direction is flipped per item and stacked time-major for the
    core, and the glue stays differentiable PyTorch."""
    b = x.shape[0]
    pad = -b % 16
    if pad:
        x = torch.cat([x, x.new_zeros(pad, *x.shape[1:])])
        if lengths is not None:
            lengths = torch.cat([lengths, lengths.new_ones(pad)])
    x2 = time_major(x, lengths)
    if cell == 'lstm':
        hs = rnn_train.LstmCore.apply(x2, wi, wh, bi + bh)
    else:
        hs = rnn_train.GruCore.apply(x2, wi, wh, bi, bh)
    return unstack(hs, lengths)[:b]


def _bidir_scan(x: torch.Tensor, lengths: Optional[torch.Tensor],
                rnn: '_BiRNN', step_fn, n_carry: int) -> torch.Tensor:
    """[B, T, I] -> [B, T, 2H]; with ``lengths`` the backward direction
    starts at each item's true last frame. One kernel launch for the whole
    sequence where ``rnn_kernel_eligible`` (the differentiable cores of
    ``rnn_train`` under ``rnn_mode('train')``), else a per-step loop."""
    wi, wh, bi, bh = rnn.stacked_params()
    if (rnn_train.current_mode() == 'train'
            and rnn_kernel_eligible(x.dtype, x.shape[-1], rnn.hidden)):
        return bidir_rnn_trainable(x, lengths, wi, wh, bi, bh,
                                   'lstm' if n_carry == 2 else 'gru')
    x2 = time_major(x, lengths)
    if rnn_kernel_eligible(x.dtype, x.shape[-1], rnn.hidden):
        if n_carry == 2:
            hs = rnn_ops.lstm(x2, wi, wh, bi + bh)
        else:
            hs = rnn_ops.gru(x2, wi, wh, bi, bh)
    else:
        hs = _scan(x2 @ wi + bi[:, None], wh, bh, step_fn, n_carry)
    return unstack(hs, lengths)


class _BiRNN(nn.Module):
    """Parameters of a one-layer bidirectional torch RNN, under the
    reference's names, in torch gate order."""

    def __init__(self, input_size: int, hidden: int, n_gates: int):
        super().__init__()
        self.hidden = hidden
        g = n_gates * hidden
        for suffix in ('_l0', '_l0_reverse'):
            self.register_parameter('weight_ih' + suffix,
                                    nn.Parameter(torch.empty(g, input_size)))
            self.register_parameter('weight_hh' + suffix,
                                    nn.Parameter(torch.empty(g, hidden)))
            self.register_parameter('bias_ih' + suffix,
                                    nn.Parameter(torch.empty(g)))
            self.register_parameter('bias_hh' + suffix,
                                    nn.Parameter(torch.empty(g)))
        bound = 1.0 / math.sqrt(hidden)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def dir_params(self) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        """(fwd, bwd), each (wi [I, G], wh [H, G], bi [G], bh [G]): the JAX
        package's layout."""
        return tuple((getattr(self, 'weight_ih' + s).T,
                      getattr(self, 'weight_hh' + s).T,
                      getattr(self, 'bias_ih' + s),
                      getattr(self, 'bias_hh' + s))
                     for s in ('_l0', '_l0_reverse'))

    def stacked_params(self) -> Tuple[torch.Tensor, ...]:
        """(wi [2, I, G], wh [2, H, G], bi [2, G], bh [2, G]): both
        directions stacked, as the recurrent kernels take them."""
        return tuple(torch.stack(p).contiguous()
                     for p in zip(*self.dir_params()))


class BiGRU(_BiRNN):

    def __init__(self, input_size: int, hidden: int):
        super().__init__(input_size, hidden, 3)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _bidir_scan(x, lengths, self, _gru_step, 1)


class BiLSTM(_BiRNN):

    def __init__(self, input_size: int, hidden: int):
        super().__init__(input_size, hidden, 4)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _bidir_scan(x, lengths, self, _lstm_step, 2)


def multi_gru_weights(rnns: Sequence[BiGRU]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal recurrent weights [2, H, 3H] and biases [2, 3H] of
    several BiGRUs, H the sum of their widths, gates grouped r | z | n."""
    hiddens = [rnn.hidden for rnn in rnns]
    total = sum(hiddens)
    w0 = rnns[0].weight_hh_l0
    wh = w0.new_zeros(2, total, 3 * total)
    bh = w0.new_zeros(2, 3 * total)
    lo = 0
    for rnn, h in zip(rnns, hiddens):
        for d, (_, w, _, bias) in enumerate(rnn.dir_params()):
            for g in range(3):
                cols = slice(g * total + lo, g * total + lo + h)
                wh[d, lo:lo + h, cols] = w[:, g * h:(g + 1) * h]
                bh[d, cols] = bias[g * h:(g + 1) * h]
        lo += h
    return wh, bh


def multi_bigru(entries: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor],
                                        BiGRU]]) -> List[torch.Tensor]:
    """Several independent bidirectional GRUs as one recurrence (port of the
    JAX ``multi_bigru``): hidden states concatenated, recurrent weights
    block-diagonal, so zero off-block weights add exact zeros to each gate.

    ``entries``: (x [B, T, I_i], lengths_i or None, BiGRU). Returns
    [B, T, 2 H_i] per entry. The input projections run per GRU, rounded to
    the input dtype, regrouped per gate; the recurrence is one
    ``gru_xp`` launch where ``rnn_kernel_eligible`` holds for the summed H,
    else a per-step loop."""
    hiddens = [rnn.hidden for _, _, rnn in entries]
    total = sum(hiddens)
    offs = [sum(hiddens[:i]) for i in range(len(hiddens) + 1)]
    x0 = entries[0][0]
    xps = []
    for x, lens, rnn in entries:
        (wi_f, _, bi_f, _), (wi_b, _, bi_b, _) = rnn.dir_params()
        xps.append((x @ wi_f + bi_f, flip_sequences(x, lens) @ wi_b + bi_b))

    def regroup(d):  # concat per gate across GRUs -> [B, T, 3H]
        return torch.cat([xps[i][d][..., g * h:(g + 1) * h]
                          for g in range(3)
                          for i, h in enumerate(hiddens)], dim=-1)

    wh, bh = multi_gru_weights([rnn for _, _, rnn in entries])
    xp2 = torch.stack([regroup(0), regroup(1)]).permute(
        2, 0, 1, 3).contiguous()                         # [T, 2, B, 3H]
    if rnn_kernel_eligible(x0.dtype, 16, total):
        hs = rnn_ops.gru_xp(xp2, wh, bh)
    else:
        hs = _scan(xp2, wh, bh, _gru_step, 1)
    return [unstack(hs[..., lo:lo + h], lens)
            for (_, lens, _), h, lo in zip(entries, hiddens, offs)]


def mel_weights(lstm: BiLSTM, lin: nn.Linear) -> torch.Tensor:
    """The mel Linear's weight split per LSTM direction: [2, H, M]."""
    w_mel = lin.weight.T                                # [2H, M]
    return torch.stack([w_mel[:lstm.hidden], w_mel[lstm.hidden:]]
                       ).contiguous()


def lstm_lr_mel(h: torch.Tensor, dur: torch.Tensor, max_len: int,
                lstm: BiLSTM, lin: nn.Linear) -> torch.Tensor:
    """The fused frame trunk (port of the JAX ``lstm_lr_mel_pallas``):
    [B, N, C] tokens -> [B, max_len, M] mels, as lin(lstm(LR(h))).

    The bidirectional LR writes the LSTM's [T, 2, B, C] input directly;
    the LSTM applies the mel projection in every step, so only the two
    directions' [T, 2, B, M] mel halves leave it, combined here as
    fwd + flip(bwd) + b_mel. The recurrence runs max_len rounded up to
    ``lr_bidir.T_TILE`` frames, as the JAX package's does, which fixes
    where an over-budget item's backward direction starts."""
    _, ends = duration_spans(dur)
    t_run = -(-max_len // lr_bidir.T_TILE) * lr_bidir.T_TILE
    x2 = lr_bidir.length_regulator_bidir(h.contiguous(),
                                         ends.to(torch.int32), t_run)
    wi, wh, bi, bh = lstm.stacked_params()
    parts = rnn_ops.lstm_mel(x2, wi, wh, bi + bh, mel_weights(lstm, lin))
    fwd = parts[:, 0].transpose(0, 1)
    bwd = flip_sequences(parts[:, 1].transpose(0, 1), ends[:, -1])
    return (fwd + bwd + lin.bias)[:, :max_len]


def frame_trunk(h: torch.Tensor, dur: torch.Tensor, lengths: torch.Tensor,
                max_len: int, lstm: BiLSTM, lin: nn.Linear) -> torch.Tensor:
    """Frame-rate trunk: length regulator -> bi-LSTM -> mel Linear; the
    fused ``lstm_lr_mel`` where the JAX package fuses it (its RNN gate
    outside training and an input width that is a multiple of 128), else
    the ``lr`` kernel and the bi-LSTM."""
    in_dim = h.shape[-1]
    if (rnn_train.current_mode() == 'on' and in_dim % 128 == 0
            and rnn_kernel_eligible(h.dtype, in_dim, lstm.hidden)):
        return lstm_lr_mel(h, dur, max_len, lstm, lin)
    h = length_regulator(h, dur, max_len)
    h = lstm(h, lengths=lengths)
    return lin(h)


# ----------------------------------------------------------------------- CBHG


def maxpool_time(x: torch.Tensor) -> torch.Tensor:
    """MaxPool1d(kernel=2, stride=1, padding=1) over time truncated to T:
    out[t] = max(x[t-1], x[t]) with a -inf left pad. On a tie the gradient
    goes to x[t-1], as it does through the JAX package's reduce_window max
    (ties are common: ReLU zeros become equal values after BatchNorm)."""
    t = x.shape[1]
    return nn.functional.max_pool1d(x.transpose(1, 2), 2, 1,
                                    padding=1)[:, :, :t].transpose(1, 2)


# The JAX package sends a CBHG front to its fused kernel only when the bank
# and proj1 weights fit one VMEM-resident dispatch (10 MB as bf16) and its
# bank's taps fit the kernel's 8-frame halo. That budget is a TPU limit, but
# it is what routes the K=8 postnet front to the kernel and keeps the K=16
# prenet front on plain convolutions; the port routes the same way until the
# prenet front is measured on the card.
FRONT_WEIGHT_BUDGET = 10 * 2 ** 20
BANK_HALO = 8
# The JAX gate of the fused pool + proj1 (``CBHG._pool_proj_fusable``):
# whole-T blocks of at most 512 frames and 2 MB
POOL_PROJ_MAX_T = 512
POOL_PROJ_BLOCK_BYTES = 2 * 2 ** 20


def _front_fits_one_dispatch(k_max: int, c_in: int, c: int, p: int) -> bool:
    return 2 * (k_max * (k_max + 1) // 2 * c_in * c
                + 3 * k_max * c * p) <= FRONT_WEIGHT_BUDGET


class CBHG(nn.Module):
    """Conv bank (k=1..K) -> maxpool -> 2 projections -> residual ->
    highway stack -> bidirectional GRU (reference common_layers.py:60-124).

    The inference variants are the JAX module's six fields, plain attributes
    with its defaults that a caller may set after construction; ``pre_rnn``
    reads them at each call and routes in the JAX order:

    - ``fuse_front`` (on): bank .. proj1 as one ``cbhg_front`` launch where
      the JAX gate admits the front (the weight budget, the bank halo);
    - ``stream_pool_proj``: bank -> pool -> partial proj1 per branch, f32
      partials (``_bank_pool_proj1_streamed``);
    - ``fuse_pool_proj``: the bank concat, then pool + mask + proj1 as one
      ``pool_proj1`` launch where the JAX gate admits it (T <= 512,
      K*C % 128 == 0, a T * K*C block of at most 2 MB);
    - else the bank (``fuse_bank``: one K-tap convolution) and the pool +
      mask (``fuse_pool``: one ``pool_mask`` launch), then proj1;
    - ``fuse_highways`` (on): residual + pre_highway + highways as one
      ``pre_highway_stack`` launch where C % 128 == 0.

    On a card a part whose gate admits it but whose kernel does not take
    its shape raises (``kernel_gap``). Training takes the plain operations,
    with dropout after the pool/mask and after proj1, as the JAX module's
    training branch does."""

    def __init__(self, K: int, in_channels: int, channels: int,
                 proj_channels: Sequence[int], num_highways: int,
                 dropout: float = 0.5, fuse_bank: bool = False,
                 stream_pool_proj: bool = False, fuse_pool_proj: bool = False,
                 fuse_highways: bool = True, fuse_pool: bool = False,
                 fuse_front: bool = True):
        super().__init__()
        self.K = K
        self.drop = nn.Dropout(dropout)
        self.channels = channels
        self.conv1d_bank = nn.ModuleList(
            [BatchNormConv(in_channels, channels, k) for k in range(1, K + 1)])
        self.conv_project1 = BatchNormConv(K * channels, proj_channels[0], 3)
        self.conv_project2 = BatchNormConv(proj_channels[0], proj_channels[1],
                                           3, relu=False)
        self.pre_highway = nn.Linear(proj_channels[-1], channels, bias=False)
        self.highways = nn.ModuleList(
            [HighwayNetwork(channels) for _ in range(num_highways)])
        self.rnn = BiGRU(channels, channels)
        self.fuse_bank = fuse_bank
        self.stream_pool_proj = stream_pool_proj
        self.fuse_pool_proj = fuse_pool_proj
        self.fuse_highways = fuse_highways
        self.fuse_pool = fuse_pool
        self.fuse_front = fuse_front
        self.front_fits = (K // 2 <= BANK_HALO and _front_fits_one_dispatch(
            K, in_channels, channels, proj_channels[0]))
        # why each kernel cannot take its part (None where it can): such a
        # part raises on a card
        self.front_error = cbhg_ops.shape_error(K, in_channels, channels,
                                                proj_channels[0])
        self.highways_error = highway_ops.shape_error(proj_channels[-1],
                                                      channels)

    # the JAX gates, read from the fields at each call
    @property
    def front_fusable(self) -> bool:
        """``_front_fusable`` without its T > 512 clause (the port's kernel
        tiles time; ROADMAP.md Queue 3)."""
        return self.fuse_front and self.front_fits

    @property
    def highways_fusable(self) -> bool:
        """``_highways_fusable``."""
        return (self.fuse_highways and len(self.highways) > 0
                and self.channels % 128 == 0)

    def pool_proj_fusable(self, t: int, dtype: torch.dtype) -> bool:
        """``_pool_proj_fusable`` for T = ``t`` frames in ``dtype``."""
        kc = self.K * self.channels
        return (self.fuse_pool_proj and t <= POOL_PROJ_MAX_T
                and kc % 128 == 0
                and t * kc * dtype.itemsize <= POOL_PROJ_BLOCK_BYTES)

    def _takes_kernel(self, fusable: bool, err: Optional[str], what: str,
                      x: torch.Tensor) -> bool:
        """Whether inference sends a part to its kernel: where the JAX gate
        ``fusable`` does. On a card the kernel must take the part's shape;
        where ``err`` says it does not, this raises."""
        if not fusable or self.training:
            return False
        if err and _on_cuda(x):
            raise kernel_gap(what, err)
        return True

    def front_args(self, x: torch.Tensor, mask: torch.Tensor):
        """Arguments of ``bank_pool_proj`` (and its twin) for this front:
        conv weights as [k, C_in, C] / [3, K*C, P] in the model's dtype,
        the folded BatchNorms in float32 (``mask`` must be float32)."""
        folded = [m.folded_bn() for m in self.conv1d_bank]
        p_s, p_b = self.conv_project1.folded_bn()
        return (x.contiguous(), mask.contiguous(),
                [m.conv.weight.permute(2, 1, 0).contiguous()
                 for m in self.conv1d_bank],
                torch.stack([f[0] for f in folded]),
                torch.stack([f[1] for f in folded]),
                self.proj1_weight(), p_s.contiguous(), p_b.contiguous())

    def proj1_weight(self) -> torch.Tensor:
        """conv_project1's kernel as [3, K*C, P]."""
        return self.conv_project1.conv.weight.permute(2, 1, 0).contiguous()

    def highway_weights(self):
        """W1 | W2 of every highway layer packed as [L, C, 2C], and their
        biases as [L, 2C] float32: the highway kernels' layout."""
        w = torch.stack([torch.cat([hw.W1.weight.T, hw.W2.weight.T], dim=1)
                         for hw in self.highways])
        bias = torch.stack([torch.cat([hw.W1.bias, hw.W2.bias])
                            for hw in self.highways]).float()
        return w, bias

    def highway_args(self, a: torch.Tensor, residual: torch.Tensor):
        """Arguments of ``pre_highway_stack`` (and its twin) for [B, T, C_in]
        inputs: rows flattened, the layers as ``highway_weights``."""
        c_in = a.shape[-1]
        return (a.reshape(-1, c_in).contiguous(),
                residual.reshape(-1, c_in).contiguous(),
                self.pre_highway.weight.T.contiguous(),
                *self.highway_weights())

    @staticmethod
    def _mask(x: torch.Tensor, tail: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, T] float32, 1.0 at valid frames."""
        if tail is None:
            return torch.ones(x.shape[:2], device=x.device)
        return (~tail[:, :, 0]).float()

    def _bank(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([conv(x) for conv in self.conv1d_bank], dim=-1)

    def _bank_fused(self, x: torch.Tensor) -> torch.Tensor:
        """The K bank convolutions as one K-tap convolution (the JAX
        ``_bank_fused``): each k-tap kernel zero-embedded at offset
        K//2 - k//2, so every output equals its own convolution's (zero taps
        add exact zeros); then ReLU and the K BatchNorms as one per-channel
        affine at x's dtype."""
        K, t, dt = self.K, x.shape[1], x.dtype
        w = torch.cat([nn.functional.pad(
            m.conv.weight, (K // 2 - k // 2, K - k - (K // 2 - k // 2)))
            for k, m in enumerate(self.conv1d_bank, 1)])     # [K*C, C_in, K]
        y = nn.functional.conv1d(x.transpose(1, 2), w.to(dt),
                                 padding=K // 2)[:, :, :t].transpose(1, 2)
        y = torch.relu(y)

        def cat(name):
            return torch.cat([getattr(m.bnorm, name)
                              for m in self.conv1d_bank]).to(dt)
        return (y - cat('running_mean')) * (
            torch.rsqrt(cat('running_var') + BN_EPS) * cat('weight')) \
            + cat('bias')

    def _proj1_bn_f32(self, y: torch.Tensor) -> torch.Tensor:
        """conv_project1's ReLU and eval BatchNorm on a float32 product, in
        float32 (the JAX order: (y - mean) * (rsqrt(var + eps) * scale) +
        bias)."""
        bn = self.conv_project1.bnorm
        return (torch.relu(y) - bn.running_mean.float()) * (
            torch.rsqrt(bn.running_var.float() + BN_EPS) * bn.weight.float()) \
            + bn.bias.float()

    def _bank_pool_proj1_streamed(self, x: torch.Tensor,
                                  tail: Optional[torch.Tensor]
                                  ) -> torch.Tensor:
        """bank -> pool -> mask -> proj1 one branch at a time (the JAX
        ``_bank_pool_proj1_streamed``): proj1 over the concat is the sum of
        each branch's k=3 convolution with its slice of the kernel, so the
        [B, T, K*C] concat never exists. Each branch's partial is a float32
        product of values in x's dtype, summed in float32; proj1's ReLU and
        BatchNorm run once on the sum, in float32."""
        w1, c = self.conv_project1.conv.weight, self.channels
        acc = None
        for i, conv in enumerate(self.conv1d_bank):
            y = maxpool_time(conv(x))
            if tail is not None:
                y = y.masked_fill(tail, 0.0)
            part = nn.functional.conv1d(
                y.float().transpose(1, 2), w1[:, i * c:(i + 1) * c].float(),
                padding=1).transpose(1, 2)
            acc = part if acc is None else acc + part
        return self._proj1_bn_f32(acc).to(x.dtype)

    def _pool_proj1_fused(self, xc: torch.Tensor,
                          tail: Optional[torch.Tensor]) -> torch.Tensor:
        """pool -> mask -> proj1's convolution on the bank concat as one
        ``pool_proj1`` launch (the JAX ``_pool_proj1_fused``), its output
        in x's dtype; then ReLU and BatchNorm in float32, rounded."""
        y = cbhg_ops.pool_proj1(xc.contiguous(), self._mask(xc, tail),
                                self.proj1_weight())
        return self._proj1_bn_f32(y.float()).to(xc.dtype)

    def _highways_fused(self, x: torch.Tensor) -> torch.Tensor:
        """All highway layers on [B, T, C] as one ``highway_stack`` launch
        (the JAX ``_highways_fused``; as there, ``pre_rnn`` does not call
        it)."""
        b, t, c = x.shape
        y = highway_ops.highway_stack(x.reshape(-1, c).contiguous(),
                                      *self.highway_weights())
        return y.reshape(b, t, c)

    def pre_rnn(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Everything before the bidirectional GRU; see ``forward``."""
        tail = None
        if lengths is not None:
            tail = (torch.arange(x.shape[1], device=x.device)[None, :]
                    >= lengths[:, None])[:, :, None]
            x = x.masked_fill(tail, 0.0)
        residual = x
        infer = not self.training
        if self._takes_kernel(self.front_fusable, self.front_error,
                              'CBHG front (cbhg_front.cu)', x):
            x = cbhg_ops.bank_pool_proj(*self.front_args(x,
                                                         self._mask(x, tail)))
        elif self.stream_pool_proj and infer:
            x = self._bank_pool_proj1_streamed(x, tail)
        elif self._takes_kernel(self.pool_proj_fusable(x.shape[1], x.dtype),
                                None, 'CBHG pool + proj1 (pool.cu)', x):
            x = self._pool_proj1_fused(self._bank(x), tail)
        else:
            x = self._bank_fused(x) if self.fuse_bank and infer \
                else self._bank(x)
            if self.fuse_pool and infer:
                x = cbhg_ops.pool_mask(x.contiguous(), self._mask(x, tail))
            else:
                x = maxpool_time(x)
                if tail is not None:
                    x = x.masked_fill(tail, 0.0)
            x = self.conv_project1(self.drop(x))
        if tail is not None:
            x = x.masked_fill(tail, 0.0)
        x = self.conv_project2(self.drop(x))
        if self._takes_kernel(self.highways_fusable, self.highways_error,
                              'CBHG highway stack (highway.cu)', x):
            y = highway_ops.pre_highway_stack(
                *self.highway_args(x, residual))
            return y.reshape(*x.shape[:2], self.channels)
        x = self.pre_highway(x + residual)
        for hw in self.highways:
            x = hw(x)
        return x

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lengths`` reproduces the reference's exact-length semantics on
        a padded sequence: every convolution input is zeroed beyond the
        item's length and the GRU's backward pass starts at the true last
        frame."""
        return self.rnn(self.pre_rnn(x, lengths), lengths)


def make_len_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True at positions >= length."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            >= lengths[:, None])


# ---------------------------------------------------------------- transformer
#
# The JAX package builds the positional table as a float32 constant, so in
# bfloat16 (variables cast to bfloat16) x + scale * table is float32, and
# every flax layer after it promotes its bfloat16 parameters to the float32
# activation: the transformer computes in float32 with bfloat16-valued
# weights. The modules below promote the same way (:func:`_promoted`).

# flax's LayerNorm epsilon (the reference's torch LayerNorm uses 1e-5)
LN_EPS = 1e-6
# the reference's PositionalEncoding buffer length (state_dict parity only)
PE_MAX_LEN = 5000


def _promoted(x: torch.Tensor, *params: Optional[torch.Tensor]):
    """x and the parameters in the type both promote to, as flax's layers
    promote their inputs and parameters (``dtype=None``)."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return (x.to(dt),) + tuple(None if p is None else p.to(dt)
                               for p in params)


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] float32 sines (even columns) and cosines (odd)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@functools.lru_cache(maxsize=32)
def _table(t: int, d_model: int, device: torch.device) -> torch.Tensor:
    # made outside inference mode even when an inference call asks first:
    # training reads the same cached table, and autograd saves it
    with torch.inference_mode(False):
        return torch.from_numpy(sinusoidal_table(t, d_model)).to(device)


class PositionalEncoding(nn.Module):
    """x + scale * table with a learned scalar scale (reference
    common_layers.py:127-145). The table is built in float32 at the call's
    length, with no 5000-frame cap; its values in the shared range are the
    reference buffer's. The ``pe`` buffer [5000, 1, d] is kept only so
    that the state_dict is the reference's."""

    def __init__(self, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.drop = nn.Dropout(dropout)
        self.scale = nn.Parameter(torch.ones(1))
        self.register_buffer('pe', torch.from_numpy(
            sinusoidal_table(PE_MAX_LEN, d_model))[:, None, :])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = _table(x.shape[1], self.d_model, x.device)
        return self.drop(x + self.scale * pe[None])


def attn_blockwise_threshold() -> int:
    """Sequence length from which deterministic self-attention takes the
    blockwise schedule (:func:`blockwise_attention`); FTT_ATTN_BLOCK_T,
    read at each call, 2048 by default."""
    return int(os.environ.get('FTT_ATTN_BLOCK_T', 2048))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_pad_mask: Optional[torch.Tensor],
                        block_q: int = 512,
                        block_k: int = 512) -> torch.Tensor:
    """Exact softmax attention in O(T) memory: an online softmax (running
    max and denominator in float32) over key blocks, for each block of
    queries; no [B, H, T, T] tensor is made. A row whose keys are all
    padding gives zeros, as the full path does.

    q, k, v: [B, H, T, D]; key_pad_mask: [B, T] bool, True = padding."""
    b, h, t, d = q.shape
    neg = -1e30
    scale = 1.0 / math.sqrt(d)
    if key_pad_mask is None:
        key_pad_mask = torch.zeros(b, t, dtype=torch.bool, device=q.device)
    out = torch.empty_like(q)
    for qs in range(0, t, block_q):
        q_blk = q[:, :, qs:qs + block_q].float()
        m = q_blk.new_full(q_blk.shape[:3], neg)
        l = q_blk.new_zeros(q_blk.shape[:3])
        acc = torch.zeros_like(q_blk)
        for ks in range(0, t, block_k):
            v_b = v[:, :, ks:ks + block_k]
            s = torch.matmul(q_blk, k[:, :, ks:ks + block_k].float()
                             .transpose(-1, -2)) * scale
            s = s.masked_fill(key_pad_mask[:, None, None, ks:ks + block_k],
                              neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(v_b.dtype), v_b).float()
            m = m_new
        out[:, :, qs:qs + block_q] = (
            acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    all_masked = key_pad_mask.all(dim=-1)
    return out.masked_fill(all_masked[:, None, None, None], 0.0)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_pad_mask: Optional[torch.Tensor],
                   dropout: float = 0.0,
                   training: bool = False) -> torch.Tensor:
    """Softmax attention through the [B, H, T, T] weights: padded keys get
    -inf, and a row whose keys are all padding (NaN weights) gives zeros."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if key_pad_mask is not None:
        logits = logits.masked_fill(key_pad_mask[:, None, None, :],
                                    float('-inf'))
    weights = torch.softmax(logits, dim=-1)
    weights = weights.masked_fill(torch.isnan(weights), 0.0)
    weights = nn.functional.dropout(weights, dropout, training)
    return torch.matmul(weights, v)


class MultiHeadAttention(nn.Module):
    """Self-attention with torch ``MultiheadAttention``'s parameters (the
    joint in-projection ``in_proj_weight`` [3d, d] / ``in_proj_bias``, and
    ``out_proj``) and key-padding masking. Deterministic calls at
    :func:`attn_blockwise_threshold` frames or more take
    :func:`blockwise_attention`."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.1):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Dense(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor,
                key_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_heads
        x, w, bias = _promoted(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (nn.functional.linear(x, w, bias)
                   .reshape(b, t, 3, h, d // h).permute(2, 0, 3, 1, 4))
        if not self.training and t >= attn_blockwise_threshold():
            out = blockwise_attention(q, k, v, key_pad_mask)
        else:
            out = full_attention(q, k, v, key_pad_mask, self.dropout,
                                 self.training)
        return linear(out.transpose(1, 2).reshape(b, t, d), self.out_proj)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` on x with its parameters promoted with x (a flax Dense)."""
    x, w, b = _promoted(x, lin.weight, lin.bias)
    return nn.functional.linear(x, w) + b


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``norm`` on x with its parameters promoted with x (a flax
    LayerNorm)."""
    x, w, b = _promoted(x, norm.weight, norm.bias)
    return nn.functional.layer_norm(x, norm.normalized_shape, w, b,
                                    norm.eps)


def conv_same(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """[B, T, C] conv with the module's padding (torch's ``k//2``), cropped
    to T frames (an even kernel gives T + 1), its parameters promoted with
    x (a flax Conv)."""
    t = x.shape[1]
    x, w, b = _promoted(x, conv.weight, conv.bias)
    y = nn.functional.conv1d(x.transpose(1, 2), w,
                             padding=conv.padding)[:, :, :t]
    return (y + b[:, None]).transpose(1, 2)


class FFTBlock(nn.Module):
    """Post-norm transformer block with a convolutional feed-forward
    (reference common_layers.py:148-185)."""

    def __init__(self, d_model: int, n_heads: int, d_fft: int,
                 conv1_kernel: int, conv2_kernel: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.conv1 = nn.Conv1d(d_model, d_fft, conv1_kernel,
                               padding=conv1_kernel // 2)
        self.conv2 = nn.Conv1d(d_fft, d_model, conv2_kernel,
                               padding=conv2_kernel // 2)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                key_pad_mask: Optional[torch.Tensor] = None,
                conv_zero_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``conv_zero_mask`` [B, T] zeroes frames before each convolution,
        so a padded sequence gives the convolution outputs of the
        reference's exact-length run."""
        x = layer_norm(x + self.drop(self.self_attn(x, key_pad_mask)),
                        self.norm1)
        zero = None if conv_zero_mask is None else conv_zero_mask[:, :, None]
        y = x if zero is None else x.masked_fill(zero, 0.0)
        y = torch.relu(conv_same(y, self.conv1))
        if zero is not None:
            y = y.masked_fill(zero, 0.0)
        y = conv_same(y, self.conv2)
        return layer_norm(x + self.drop(y), self.norm2)


class ForwardTransformer(nn.Module):
    """Positional encoding, ``layers`` FFT blocks and a final LayerNorm
    (reference common_layers.py:188-223)."""

    def __init__(self, d_model: int, d_fft: int, layers: int, heads: int,
                 conv1_kernel: int, conv2_kernel: int, dropout: float = 0.1):
        super().__init__()
        self.pos_encoder = PositionalEncoding(d_model, dropout)
        self.layers = nn.ModuleList([
            FFTBlock(d_model, heads, d_fft, conv1_kernel, conv2_kernel,
                     dropout) for _ in range(layers)])
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                key_pad_mask: Optional[torch.Tensor] = None,
                conv_zero_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.pos_encoder(x)
        for layer in self.layers:
            x = layer(x, key_pad_mask, conv_zero_mask)
        return layer_norm(x, self.norm)


def make_token_pad_mask(x: torch.Tensor) -> torch.Tensor:
    """[B, N] tokens -> [B, N] bool, True at padding (token id 0)."""
    return x == 0
