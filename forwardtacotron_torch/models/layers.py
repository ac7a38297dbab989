"""Core blocks of the serving path, as PyTorch modules.

Port of the inference subset of forwardtacotron_tpu/models/layers.py:
BatchNormConv (ReLU before BN), HighwayNetwork, the bidirectional GRU/LSTM
with exact-length semantics, the frame trunk and CBHG. Public functions keep
the JAX package's batch-first channels-last [B, T, C] layout; parameter
names are the reference's state_dict names, so reference checkpoints load
with ``load_state_dict``.

The slice is inference-only: BatchNorm always normalizes with its running
statistics and dropout is the identity.
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from forwardtacotron_torch.ops.hopper.cbhg import bank_pool_proj
from forwardtacotron_torch.ops.hopper.highway import pre_highway_stack
from forwardtacotron_torch.ops.length_regulator import length_regulator

BN_EPS = 1e-5


def conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """[B, T, C] conv with torch's ``padding=k//2``; an even kernel emits
    T+1 frames, truncated to T."""
    t = x.shape[1]
    return conv(x.transpose(1, 2))[:, :, :t].transpose(1, 2)


class BatchNormConv(nn.Module):
    """Conv (no bias) -> optional ReLU -> eval BatchNorm. The ReLU runs
    BEFORE the norm, as in the reference."""

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
        return (x - bn.running_mean) * (torch.rsqrt(bn.running_var + BN_EPS)
                                        * bn.weight) + bn.bias

    def folded_bn(self):
        """(scale', bias') with BN(y) = y * scale' + bias'."""
        bn = self.bnorm
        s = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        return s, bn.bias - bn.running_mean * s


class HighwayNetwork(nn.Module):
    """y = g * relu(W1 x) + (1 - g) * x, g = sigmoid(W2 x)."""

    def __init__(self, size: int):
        super().__init__()
        self.W1 = nn.Linear(size, size)
        self.W2 = nn.Linear(size, size)

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


def _bidir_scan(x: torch.Tensor, lengths: Optional[torch.Tensor],
                rnn: '_BiRNN', step_fn, n_carry: int) -> torch.Tensor:
    """[B, T, I] -> [B, T, 2H]: both directions advance together as a batch
    axis of one loop over time; with ``lengths`` the backward direction
    starts at each item's true last frame."""
    b, t, _ = x.shape
    xp = torch.stack([
        x @ rnn.weight_ih_l0.T + rnn.bias_ih_l0,
        flip_sequences(x, lengths) @ rnn.weight_ih_l0_reverse.T
        + rnn.bias_ih_l0_reverse])                      # [2, B, T, G]
    wh = torch.stack([rnn.weight_hh_l0.T, rnn.weight_hh_l0_reverse.T])
    bh = torch.stack([rnn.bias_hh_l0, rnn.bias_hh_l0_reverse])[:, None]
    zeros = x.new_zeros(2, b, rnn.hidden)
    carry = tuple(zeros for _ in range(n_carry))
    hs = []
    for step in range(t):
        carry, h = step_fn(carry, xp[:, :, step], wh, bh)
        hs.append(h)
    hs = torch.stack(hs, dim=2)                         # [2, B, T, H]
    return torch.cat([hs[0], flip_sequences(hs[1], lengths)], dim=-1)


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


def frame_trunk(h: torch.Tensor, dur: torch.Tensor, lengths: torch.Tensor,
                max_len: int, lstm: BiLSTM, lin: nn.Linear) -> torch.Tensor:
    """Frame-rate trunk: length regulator -> bi-LSTM -> mel Linear."""
    h = length_regulator(h, dur, max_len)
    h = lstm(h, lengths=lengths)
    return lin(h)


# ----------------------------------------------------------------------- CBHG


def maxpool_time(x: torch.Tensor) -> torch.Tensor:
    """MaxPool1d(kernel=2, stride=1, padding=1) over time truncated to T:
    out[t] = max(x[t-1], x[t]) with a -inf left pad."""
    neg = x.new_full((x.shape[0], 1, x.shape[2]), float('-inf'))
    return torch.maximum(torch.cat([neg, x[:, :-1]], dim=1), x)


# The JAX package sends a CBHG front to its fused kernel only when the bank
# and proj1 weights fit one VMEM-resident dispatch (10 MB as bf16). That
# budget is a TPU limit, but it is what routes the K=8 postnet front to the
# kernel and keeps the K=16 prenet front on plain convolutions; the port
# routes the same way until the prenet front is measured on the card.
FRONT_WEIGHT_BUDGET = 10 * 2 ** 20


def _front_fits_one_dispatch(k_max: int, c_in: int, c: int, p: int) -> bool:
    return 2 * (k_max * (k_max + 1) // 2 * c_in * c
                + 3 * k_max * c * p) <= FRONT_WEIGHT_BUDGET


class CBHG(nn.Module):
    """Conv bank (k=1..K) -> maxpool -> 2 projections -> residual ->
    highway stack -> bidirectional GRU (reference common_layers.py:60-124).

    Inference routes the front (bank .. proj1) to the ``cbhg_front`` kernel
    and residual + pre_highway + highways to the ``pre_highway_stack``
    kernel where the JAX package's gates send them to Pallas."""

    def __init__(self, K: int, in_channels: int, channels: int,
                 proj_channels: Sequence[int], num_highways: int):
        super().__init__()
        self.K = K
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
        self.front_fusable = _front_fits_one_dispatch(
            K, in_channels, channels, proj_channels[0])
        # the JAX gate's lane-alignment test, kept so both route alike
        self.highways_fusable = bool(num_highways) and channels % 128 == 0

    def front_args(self, x: torch.Tensor, mask: torch.Tensor):
        """Arguments of ``bank_pool_proj`` (and its twin) for this front:
        conv weights as [k, C_in, C] / [3, K*C, P], BatchNorms folded."""
        folded = [m.folded_bn() for m in self.conv1d_bank]
        p_s, p_b = self.conv_project1.folded_bn()
        return (x.contiguous(), mask.contiguous(),
                [m.conv.weight.permute(2, 1, 0).contiguous()
                 for m in self.conv1d_bank],
                torch.stack([f[0] for f in folded]),
                torch.stack([f[1] for f in folded]),
                self.conv_project1.conv.weight.permute(2, 1, 0).contiguous(),
                p_s.contiguous(), p_b.contiguous())

    def highway_args(self, a: torch.Tensor, residual: torch.Tensor):
        """Arguments of ``pre_highway_stack`` (and its twin) for [B, T, C_in]
        inputs: rows flattened, W1 | W2 packed as [L, C, 2C]."""
        c_in = a.shape[-1]
        w = torch.stack([torch.cat([hw.W1.weight.T, hw.W2.weight.T], dim=1)
                         for hw in self.highways])
        bias = torch.stack([torch.cat([hw.W1.bias, hw.W2.bias])
                            for hw in self.highways])
        return (a.reshape(-1, c_in).contiguous(),
                residual.reshape(-1, c_in).contiguous(),
                self.pre_highway.weight.T.contiguous(), w, bias)

    def pre_rnn(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Everything before the bidirectional GRU; see ``forward``."""
        tail = None
        if lengths is not None:
            tail = (torch.arange(x.shape[1], device=x.device)[None, :]
                    >= lengths[:, None])[:, :, None]
            x = x.masked_fill(tail, 0.0)
        residual = x
        if self.front_fusable:
            mask = (torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
                    if tail is None else (~tail[:, :, 0]).to(x.dtype))
            x = bank_pool_proj(*self.front_args(x, mask))
        else:
            x = torch.cat([conv(x) for conv in self.conv1d_bank], dim=-1)
            x = maxpool_time(x)
            if tail is not None:
                x = x.masked_fill(tail, 0.0)
            x = self.conv_project1(x)
        if tail is not None:
            x = x.masked_fill(tail, 0.0)
        x = self.conv_project2(x)
        if self.highways_fusable:
            y = pre_highway_stack(*self.highway_args(x, residual))
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
