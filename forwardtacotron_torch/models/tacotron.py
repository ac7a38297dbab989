"""Tacotron teacher: the autoregressive attention model whose alignments
give the forward models their phoneme durations (never used to
synthesize for users).

Port of forwardtacotron_tpu/models/tacotron.py (reference
models/tacotron.py:12-374). The JAX package's decoder is a ``lax.scan``;
here it is a per-step loop over the same step: the attention GRU cell, the
location-sensitive attention over the encoder's projections, two residual
LSTM cells with zoneout, and the mel projection over ``MAX_R`` outputs of
which the first r are used. As in the JAX package the decoder PreNet has
no recurrent input, so the teacher-forced forward runs it over all steps
at once, and the mel projection runs once over all steps after the loop.

Dtypes follow the JAX package's promotion rules. The decoder's carry
starts in float32, so the decoder computes in float32 whatever the
parameters' dtype (bf16 parameters are promoted, exactly), with the
PreNet's outputs and the encoder's projections in the parameters' dtype.
The teacher-forced forward hands the postnet that float32 mel, and the
postnet then computes in float32 with its parameters promoted, as flax's
layers promote them; ``generate`` rounds each step's frames to the
parameters' dtype, so a bf16 model's postnet runs in bf16.

The two CBHGs (encoder and postnet) take the CBHG front and highway
kernels in eval mode (``models.layers.CBHG``), and their bidirectional
GRUs always take the per-step loop: the JAX teacher never enters
``pallas_rnns``, so its GRUs always scan, whatever the dtype, and the port
routes alike whatever ``rnn_train.rnn_mode`` is set around a call.

Randomness (the PreNets' dropout, the decoder's zoneout) is drawn from the
``torch.Generator`` a caller passes (``generator=``; None draws from
torch's default generator of the device). The CBHGs' dropout in training
is ``nn.Dropout``, drawn from torch's default generator. The PreNet's
dropout follows ``prenet_dropout_on``, which duration extraction forces on
in eval (reference train_tacotron.py:120).
"""

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from forwardtacotron_torch.models.layers import CBHG, Dense
from forwardtacotron_torch.ops.hopper import rnn_train
from forwardtacotron_torch.text.symbols import phonemes

# static width of the mel projection (reference tacotron.py:105)
MAX_R = 20
# the JAX package's fixed rates: the PreNets' dropout and the zoneout of
# the residual LSTM cells
PRENET_DROPOUT = 0.5
ZONEOUT = 0.1
# the carry's dtype: the JAX package starts it as float32 zeros
CARRY_DTYPE = torch.float32


def _linear(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T, then + bias, in the dtype x and the parameters
    promote to (flax's ``nn.Dense`` and ``x @ w + b``)."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = nn.functional.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


def _dropout(x: torch.Tensor, p: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's Dropout: keep with probability 1 - p, scaled by 1 / (1 - p)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def _zoneout(prev: torch.Tensor, current: torch.Tensor, p: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each unit's previous state with probability p."""
    mask = torch.rand(prev.shape, generator=generator,
                      device=prev.device) < p
    return torch.where(mask, prev, current)


class _Cell(nn.Module):
    """Parameters of a torch GRUCell / LSTMCell under the reference's
    names, in torch gate order, initialized U(-1/sqrt(H), 1/sqrt(H))."""

    def __init__(self, input_size: int, hidden: int, n_gates: int):
        super().__init__()
        self.hidden = hidden
        g = n_gates * hidden
        self.weight_ih = nn.Parameter(torch.empty(g, input_size))
        self.weight_hh = nn.Parameter(torch.empty(g, hidden))
        self.bias_ih = nn.Parameter(torch.empty(g))
        self.bias_hh = nn.Parameter(torch.empty(g))
        bound = 1.0 / math.sqrt(hidden)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)


class GRUCellP(_Cell):
    """One GRU step, gates r, z, n (the JAX package's ``GRUCellP``)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__(input_size, hidden, 3)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        xr, xz, xn = _linear(x, self.weight_ih, self.bias_ih).chunk(3, -1)
        hr, hz, hn = _linear(h, self.weight_hh, self.bias_hh).chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


class LSTMCellP(_Cell):
    """One LSTM step, gates i, f, g, o (the JAX package's ``LSTMCellP``)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__(input_size, hidden, 4)

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        gates = (_linear(x, self.weight_ih, self.bias_ih)
                 + _linear(h, self.weight_hh)
                 + self.bias_hh.to(h.dtype))
        i, f, g, o = gates.chunk(4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new


class PreNet(nn.Module):
    """2 x (Dense -> ReLU -> dropout) (reference tacotron.py:29-43); the
    dropout is applied where ``dropout_on`` says, at rate ``dropout``."""

    def __init__(self, in_dims: int, fc1_dims: int = 256,
                 fc2_dims: int = 128, dropout: float = PRENET_DROPOUT):
        super().__init__()
        self.fc1 = Dense(in_dims, fc1_dims)
        self.fc2 = Dense(fc1_dims, fc2_dims)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, dropout_on: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for fc in (self.fc1, self.fc2):
            x = torch.relu(fc(x))
            if dropout_on and self.dropout > 0:
                x = _dropout(x, self.dropout, generator)
        return x


class Encoder(nn.Module):
    """Embedding -> PreNet -> CBHG (reference tacotron.py:46-62). The CBHG
    keeps its own dropout of 0.5, as in the JAX package."""

    def __init__(self, embed_dims: int, num_chars: int, cbhg_channels: int,
                 K: int, num_highways: int):
        super().__init__()
        self.embedding = nn.Embedding(num_chars, embed_dims)
        self.pre_net = PreNet(embed_dims)
        self.cbhg = CBHG(K=K, in_channels=self.pre_net.fc2.out_features,
                         channels=cbhg_channels,
                         proj_channels=[cbhg_channels, cbhg_channels],
                         num_highways=num_highways)

    def forward(self, x: torch.Tensor, train: bool = False,
                x_lens: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.pre_net(self.embedding(x), dropout_on=train,
                         generator=generator)
        return self.cbhg(h, lengths=x_lens)


class LSA(nn.Module):
    """Location-sensitive attention (reference tacotron.py:65-99): energies
    from the query, the encoder's projection and a convolution over the
    (cumulative, previous) attention maps. The maps live in the decoder's
    carry."""

    def __init__(self, attn_dim: int, kernel_size: int = 31,
                 filters: int = 32):
        super().__init__()
        self.conv = nn.Conv1d(2, filters, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.L = Dense(filters, attn_dim)
        self.W = Dense(attn_dim, attn_dim)
        self.v = Dense(attn_dim, 1, bias=False)

    def forward(self, encoder_seq_proj: torch.Tensor, query: torch.Tensor,
                cumulative: torch.Tensor, attention: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, N] attention weights; ``token_mask`` [B, N] (True at padded
        tokens) gives those tokens no mass."""
        location = torch.stack([cumulative, attention], dim=1)   # [B, 2, N]
        loc = nn.functional.conv1d(
            location, self.conv.weight.to(location.dtype),
            padding=self.conv.padding).transpose(1, 2)           # [B, N, F]
        processed_loc = _linear(loc, self.L.weight, self.L.bias)
        processed_query = _linear(query, self.W.weight,
                                  self.W.bias)[:, None, :]
        u = _linear(torch.tanh(processed_query + encoder_seq_proj
                               + processed_loc), self.v.weight)[..., 0]
        if token_mask is not None:
            u = u.masked_fill(token_mask, -1e9)
        return torch.softmax(u, dim=1)


class Decoder(nn.Module):
    """One decode step (reference tacotron.py:102-170): attention GRU, LSA,
    context, two residual LSTM cells with zoneout in training. The mel
    projection (``project``) runs outside the step."""

    def __init__(self, n_mels: int, decoder_dims: int, lstm_dims: int):
        super().__init__()
        self.n_mels = n_mels
        self.prenet = PreNet(n_mels)
        self.attn_net = LSA(decoder_dims)
        self.attn_rnn = GRUCellP(decoder_dims + self.prenet.fc2.out_features,
                                 decoder_dims)
        self.rnn_input = Dense(2 * decoder_dims, lstm_dims)
        self.res_rnn1 = LSTMCellP(lstm_dims, lstm_dims)
        self.res_rnn2 = LSTMCellP(lstm_dims, lstm_dims)
        self.mel_proj = Dense(lstm_dims, n_mels * MAX_R, bias=False)
        # the reduction factor of the last training session (reference
        # buffer; the port passes r to every call)
        self.register_buffer('r', torch.tensor(1, dtype=torch.int32))
        self.zoneout = ZONEOUT

    def forward(self, carry: Dict[str, torch.Tensor],
                prenet_out: torch.Tensor, encoder_seq: torch.Tensor,
                encoder_seq_proj: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None,
                zoneout_on: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                           torch.Tensor]:
        """(new carry, the step's [B, lstm_dims] output before the mel
        projection, [B, N] attention). ``encoder_seq`` and
        ``encoder_seq_proj`` in the carry's dtype."""
        attn_rnn_in = torch.cat([carry['context'],
                                 prenet_out.to(carry['context'].dtype)], -1)
        attn_hidden = self.attn_rnn(attn_rnn_in, carry['attn_hidden'])
        scores = self.attn_net(encoder_seq_proj, attn_hidden,
                               carry['cumulative'], carry['attention'],
                               token_mask)
        cumulative = carry['cumulative'] + scores
        context = torch.bmm(scores[:, None, :], encoder_seq)[:, 0]
        x = _linear(torch.cat([context, attn_hidden], -1),
                    self.rnn_input.weight, self.rnn_input.bias)
        h1, c1 = self.res_rnn1(x, carry['h1'], carry['c1'])
        if zoneout_on:
            h1 = _zoneout(carry['h1'], h1, self.zoneout, generator)
        x = x + h1
        h2, c2 = self.res_rnn2(x, carry['h2'], carry['c2'])
        if zoneout_on:
            h2 = _zoneout(carry['h2'], h2, self.zoneout, generator)
        x = x + h2
        new_carry = {'attn_hidden': attn_hidden, 'h1': h1, 'c1': c1,
                     'h2': h2, 'c2': c2, 'context': context,
                     'cumulative': cumulative, 'attention': scores}
        return new_carry, x, scores

    def project(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """[..., lstm_dims] -> [..., n_mels, r]: the first r of the MAX_R
        frames of ``mel_proj`` (only their rows of the weight are
        multiplied; each output is the same dot product)."""
        w = self.mel_proj.weight.view(self.n_mels, MAX_R, -1)[:, :r]
        y = _linear(x, w.reshape(self.n_mels * r, -1))
        return y.view(*x.shape[:-1], self.n_mels, r)


class Tacotron(nn.Module):

    def __init__(self, embed_dims: int = 256, num_chars: int = len(phonemes),
                 encoder_dims: int = 128, decoder_dims: int = 256,
                 n_mels: int = 80, postnet_dims: int = 128,
                 encoder_k: int = 16, lstm_dims: int = 512,
                 postnet_k: int = 8, num_highways: int = 4,
                 dropout: float = 0.5, stop_threshold: float = -11.0,
                 speaker_emb_dim: int = 256):
        """``dropout`` is accepted for the config's sake and unused: the
        JAX package's CBHGs keep their own 0.5 and the PreNets 0.5."""
        super().__init__()
        self.n_mels = n_mels
        self.decoder_dims = decoder_dims
        self.lstm_dims = lstm_dims
        self.speaker_emb_dim = speaker_emb_dim
        self.encoder = Encoder(embed_dims, num_chars, encoder_dims,
                               encoder_k, num_highways)
        enc_out = 2 * encoder_dims + speaker_emb_dim
        self.encoder_proj_query = Dense(enc_out, decoder_dims, bias=False)
        self.encoder_proj = Dense(enc_out, decoder_dims, bias=False)
        self.decoder = Decoder(n_mels, decoder_dims, lstm_dims)
        # the reference hard-codes proj_channels=[256, 80]; [256, n_mels]
        # is the same at 80 mels (the residual needs n_mels at the end)
        self.postnet = CBHG(K=postnet_k, in_channels=n_mels,
                            channels=postnet_dims,
                            proj_channels=[256, n_mels],
                            num_highways=num_highways)
        self.post_proj = Dense(2 * postnet_dims, n_mels, bias=False)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.register_buffer('stop_threshold', torch.tensor(
            float(stop_threshold), dtype=torch.float32))

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'Tacotron':
        model_config = dict(config['tacotron']['model'])
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config)

    # ----------------------------------------------------------------- parts

    def _encode(self, x: torch.Tensor, speaker_emb: Optional[torch.Tensor],
                train: bool, x_lens: Optional[torch.Tensor],
                generator: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(proj_query, proj), [B, N, decoder_dims] each, in the
        parameters' dtype; the speaker embedding (rounded to that dtype)
        tiled onto every token where ``speaker_emb_dim`` > 0."""
        with rnn_train.rnn_mode('off'):
            seq = self.encoder(x, train, x_lens, generator)
        if self.speaker_emb_dim > 0:
            tiled = speaker_emb.to(seq.dtype)[:, None, :].expand(
                x.shape[0], seq.shape[1], -1)
            seq = torch.cat([seq, tiled], -1)
        return self.encoder_proj_query(seq), self.encoder_proj(seq)

    def _init_carry(self, b: int, n: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
        def z(width):
            return torch.zeros(b, width, dtype=CARRY_DTYPE, device=device)
        return {'attn_hidden': z(self.decoder_dims), 'h1': z(self.lstm_dims),
                'c1': z(self.lstm_dims), 'h2': z(self.lstm_dims),
                'c2': z(self.lstm_dims), 'context': z(self.decoder_dims),
                'cumulative': z(n), 'attention': z(n)}

    def _post(self, mel: torch.Tensor) -> torch.Tensor:
        """postnet -> post_proj. A mel of a wider dtype than the parameters
        (the float32 mel of a bf16 model's teacher-forced forward) runs
        the postnet with its parameters promoted to it, as flax promotes
        them; the BatchNorm statistics stay the module's own, so training
        updates them."""
        p_dtype = self.post_proj.weight.dtype
        with rnn_train.rnn_mode('off'):
            if mel.dtype == p_dtype:
                post = self.postnet(mel)
            else:
                dt = torch.promote_types(mel.dtype, p_dtype)
                params = {k: p.to(dt)
                          for k, p in self.postnet.named_parameters()}
                post = torch.func.functional_call(self.postnet, params,
                                                  (mel.to(dt),))
        return _linear(post, self.post_proj.weight)

    # ---------------------------------------------------------------- forward

    def forward(self, batch: Dict[str, torch.Tensor], r: int,
                train: Optional[bool] = None,
                prenet_dropout_on: Optional[bool] = None,
                x_lens: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Teacher-forced forward (reference tacotron.py:219-281).

        ``batch['mel']`` is [B, T, n_mels] with T divisible by r. Returns
        (mel [B, T, n_mels], linear [B, T, n_mels], attention [B, T // r,
        N]). ``train`` (default: the module's mode, which it must equal)
        turns on the dropouts and zoneout; ``prenet_dropout_on`` (default
        ``train``) the decoder PreNet's dropout alone. ``x_lens`` masks
        padded tokens in the encoder and the attention."""
        train = self.training if train is None else train
        if train != self.training:
            raise ValueError(f'train={train} but the module is in '
                             f'{"training" if self.training else "eval"} '
                             'mode; set it with .train() / .eval()')
        if prenet_dropout_on is None:
            prenet_dropout_on = train
        x, mel = batch['x'], batch['mel']
        b, t, _ = mel.shape
        n = x.shape[1]
        proj_query, proj = self._encode(x, batch.get('speaker_emb'), train,
                                        x_lens, generator)
        token_mask = None if x_lens is None else (
            torch.arange(n, device=x.device)[None, :] >= x_lens[:, None])
        steps = t // r
        # teacher forcing: each step sees the last frame of the previous
        # step, the first a zero frame
        prenet_ins = torch.cat([mel.new_zeros(1, b, self.n_mels),
                                mel[:, r - 1:(steps - 1) * r:r].transpose(0, 1)])
        prenet_outs = self.decoder.prenet(prenet_ins,
                                          dropout_on=prenet_dropout_on,
                                          generator=generator)
        enc, enc_proj = proj_query.to(CARRY_DTYPE), proj.to(CARRY_DTYPE)
        carry = self._init_carry(b, n, x.device)
        outs, attns = [], []
        for s in range(steps):
            carry, out, scores = self.decoder(carry, prenet_outs[s], enc,
                                              enc_proj, token_mask,
                                              zoneout_on=train,
                                              generator=generator)
            outs.append(out)
            attns.append(scores)
        # [S, B, n_mels, r] -> [B, S * r, n_mels]
        mel_out = self.decoder.project(torch.stack(outs), r).permute(
            1, 0, 3, 2).reshape(b, steps * r, self.n_mels)
        return mel_out, self._post(mel_out), torch.stack(attns, 1)

    def generate(self, x: torch.Tensor,
                 speaker_emb: Optional[torch.Tensor] = None,
                 steps: int = 2000, r: int = 1, chunk: int = 32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """Free-running generation with the silence stop flag (reference
        tacotron.py:283-349). Returns (mel [B, steps // r * r, n_mels],
        linear, attention [B, steps // r, N], n_valid [B] steps).

        An item finishes at the first step after step 10 (in frames) whose
        r frames are all below ``stop_threshold``; ``n_valid`` counts its
        steps up to and including that one. Whether every item has
        finished is read once per ``chunk`` steps, and decoding stops at
        the end of the first chunk where they all have: frames after it
        are zeros, as are the JAX package's; frames between an item's
        ``n_valid`` and that point are what it kept decoding."""
        b, n = x.shape
        proj_query, proj = self._encode(x, speaker_emb, False, None, None)
        cdtype = proj_query.dtype
        s_req = steps // r
        n_chunks = -(-s_req // chunk)
        stop = float(self.stop_threshold)
        enc, enc_proj = proj_query.to(CARRY_DTYPE), proj.to(CARRY_DTYPE)
        carry = self._init_carry(b, n, x.device)
        prev_frame = torch.zeros(b, self.n_mels, dtype=cdtype,
                                 device=x.device)
        finished = torch.zeros(b, dtype=torch.bool, device=x.device)
        n_valid = torch.zeros(b, dtype=torch.int32, device=x.device)
        mels, attns = [], []
        for i in range(n_chunks):
            for j in range(chunk):
                t = i * chunk + j
                prenet_out = self.decoder.prenet(prev_frame)
                carry, out, scores = self.decoder(carry, prenet_out, enc,
                                                  enc_proj)
                frames = self.decoder.project(out, r).to(cdtype)
                silent = torch.all(frames < stop, dim=2).all(dim=1)
                n_valid = torch.where(finished, n_valid, n_valid + 1)
                finished = finished | (silent & (t * r > 10))
                prev_frame = frames[:, :, -1]
                mels.append(frames)
                attns.append(scores.to(cdtype))
            if bool(finished.all()):
                break
        mel_steps = torch.stack(mels)[:s_req]            # [S, B, n_mels, r]
        attn = torch.stack(attns, 1)[:, :s_req]
        if len(mels) < s_req:
            pad = s_req - len(mels)
            mel_steps = torch.cat([mel_steps, mel_steps.new_zeros(
                pad, *mel_steps.shape[1:])])
            attn = torch.cat([attn, attn.new_zeros(b, pad, n)], 1)
        mel_out = mel_steps.permute(1, 0, 3, 2).reshape(b, s_req * r,
                                                        self.n_mels)
        return (mel_out, self._post(mel_out), attn,
                torch.clamp(n_valid, max=s_req))
