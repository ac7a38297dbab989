"""ForwardTacotron: the teacher-forced training forward and the serving
path (generate mode).

Port of forwardtacotron_tpu/models/forward_tacotron.py: the series
predictors, the training ``forward(batch)`` with its pack_padded decode,
``predict_series`` with the all-zero-duration guard, ``generate``, the
single-call ``generate_combined`` and the generate-mode decode. Module
names are the reference's, so ``state_dict()`` has exactly the keys and
shapes of the published checkpoints (dropout has no parameters). Mel
tensors are [B, T, n_mels].
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from forwardtacotron_torch.models.layers import (CBHG, BatchNormConv, BiGRU,
                                                 BiLSTM, Conv, Dense, conv1d,
                                                 frame_trunk, make_len_mask,
                                                 multi_bigru)
from forwardtacotron_torch.ops.length_regulator import (expanded_lengths,
                                                        length_regulator)
from forwardtacotron_torch.parallel.mesh import global_max
from forwardtacotron_torch.text.symbols import phonemes

PAD_VALUE = -11.5129


class SeriesPredictor(nn.Module):
    """Duration/pitch/energy predictor: embed -> 3x(conv+BN+dropout) ->
    biGRU -> linear (reference forward_tacotron.py:14-39)."""

    def __init__(self, num_chars: int, emb_dim: int = 64,
                 conv_dims: int = 256, rnn_dims: int = 64,
                 dropout: float = 0.5):
        super().__init__()
        self.drop = nn.Dropout(dropout)
        self.embedding = nn.Embedding(num_chars, emb_dim)
        self.convs = nn.ModuleList([
            BatchNormConv(emb_dim if i == 0 else conv_dims, conv_dims, 5)
            for i in range(3)])
        self.rnn = BiGRU(conv_dims, rnn_dims)
        self.lin = Dense(2 * rnn_dims, 1)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Embedding and conv stack (the part before the GRU)."""
        x = self.embedding(x)
        for conv in self.convs:
            x = self.drop(conv(x))
        return x

    def head(self, rnn_out: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        return self.lin(rnn_out) / alpha

    def forward(self, x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        return self.head(self.rnn(self.features(x)), alpha)


def guard_durations(dur: torch.Tensor) -> torch.Tensor:
    """If the truncated durations of the whole batch sum to <= 0, every
    duration becomes 2 frames (reference forward_tacotron.py:176-177)."""
    total = torch.trunc(dur).to(torch.int64).sum()
    return torch.where(total <= 0, torch.full_like(dur, 2.0), dur)


def decode_frames(model: nn.Module, h: torch.Tensor, dur: torch.Tensor,
                  pitch: torch.Tensor, energy: torch.Tensor, max_len: int,
                  mel_lens: Optional[torch.Tensor] = None):
    """The decode after the prenet, shared by ForwardTacotron and
    MultiForwardTacotron (``model`` holds pitch_proj, energy_proj, lstm,
    lin, postnet, post_proj, the strengths and padding_value): the series
    projections, then the frames.

    Teacher-forced mode (``mel_lens`` given) reproduces the reference's
    pack_padded decode: the LSTM's backward pass starts at each item's
    true last frame and its padded frames carry ``padding_value`` into the
    mel Linear; the postnet sees the batch's longest ``mel_lens`` frames
    (the global batch's in a data-parallel step), those beyond it zero,
    and they come out as ``padding_value``. Generate
    mode: per-item expanded lengths steer the LSTM and postnet-GRU flips,
    and frames past them are zeroed so convolution boundaries match the
    reference's exact-length zero padding."""
    m = model
    h = h + conv1d(pitch[:, :, None], m.pitch_proj) * m.pitch_strength
    h = h + conv1d(energy[:, :, None], m.energy_proj) * m.energy_strength
    if mel_lens is not None:
        h = m.lstm(length_regulator(h, dur, max_len), lengths=mel_lens)
        h = h.masked_fill(make_len_mask(mel_lens, max_len)[:, :, None],
                          m.padding_value)
        raw = m.lin(h)
        batch_max = global_max(mel_lens.max())
        beyond = (torch.arange(max_len, device=h.device)
                  >= batch_max)[None, :, None]
        post = m.postnet(raw.masked_fill(beyond, 0.0),
                         lengths=batch_max.expand(h.shape[0]))
        mel = raw.masked_fill(beyond, m.padding_value)
        mel_post = m.post_proj(post).masked_fill(beyond, m.padding_value)
        return mel, mel_post
    lengths = expanded_lengths(dur)
    raw = frame_trunk(h, dur, lengths, max_len, m.lstm, m.lin)
    tail = make_len_mask(lengths, max_len)[:, :, None]
    mel = raw.masked_fill(tail, 0.0)
    post = m.postnet(mel, lengths=lengths)
    mel_post = m.post_proj(post).masked_fill(tail, 0.0)
    return mel, mel_post


class ForwardTacotron(nn.Module):

    def __init__(self, embed_dims: int = 256, series_embed_dims: int = 64,
                 num_chars: int = len(phonemes),
                 durpred_conv_dims: int = 256, durpred_rnn_dims: int = 64,
                 durpred_dropout: float = 0.5,
                 pitch_conv_dims: int = 256, pitch_rnn_dims: int = 128,
                 pitch_dropout: float = 0.5, pitch_strength: float = 1.0,
                 energy_conv_dims: int = 256, energy_rnn_dims: int = 64,
                 energy_dropout: float = 0.5, energy_strength: float = 1.0,
                 rnn_dims: int = 512, prenet_dims: int = 256,
                 prenet_k: int = 16, prenet_num_highways: int = 4,
                 prenet_dropout: float = 0.5,
                 postnet_dims: int = 256, postnet_k: int = 8,
                 postnet_num_highways: int = 4, postnet_dropout: float = 0.0,
                 n_mels: int = 80, padding_value: float = PAD_VALUE):
        super().__init__()
        self.pitch_strength = pitch_strength
        self.energy_strength = energy_strength
        self.padding_value = padding_value
        self.embedding = nn.Embedding(num_chars, embed_dims)
        self.dur_pred = SeriesPredictor(num_chars, series_embed_dims,
                                        durpred_conv_dims, durpred_rnn_dims,
                                        durpred_dropout)
        self.pitch_pred = SeriesPredictor(num_chars, series_embed_dims,
                                          pitch_conv_dims, pitch_rnn_dims,
                                          pitch_dropout)
        self.energy_pred = SeriesPredictor(num_chars, series_embed_dims,
                                           energy_conv_dims, energy_rnn_dims,
                                           energy_dropout)
        self.prenet = CBHG(K=prenet_k, in_channels=embed_dims,
                           channels=prenet_dims,
                           proj_channels=[prenet_dims, embed_dims],
                           num_highways=prenet_num_highways,
                           dropout=prenet_dropout)
        self.lstm = BiLSTM(2 * prenet_dims, rnn_dims)
        self.lin = Dense(2 * rnn_dims, n_mels)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.postnet = CBHG(K=postnet_k, in_channels=n_mels,
                            channels=postnet_dims,
                            proj_channels=[postnet_dims, n_mels],
                            num_highways=postnet_num_highways,
                            dropout=postnet_dropout)
        self.post_proj = nn.Linear(2 * postnet_dims, n_mels, bias=False)
        self.pitch_proj = Conv(1, 2 * prenet_dims, kernel_size=3, padding=1)
        self.energy_proj = Conv(1, 2 * prenet_dims, kernel_size=3, padding=1)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward (the JAX ``__call__``, reference
        forward_tacotron.py:118-165): batch holds x [B, N] tokens, dur, pitch
        and energy [B, N], mel_len [B] and mel [B, T, n_mels], of which only
        the length T is used. Training mode (``train()``) uses batch
        statistics and dropout, eval mode neither."""
        x = batch['x']
        dur_hat = self.dur_pred(x)[..., 0]
        pitch_hat = self.pitch_pred(x)[..., 0]
        energy_hat = self.energy_pred(x)[..., 0]
        mel, mel_post = self._decode(x, batch['dur'], batch['pitch'],
                                     batch['energy'], batch['mel'].shape[1],
                                     batch['mel_len'])
        return {'mel': mel, 'mel_post': mel_post, 'dur': dur_hat,
                'pitch': pitch_hat, 'energy': energy_hat}

    def predict_series(self, x: torch.Tensor, alpha: float = 1.0
                       ) -> Dict[str, torch.Tensor]:
        """Phase 1 of generation: durations, pitch and energy from
        tokens."""
        dur = guard_durations(self.dur_pred(x, alpha=alpha)[..., 0])
        return {'dur': dur,
                'pitch': self.pitch_pred(x)[..., 0],
                'energy': self.energy_pred(x)[..., 0]}

    def generate(self, x: torch.Tensor, dur: torch.Tensor,
                 pitch: torch.Tensor, energy: torch.Tensor,
                 max_len: int) -> Dict[str, torch.Tensor]:
        """Phase 2 of generation: mels from tokens and predicted series, at
        a static frame budget ``max_len``."""
        mel, mel_post = self._decode(x, dur, pitch, energy, max_len)
        return {'mel': mel, 'mel_post': mel_post, 'dur': dur,
                'pitch': pitch, 'energy': energy}

    def generate_combined(self, x: torch.Tensor, max_len: int,
                          alpha: float = 1.0) -> Dict[str, torch.Tensor]:
        """Series prediction and decode in one call at the frame budget
        ``max_len``, with the four token-level recurrences (the three
        predictor GRUs and the prenet GRU) run as one block-diagonal
        ``multi_bigru``. Equal to ``predict_series`` + ``generate`` up to
        rounding."""
        preds = (self.dur_pred, self.pitch_pred, self.energy_pred)
        entries = [(p.features(x), None, p.rnn) for p in preds]
        entries.append((self.prenet.pre_rnn(self.embedding(x)), None,
                        self.prenet.rnn))
        dur_rnn, pitch_rnn, energy_rnn, h = multi_bigru(entries)
        dur = guard_durations(self.dur_pred.head(dur_rnn, alpha)[..., 0])
        pitch = self.pitch_pred.head(pitch_rnn)[..., 0]
        energy = self.energy_pred.head(energy_rnn)[..., 0]
        mel, mel_post = decode_frames(self, h, dur, pitch, energy, max_len)
        return {'mel': mel, 'mel_post': mel_post, 'dur': dur,
                'pitch': pitch, 'energy': energy}

    def _decode(self, x: torch.Tensor, dur: torch.Tensor,
                pitch: torch.Tensor, energy: torch.Tensor, max_len: int,
                mel_lens: Optional[torch.Tensor] = None):
        h = self.prenet(self.embedding(x))
        return decode_frames(self, h, dur, pitch, energy, max_len, mel_lens)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'ForwardTacotron':
        model_config = dict(config['forward_tacotron']['model'])
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config).eval()
