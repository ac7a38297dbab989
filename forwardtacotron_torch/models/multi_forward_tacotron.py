"""MultiForwardTacotron: the speaker-conditioned ForwardTacotron with a
categorical pitch-condition head.

Port of forwardtacotron_tpu/models/multi_forward_tacotron.py (reference
models/multi_forward_tacotron.py:96-324): a speaker embedding [B, D] is
tiled onto every token and joins the series predictors' convolution inputs
and the prenet output before the frame trunk, so the trunk LSTM takes
2 * prenet_dims + speaker_emb_dims inputs. The duration and pitch
predictors also embed a 3-class pitch condition (0 = pad, 1 = unvoiced,
2 = voiced), which a head of its own predicts at generation
(``predict_series`` takes its argmax). The decode is ForwardTacotron's
(``decode_frames``), so in bfloat16 the trunk takes the fused frame trunk
under the same gate as the JAX package. Module names are the reference's,
so ``state_dict()`` has the keys and shapes of its checkpoints.

The speaker embedding joins the activations in their dtype: a float32
embedding given to a bfloat16 model is rounded to bfloat16 (the JAX
package promotes the activations to float32 there instead; ROADMAP.md
Queue 3, accepted differences).
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from forwardtacotron_torch.models.forward_tacotron import (PAD_VALUE,
                                                           decode_frames,
                                                           guard_durations)
from forwardtacotron_torch.models.layers import (CBHG, BatchNormConv, BiGRU,
                                                 BiLSTM, Conv, Dense)
from forwardtacotron_torch.text.symbols import phonemes


def tile_speaker(semb: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """[B, D] speaker embeddings repeated over h's tokens, in h's dtype:
    [B, N, D]."""
    return semb.to(h.dtype)[:, None, :].expand(-1, h.shape[1], -1)


class SeriesPredictor(nn.Module):
    """embed ++ speaker -> 3x(conv+BN+dropout) -> biGRU -> linear of
    ``out_dim`` (reference multi_forward_tacotron.py:14-50)."""

    def __init__(self, num_chars: int, emb_dim: int = 64,
                 conv_dims: int = 256, rnn_dims: int = 64,
                 dropout: float = 0.5, out_dim: int = 1,
                 speaker_emb_dims: int = 256, cond_emb_dims: int = 0):
        super().__init__()
        self.drop = nn.Dropout(dropout)
        self.embedding = nn.Embedding(num_chars, emb_dim)
        in_dims = emb_dim + cond_emb_dims + speaker_emb_dims
        self.convs = nn.ModuleList([
            BatchNormConv(in_dims if i == 0 else conv_dims, conv_dims, 5)
            for i in range(3)])
        self.rnn = BiGRU(conv_dims, rnn_dims)
        self.lin = Dense(2 * rnn_dims, out_dim)

    def _run(self, parts, alpha: float) -> torch.Tensor:
        x = torch.cat(parts, dim=-1)
        for conv in self.convs:
            x = self.drop(conv(x))
        return self.lin(self.rnn(x)) / alpha

    def forward(self, x: torch.Tensor, semb: torch.Tensor,
                alpha: float = 1.0) -> torch.Tensor:
        h = self.embedding(x)
        return self._run([h, tile_speaker(semb, h)], alpha)


class ConditionalSeriesPredictor(SeriesPredictor):
    """Adds a categorical pitch-condition embedding to the convolution
    input (reference multi_forward_tacotron.py:53-93)."""

    def __init__(self, num_chars: int, emb_dim: int = 64,
                 cond_emb_size: int = 4, cond_emb_dims: int = 8,
                 conv_dims: int = 256, rnn_dims: int = 64,
                 dropout: float = 0.5, speaker_emb_dims: int = 256):
        super().__init__(num_chars, emb_dim, conv_dims, rnn_dims, dropout,
                         speaker_emb_dims=speaker_emb_dims,
                         cond_emb_dims=cond_emb_dims)
        self.pitch_cond_embedding = nn.Embedding(cond_emb_size,
                                                 cond_emb_dims)

    def forward(self, x: torch.Tensor, x_cond: torch.Tensor,
                semb: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        h = self.embedding(x)
        return self._run([h, self.pitch_cond_embedding(x_cond),
                          tile_speaker(semb, h)], alpha)


class MultiForwardTacotron(nn.Module):

    def __init__(self, embed_dims: int = 256, series_embed_dims: int = 64,
                 num_chars: int = len(phonemes),
                 durpred_conv_dims: int = 256, durpred_rnn_dims: int = 64,
                 durpred_dropout: float = 0.5,
                 pitch_conv_dims: int = 256, pitch_rnn_dims: int = 128,
                 pitch_dropout: float = 0.5, pitch_strength: float = 1.0,
                 pitch_cond_conv_dims: int = 256,
                 pitch_cond_rnn_dims: int = 64,
                 pitch_cond_dropout: float = 0.5,
                 energy_conv_dims: int = 256, energy_rnn_dims: int = 64,
                 energy_dropout: float = 0.5, energy_strength: float = 1.0,
                 rnn_dims: int = 512, prenet_dims: int = 256,
                 prenet_k: int = 16, postnet_num_highways: int = 4,
                 prenet_dropout: float = 0.5, postnet_dims: int = 256,
                 postnet_k: int = 8, prenet_num_highways: int = 4,
                 postnet_dropout: float = 0.0, n_mels: int = 80,
                 speaker_emb_dims: int = 256, pitch_cond_emb_dims: int = 8,
                 pitch_cond_categorical_dims: int = 3,
                 padding_value: float = PAD_VALUE):
        super().__init__()
        self.speaker_emb_dims = speaker_emb_dims
        self.pitch_strength = pitch_strength
        self.energy_strength = energy_strength
        self.padding_value = padding_value
        self.embedding = nn.Embedding(num_chars, embed_dims)
        self.dur_pred = ConditionalSeriesPredictor(
            num_chars, series_embed_dims, cond_emb_dims=pitch_cond_emb_dims,
            conv_dims=durpred_conv_dims, rnn_dims=durpred_rnn_dims,
            dropout=durpred_dropout, speaker_emb_dims=speaker_emb_dims)
        self.pitch_cond_pred = SeriesPredictor(
            num_chars, series_embed_dims, pitch_cond_conv_dims,
            pitch_cond_rnn_dims, pitch_cond_dropout,
            out_dim=pitch_cond_categorical_dims,
            speaker_emb_dims=speaker_emb_dims)
        self.pitch_pred = ConditionalSeriesPredictor(
            num_chars, series_embed_dims, cond_emb_dims=pitch_cond_emb_dims,
            conv_dims=pitch_conv_dims, rnn_dims=pitch_rnn_dims,
            dropout=pitch_dropout, speaker_emb_dims=speaker_emb_dims)
        self.energy_pred = SeriesPredictor(
            num_chars, series_embed_dims, energy_conv_dims, energy_rnn_dims,
            energy_dropout, speaker_emb_dims=speaker_emb_dims)
        self.prenet = CBHG(K=prenet_k, in_channels=embed_dims,
                           channels=prenet_dims,
                           proj_channels=[prenet_dims, embed_dims],
                           num_highways=prenet_num_highways,
                           dropout=prenet_dropout)
        proj_dims = 2 * prenet_dims + speaker_emb_dims
        self.lstm = BiLSTM(proj_dims, rnn_dims)
        self.lin = Dense(2 * rnn_dims, n_mels)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.postnet = CBHG(K=postnet_k, in_channels=n_mels,
                            channels=postnet_dims,
                            proj_channels=[postnet_dims, n_mels],
                            num_highways=postnet_num_highways,
                            dropout=postnet_dropout)
        self.post_proj = nn.Linear(2 * postnet_dims, n_mels, bias=False)
        self.pitch_proj = Conv(1, proj_dims, kernel_size=3, padding=1)
        self.energy_proj = Conv(1, proj_dims, kernel_size=3, padding=1)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward (the JAX ``__call__``, reference
        multi_forward_tacotron.py:186-241): ForwardTacotron's batch plus
        speaker_emb [B, D] and pitch_cond [B, N]; 'pitch_cond' comes out
        as the head's logits [B, N, 3]."""
        x, semb, pitch_cond = batch['x'], batch['speaker_emb'], \
            batch['pitch_cond']
        pitch_cond_hat = self.pitch_cond_pred(x, semb)
        dur_hat = self.dur_pred(x, pitch_cond, semb)[..., 0]
        pitch_hat = self.pitch_pred(x, pitch_cond, semb)[..., 0]
        energy_hat = self.energy_pred(x, semb)[..., 0]
        mel, mel_post = self._decode(x, semb, batch['dur'], batch['pitch'],
                                     batch['energy'], batch['mel'].shape[1],
                                     batch['mel_len'])
        return {'mel': mel, 'mel_post': mel_post, 'dur': dur_hat,
                'pitch': pitch_hat, 'energy': energy_hat,
                'pitch_cond': pitch_cond_hat}

    def predict_series(self, x: torch.Tensor, semb: torch.Tensor,
                       alpha: float = 1.0) -> Dict[str, torch.Tensor]:
        """Phase 1 of generation: the pitch condition (the argmax of its
        head), then durations (with ForwardTacotron's batch-wide
        all-zero guard), pitch and energy conditioned on it."""
        pitch_cond = torch.argmax(self.pitch_cond_pred(x, semb), dim=-1)
        dur = guard_durations(
            self.dur_pred(x, pitch_cond, semb, alpha=alpha)[..., 0])
        return {'dur': dur,
                'pitch': self.pitch_pred(x, pitch_cond, semb)[..., 0],
                'energy': self.energy_pred(x, semb)[..., 0],
                'pitch_cond': pitch_cond}

    def generate(self, x: torch.Tensor, semb: torch.Tensor,
                 dur: torch.Tensor, pitch: torch.Tensor,
                 energy: torch.Tensor, pitch_cond: torch.Tensor,
                 max_len: int) -> Dict[str, torch.Tensor]:
        """Phase 2 of generation at a static frame budget ``max_len``."""
        mel, mel_post = self._decode(x, semb, dur, pitch, energy, max_len)
        return {'mel': mel, 'mel_post': mel_post, 'dur': dur,
                'pitch': pitch, 'energy': energy, 'pitch_cond': pitch_cond}

    def _decode(self, x: torch.Tensor, semb: torch.Tensor,
                dur: torch.Tensor, pitch: torch.Tensor, energy: torch.Tensor,
                max_len: int, mel_lens: Optional[torch.Tensor] = None):
        h = self.prenet(self.embedding(x))
        h = torch.cat([h, tile_speaker(semb, h)], dim=-1)
        return decode_frames(self, h, dur, pitch, energy, max_len, mel_lens)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'MultiForwardTacotron':
        model_config = dict(config['multi_forward_tacotron']['model'])
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config).eval()
