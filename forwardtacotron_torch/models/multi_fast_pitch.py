"""MultiFastPitch: the speaker-conditioned FastPitch.

Port of forwardtacotron_tpu/models/multi_fast_pitch.py (reference
models/multi_fast_pitch.py:93-330): FastPitch's transformer skeleton with
the speaker embedding [B, D] tiled onto every token and concatenated before
every transformer, so the prenet and postnet are d_model +
speaker_emb_dims wide and the predictors d_model + speaker_emb_dims (+ the
pitch-condition embedding's width for duration and pitch), and
MultiForwardTacotron's categorical pitch-condition head. Kept from the
JAX package exactly: 'mel' is 'mel_post'; in ``predict_series`` the
pitch-condition head takes ``alpha`` and no predictor takes a padding
mask; ``forward`` masks the postnet's convolution inputs beyond the
batch's longest ``mel_len``, ``generate`` beyond each item's expanded
length. The length regulator is the ``lr`` kernel (row 8), at C = d_model
+ speaker_emb_dims, in float32 (the transformers compute in float32, as
FastPitch's do). Module names are the reference's, so ``state_dict()`` has
the keys and shapes of its checkpoints.
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from forwardtacotron_torch.models.fast_pitch import PAD_VALUE
from forwardtacotron_torch.models.forward_tacotron import guard_durations
from forwardtacotron_torch.models.layers import (Conv, ForwardTransformer,
                                                 conv_same, linear,
                                                 make_len_mask,
                                                 make_token_pad_mask)
from forwardtacotron_torch.models.multi_forward_tacotron import tile_speaker
from forwardtacotron_torch.ops.length_regulator import (expanded_lengths,
                                                        length_regulator)
from forwardtacotron_torch.parallel.mesh import global_max
from forwardtacotron_torch.text.symbols import phonemes


class SeriesPredictor(nn.Module):
    """embed ++ speaker -> ForwardTransformer -> linear of ``out_dim``
    (reference multi_fast_pitch.py:15-50)."""

    def __init__(self, num_chars: int, d_model: int, n_heads: int,
                 d_fft: int, layers: int, conv1_kernel: int,
                 conv2_kernel: int, speaker_emb_dims: int,
                 dropout: float = 0.1, out_dim: int = 1,
                 cond_emb_dims: int = 0):
        super().__init__()
        width = d_model + cond_emb_dims + speaker_emb_dims
        self.embedding = nn.Embedding(num_chars, d_model)
        self.transformer = ForwardTransformer(width, d_fft, layers, n_heads,
                                              conv1_kernel, conv2_kernel,
                                              dropout)
        self.lin = nn.Linear(width, out_dim)

    def _run(self, parts, pad_mask, alpha: float) -> torch.Tensor:
        h = self.transformer(torch.cat(parts, dim=-1), pad_mask)
        return linear(h, self.lin) / alpha

    def forward(self, x: torch.Tensor, semb: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                alpha: float = 1.0) -> torch.Tensor:
        h = self.embedding(x)
        return self._run([h, tile_speaker(semb, h)], pad_mask, alpha)


class ConditionalSeriesPredictor(SeriesPredictor):
    """Adds the categorical pitch-condition embedding
    (reference multi_fast_pitch.py:53-91)."""

    def __init__(self, num_chars: int, d_model: int, n_heads: int,
                 d_fft: int, layers: int, conv1_kernel: int,
                 conv2_kernel: int, speaker_emb_dims: int,
                 cond_emb_size: int = 4, cond_emb_dims: int = 8,
                 dropout: float = 0.1):
        super().__init__(num_chars, d_model, n_heads, d_fft, layers,
                         conv1_kernel, conv2_kernel, speaker_emb_dims,
                         dropout, cond_emb_dims=cond_emb_dims)
        self.conditional_embedding = nn.Embedding(cond_emb_size,
                                                  cond_emb_dims)

    def forward(self, x: torch.Tensor, x_cond: torch.Tensor,
                semb: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                alpha: float = 1.0) -> torch.Tensor:
        h = self.embedding(x)
        return self._run([h, self.conditional_embedding(x_cond),
                          tile_speaker(semb, h)], pad_mask, alpha)


class MultiFastPitch(nn.Module):

    def __init__(self, num_chars: int = len(phonemes),
                 durpred_dropout: float = 0.5, durpred_d_model: int = 128,
                 durpred_n_heads: int = 2, durpred_layers: int = 4,
                 durpred_d_fft: int = 128,
                 pitch_dropout: float = 0.5, pitch_d_model: int = 128,
                 pitch_n_heads: int = 2, pitch_layers: int = 4,
                 pitch_d_fft: int = 128,
                 energy_dropout: float = 0.5, energy_d_model: int = 128,
                 energy_n_heads: int = 2, energy_layers: int = 4,
                 energy_d_fft: int = 128,
                 pitch_cond_d_model: int = 128, pitch_cond_n_heads: int = 2,
                 pitch_cond_layers: int = 4, pitch_cond_d_fft: int = 128,
                 pitch_cond_dropout: float = 0.1,
                 pitch_cond_output_dims: int = 3,
                 pitch_strength: float = 1.0, energy_strength: float = 1.0,
                 d_model: int = 256, conv1_kernel: int = 9,
                 conv2_kernel: int = 1,
                 prenet_layers: int = 4, prenet_heads: int = 2,
                 prenet_fft: int = 1024, prenet_dropout: float = 0.1,
                 postnet_layers: int = 4, postnet_heads: int = 2,
                 postnet_fft: int = 1024, postnet_dropout: float = 0.1,
                 n_mels: int = 80, speaker_emb_dims: int = 256,
                 padding_value: float = PAD_VALUE):
        super().__init__()
        self.speaker_emb_dims = speaker_emb_dims
        self.pitch_strength = pitch_strength
        self.energy_strength = energy_strength
        self.padding_value = padding_value
        common = (conv1_kernel, conv2_kernel, speaker_emb_dims)
        self.dur_pred = ConditionalSeriesPredictor(
            num_chars, durpred_d_model, durpred_n_heads, durpred_d_fft,
            durpred_layers, *common, dropout=durpred_dropout)
        self.pitch_pred = ConditionalSeriesPredictor(
            num_chars, pitch_d_model, pitch_n_heads, pitch_d_fft,
            pitch_layers, *common, dropout=pitch_dropout)
        self.pitch_cond_pred = SeriesPredictor(
            num_chars, pitch_cond_d_model, pitch_cond_n_heads,
            pitch_cond_d_fft, pitch_cond_layers, *common,
            dropout=pitch_cond_dropout, out_dim=pitch_cond_output_dims)
        self.energy_pred = SeriesPredictor(
            num_chars, energy_d_model, energy_n_heads, energy_d_fft,
            energy_layers, *common, dropout=energy_dropout)
        self.embedding = nn.Embedding(num_chars, d_model)
        width = d_model + speaker_emb_dims
        kernels = (conv1_kernel, conv2_kernel)
        self.prenet = ForwardTransformer(width, prenet_fft, prenet_layers,
                                         prenet_heads, *kernels,
                                         dropout=prenet_dropout)
        self.postnet = ForwardTransformer(width, postnet_fft, postnet_layers,
                                          postnet_heads, *kernels,
                                          dropout=postnet_dropout)
        self.lin = nn.Linear(width, n_mels)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.pitch_proj = Conv(1, width, kernel_size=3, padding=1)
        self.energy_proj = Conv(1, width, kernel_size=3, padding=1)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward (the JAX ``__call__``, reference
        multi_fast_pitch.py:194-246): FastPitch's batch plus speaker_emb
        [B, D] and pitch_cond [B, N]; the series heads take the token
        padding mask, 'pitch_cond' comes out as logits [B, N, 3]."""
        x, semb, pitch_cond = batch['x'], batch['speaker_emb'], \
            batch['pitch_cond']
        mel_lens, max_len = batch['mel_len'], batch['mel'].shape[1]
        pad_mask = make_token_pad_mask(x)
        dur_hat = self.dur_pred(x, pitch_cond, semb, pad_mask)[..., 0]
        pitch_hat = self.pitch_pred(x, pitch_cond, semb, pad_mask)[..., 0]
        pitch_cond_hat = self.pitch_cond_pred(x, semb, pad_mask)
        energy_hat = self.energy_pred(x, semb, pad_mask)[..., 0]
        beyond = (torch.arange(max_len, device=x.device)[None, :]
                  >= global_max(mel_lens.max())).expand(x.shape[0], -1)
        mel = self._decode(x, semb, batch['dur'], batch['pitch'],
                           batch['energy'], max_len, pad_mask,
                           make_len_mask(mel_lens, max_len), beyond)
        mel = mel.masked_fill(beyond[:, :, None], self.padding_value)
        return {'mel': mel, 'mel_post': mel, 'dur': dur_hat,
                'pitch': pitch_hat, 'energy': energy_hat,
                'pitch_cond': pitch_cond_hat}

    def predict_series(self, x: torch.Tensor, semb: torch.Tensor,
                       alpha: float = 1.0) -> Dict[str, torch.Tensor]:
        """Phase 1 of generation, with no padding mask; the
        pitch-condition head takes ``alpha`` as in the JAX package
        (multi_fast_pitch.py:202-212), and the batch-wide all-zero
        duration guard."""
        pitch_cond = torch.argmax(self.pitch_cond_pred(x, semb, alpha=alpha),
                                  dim=-1)
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
        """Phase 2 of generation at a static frame budget ``max_len``:
        the post-regulator transformer masks the frames past each item's
        expanded length (attention keys and convolution inputs), and those
        frames come out zero."""
        tail = make_len_mask(expanded_lengths(dur), max_len)
        mel = self._decode(x, semb, dur, pitch, energy, max_len,
                           make_token_pad_mask(x), tail, tail)
        mel = mel.masked_fill(tail[:, :, None], 0.0)
        return {'mel': mel, 'mel_post': mel, 'dur': dur, 'pitch': pitch,
                'energy': energy, 'pitch_cond': pitch_cond}

    def _decode(self, x, semb, dur, pitch, energy, max_len, token_pad_mask,
                mel_pad_mask, conv_zero_mask):
        h = self.embedding(x)
        h = self.prenet(torch.cat([h, tile_speaker(semb, h)], dim=-1),
                        token_pad_mask)
        h = h + conv_same(pitch[:, :, None], self.pitch_proj) \
            * self.pitch_strength
        h = h + conv_same(energy[:, :, None], self.energy_proj) \
            * self.energy_strength
        h = length_regulator(h, dur, max_len)
        h = self.postnet(h, mel_pad_mask, conv_zero_mask)
        return linear(h, self.lin)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'MultiFastPitch':
        model_config = dict(config['multi_fast_pitch']['model'])
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config).eval()
