"""FastPitch: the transformer variant of the forward acoustic model.

Port of forwardtacotron_tpu/models/fast_pitch.py (reference
models/fast_pitch.py:44-235): the series predictors, prenet and postnet are
``ForwardTransformer`` stacks. As in the reference, the postnet's output is
both 'mel' and 'mel_post', and the post-regulator transformer of
``generate`` masks the bucket's padding tail. The length regulation is the
port's ``length_regulator`` (the ``lr`` kernel on the GPU). Module names
are the reference's, so ``state_dict()`` has the keys and shapes of the
published checkpoints. Mel tensors are [B, T, n_mels].
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from forwardtacotron_torch.models.layers import (Conv, ForwardTransformer,
                                                 conv_same, linear,
                                                 make_len_mask,
                                                 make_token_pad_mask)
from forwardtacotron_torch.ops.length_regulator import (expanded_lengths,
                                                        length_regulator)
from forwardtacotron_torch.parallel.mesh import global_max
from forwardtacotron_torch.text.symbols import phonemes

PAD_VALUE = -11.5129


class SeriesPredictor(nn.Module):
    """embed -> ForwardTransformer -> linear (reference fast_pitch.py:14-41)."""

    def __init__(self, num_chars: int, d_model: int, n_heads: int,
                 d_fft: int, layers: int, conv1_kernel: int,
                 conv2_kernel: int, dropout: float = 0.1):
        super().__init__()
        self.embedding = nn.Embedding(num_chars, d_model)
        self.transformer = ForwardTransformer(d_model, d_fft, layers, n_heads,
                                              conv1_kernel, conv2_kernel,
                                              dropout)
        self.lin = nn.Linear(d_model, 1)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                alpha: float = 1.0) -> torch.Tensor:
        h = self.transformer(self.embedding(x), pad_mask)
        return linear(h, self.lin) / alpha


class FastPitch(nn.Module):

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
                 pitch_strength: float = 1.0, energy_strength: float = 1.0,
                 d_model: int = 256, conv1_kernel: int = 9,
                 conv2_kernel: int = 1,
                 prenet_layers: int = 4, prenet_heads: int = 2,
                 prenet_fft: int = 1024, prenet_dropout: float = 0.1,
                 postnet_layers: int = 4, postnet_heads: int = 2,
                 postnet_fft: int = 1024, postnet_dropout: float = 0.1,
                 n_mels: int = 80, padding_value: float = PAD_VALUE):
        super().__init__()
        self.pitch_strength = pitch_strength
        self.energy_strength = energy_strength
        self.padding_value = padding_value
        self.embedding = nn.Embedding(num_chars, d_model)
        kernels = (conv1_kernel, conv2_kernel)
        self.dur_pred = SeriesPredictor(
            num_chars, durpred_d_model, durpred_n_heads, durpred_d_fft,
            durpred_layers, *kernels, dropout=durpred_dropout)
        self.pitch_pred = SeriesPredictor(
            num_chars, pitch_d_model, pitch_n_heads, pitch_d_fft,
            pitch_layers, *kernels, dropout=pitch_dropout)
        self.energy_pred = SeriesPredictor(
            num_chars, energy_d_model, energy_n_heads, energy_d_fft,
            energy_layers, *kernels, dropout=energy_dropout)
        self.prenet = ForwardTransformer(d_model, prenet_fft, prenet_layers,
                                         prenet_heads, *kernels,
                                         dropout=prenet_dropout)
        self.postnet = ForwardTransformer(d_model, postnet_fft,
                                          postnet_layers, postnet_heads,
                                          *kernels, dropout=postnet_dropout)
        self.lin = nn.Linear(d_model, n_mels)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.pitch_proj = Conv(1, d_model, kernel_size=3, padding=1)
        self.energy_proj = Conv(1, d_model, kernel_size=3, padding=1)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward (the JAX ``__call__``, reference
        fast_pitch.py:123-165): batch holds x [B, N] tokens, dur, pitch and
        energy [B, N], mel_len [B] and mel [B, T, n_mels], of which only
        the length T is used. The postnet sees the batch's longest
        ``mel_len`` frames, those beyond it zero, and they come out as
        ``padding_value``."""
        x, mel_lens = batch['x'], batch['mel_len']
        max_len = batch['mel'].shape[1]
        pad_mask = make_token_pad_mask(x)
        dur_hat = self.dur_pred(x, pad_mask)[..., 0]
        pitch_hat = self.pitch_pred(x, pad_mask)[..., 0]
        energy_hat = self.energy_pred(x, pad_mask)[..., 0]
        beyond = (torch.arange(max_len, device=x.device)[None, :]
                  >= global_max(mel_lens.max())).expand(x.shape[0], -1)
        mel = self._decode(x, batch['dur'], batch['pitch'], batch['energy'],
                           max_len, pad_mask,
                           make_len_mask(mel_lens, max_len), beyond)
        mel = mel.masked_fill(beyond[:, :, None], self.padding_value)
        return {'mel': mel, 'mel_post': mel, 'dur': dur_hat,
                'pitch': pitch_hat, 'energy': energy_hat}

    def predict_series(self, x: torch.Tensor, alpha: float = 1.0
                       ) -> Dict[str, torch.Tensor]:
        """Phase 1 of generation, with no padding mask (reference
        fast_pitch.py:174-181). If the truncated durations of the whole
        batch sum to <= 0, every duration becomes 2 frames."""
        dur = self.dur_pred(x, alpha=alpha)[..., 0]
        total = torch.trunc(dur).to(torch.int64).sum()
        dur = torch.where(total <= 0, torch.full_like(dur, 2.0), dur)
        return {'dur': dur, 'pitch': self.pitch_pred(x)[..., 0],
                'energy': self.energy_pred(x)[..., 0]}

    def generate(self, x: torch.Tensor, dur: torch.Tensor,
                 pitch: torch.Tensor, energy: torch.Tensor,
                 max_len: int) -> Dict[str, torch.Tensor]:
        """Phase 2 of generation at a static frame budget ``max_len``
        (reference _generate_mel, fast_pitch.py:194-221). The reference runs
        the postnet unmasked on the exact-length sequence; masking the
        frames past each item's expanded length (attention keys and
        convolution inputs) gives the same on the padded budget, and those
        frames come out zero."""
        tail = make_len_mask(expanded_lengths(dur), max_len)
        mel = self._decode(x, dur, pitch, energy, max_len,
                           make_token_pad_mask(x), tail, tail)
        mel = mel.masked_fill(tail[:, :, None], 0.0)
        return {'mel': mel, 'mel_post': mel, 'dur': dur, 'pitch': pitch,
                'energy': energy}

    def _decode(self, x, dur, pitch, energy, max_len, token_pad_mask,
                mel_pad_mask, conv_zero_mask):
        h = self.prenet(self.embedding(x), token_pad_mask)
        h = h + conv_same(pitch[:, :, None], self.pitch_proj) \
            * self.pitch_strength
        h = h + conv_same(energy[:, :, None], self.energy_proj) \
            * self.energy_strength
        h = length_regulator(h, dur, max_len)
        h = self.postnet(h, mel_pad_mask, conv_zero_mask)
        return linear(h, self.lin)

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'FastPitch':
        model_config = dict(config['fast_pitch']['model'])
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config).eval()
