"""ForwardTacotron, serving path (generate mode).

Port of forwardtacotron_tpu/models/forward_tacotron.py: the series
predictors, ``predict_series`` with the all-zero-duration guard,
``generate`` and the generate-mode decode. Module names are the reference's,
so ``state_dict()`` has exactly the keys and shapes of the published
checkpoints. Mel tensors are [B, T, n_mels].
"""

from typing import Any, Dict

import torch
from torch import nn

from forwardtacotron_torch.models.layers import (CBHG, BatchNormConv, BiGRU,
                                                 BiLSTM, conv1d, frame_trunk)
from forwardtacotron_torch.ops.length_regulator import expanded_lengths
from forwardtacotron_torch.text.symbols import phonemes


class SeriesPredictor(nn.Module):
    """Duration/pitch/energy predictor: embed -> 3x(conv+BN) -> biGRU ->
    linear (reference forward_tacotron.py:14-39)."""

    def __init__(self, num_chars: int, emb_dim: int = 64,
                 conv_dims: int = 256, rnn_dims: int = 64):
        super().__init__()
        self.embedding = nn.Embedding(num_chars, emb_dim)
        self.convs = nn.ModuleList([
            BatchNormConv(emb_dim if i == 0 else conv_dims, conv_dims, 5)
            for i in range(3)])
        self.rnn = BiGRU(conv_dims, rnn_dims)
        self.lin = nn.Linear(2 * rnn_dims, 1)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Embedding and conv stack (the part before the GRU)."""
        x = self.embedding(x)
        for conv in self.convs:
            x = conv(x)
        return x

    def head(self, rnn_out: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        return self.lin(rnn_out) / alpha

    def forward(self, x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        return self.head(self.rnn(self.features(x)), alpha)


class ForwardTacotron(nn.Module):

    def __init__(self, embed_dims: int = 256, series_embed_dims: int = 64,
                 num_chars: int = len(phonemes),
                 durpred_conv_dims: int = 256, durpred_rnn_dims: int = 64,
                 pitch_conv_dims: int = 256, pitch_rnn_dims: int = 128,
                 pitch_strength: float = 1.0,
                 energy_conv_dims: int = 256, energy_rnn_dims: int = 64,
                 energy_strength: float = 1.0,
                 rnn_dims: int = 512, prenet_dims: int = 256,
                 prenet_k: int = 16, prenet_num_highways: int = 4,
                 postnet_dims: int = 256, postnet_k: int = 8,
                 postnet_num_highways: int = 4, n_mels: int = 80):
        super().__init__()
        self.pitch_strength = pitch_strength
        self.energy_strength = energy_strength
        self.embedding = nn.Embedding(num_chars, embed_dims)
        self.dur_pred = SeriesPredictor(num_chars, series_embed_dims,
                                        durpred_conv_dims, durpred_rnn_dims)
        self.pitch_pred = SeriesPredictor(num_chars, series_embed_dims,
                                          pitch_conv_dims, pitch_rnn_dims)
        self.energy_pred = SeriesPredictor(num_chars, series_embed_dims,
                                           energy_conv_dims, energy_rnn_dims)
        self.prenet = CBHG(K=prenet_k, in_channels=embed_dims,
                           channels=prenet_dims,
                           proj_channels=[prenet_dims, embed_dims],
                           num_highways=prenet_num_highways)
        self.lstm = BiLSTM(2 * prenet_dims, rnn_dims)
        self.lin = nn.Linear(2 * rnn_dims, n_mels)
        self.register_buffer('step', torch.zeros(1, dtype=torch.long))
        self.postnet = CBHG(K=postnet_k, in_channels=n_mels,
                            channels=postnet_dims,
                            proj_channels=[postnet_dims, n_mels],
                            num_highways=postnet_num_highways)
        self.post_proj = nn.Linear(2 * postnet_dims, n_mels, bias=False)
        self.pitch_proj = nn.Conv1d(1, 2 * prenet_dims, kernel_size=3,
                                    padding=1)
        self.energy_proj = nn.Conv1d(1, 2 * prenet_dims, kernel_size=3,
                                     padding=1)

    def predict_series(self, x: torch.Tensor, alpha: float = 1.0
                       ) -> Dict[str, torch.Tensor]:
        """Phase 1 of generation: durations, pitch and energy from tokens.
        If the truncated durations of the whole batch sum to <= 0, every
        duration becomes 2 frames (reference forward_tacotron.py:176-177)."""
        dur = self.dur_pred(x, alpha=alpha)[..., 0]
        total = torch.trunc(dur).to(torch.int64).sum()
        dur = torch.where(total <= 0, torch.full_like(dur, 2.0), dur)
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

    def _decode(self, x: torch.Tensor, dur: torch.Tensor,
                pitch: torch.Tensor, energy: torch.Tensor, max_len: int):
        h = self.prenet(self.embedding(x))
        return self._decode_post_prenet(h, dur, pitch, energy, max_len)

    def _decode_post_prenet(self, h: torch.Tensor, dur: torch.Tensor,
                            pitch: torch.Tensor, energy: torch.Tensor,
                            max_len: int):
        """Generate mode: per-item expanded lengths steer the LSTM and
        postnet-GRU flips, and frames past them are zeroed so convolution
        boundaries match the reference's exact-length zero padding."""
        h = h + conv1d(pitch[:, :, None], self.pitch_proj) * self.pitch_strength
        h = h + conv1d(energy[:, :, None], self.energy_proj) \
            * self.energy_strength
        lengths = expanded_lengths(dur)
        raw = frame_trunk(h, dur, lengths, max_len, self.lstm, self.lin)
        tail = (torch.arange(max_len, device=h.device)[None, :]
                >= lengths[:, None])[:, :, None]
        mel = raw.masked_fill(tail, 0.0)
        post = self.postnet(mel, lengths=lengths)
        mel_post = self.post_proj(post).masked_fill(tail, 0.0)
        return mel, mel_post

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'ForwardTacotron':
        # dropout is the identity at inference
        model_config = {k: v for k, v
                        in config['forward_tacotron']['model'].items()
                        if not k.endswith('_dropout')}
        model_config['num_chars'] = len(phonemes)
        model_config['n_mels'] = config['dsp']['num_mels']
        return cls(**model_config).eval()
