"""Notebook convenience: checkpoint -> speech in two lines, on the GPU
(the port's counterpart of forwardtacotron_tpu/notebook_utils/
synthesize.py; reference notebook_utils/synthesize.py:11-49).

    synth = Synthesizer('checkpoints/ljspeech_tts.forward/latest_model.pt')
    wav = synth('Hello world!')

The checkpoint is a reference-format ``.pt`` or the JAX package's native
``.ckpt``. Synthesis runs in float32 on ``device``: CUDA unless the caller
names the CPU.
"""

from typing import Callable, Optional, Union

import numpy as np
import torch

from forwardtacotron_torch.dsp.dsp import DSP
from forwardtacotron_torch.models.registry import is_multispeaker
from forwardtacotron_torch.models.synthesis import TTSInference, Vocoder
from forwardtacotron_torch.text.cleaners import Cleaner
from forwardtacotron_torch.text.tokenizer import Tokenizer
from forwardtacotron_torch.utils.checkpoints import \
    init_tts_model_from_checkpoint
from forwardtacotron_torch.utils.device import resolve_device


def make_neural_vocoder(checkpoint_path: str, vocoder_type: str = 'hifigan',
                        config: Optional[dict] = None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Callable[[np.ndarray], np.ndarray]:
    """[n_mels, T] log-mel -> waveform, on the port's HiFi-GAN or MelGAN
    generator (``Vocoder``, float32) with published weights."""
    vocoder = Vocoder.from_checkpoint(checkpoint_path,
                                      vocoder_type=vocoder_type,
                                      config=config, dtype='float32',
                                      device=device)

    def vocode(mel: np.ndarray) -> np.ndarray:
        wav = vocoder(np.asarray(mel, np.float32).T[None])
        return wav[0].float().cpu().numpy()

    return vocode


class Synthesizer:

    def __init__(self, checkpoint_path: str,
                 vocoder: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 vocoder_checkpoint: Optional[str] = None,
                 vocoder_type: str = 'hifigan',
                 vocoder_config: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        """``vocoder`` maps a [n_mels, T] log-mel to a waveform; defaults to
        Griffin-Lim. Alternatively pass ``vocoder_checkpoint`` (published
        HiFi-GAN/MelGAN generator weights, ``vocoder_type`` selects which)
        to vocode on the device."""
        self.device = resolve_device(device)
        if vocoder is None and vocoder_checkpoint is not None:
            vocoder = make_neural_vocoder(vocoder_checkpoint, vocoder_type,
                                          vocoder_config, device=self.device)
        model, checkpoint = init_tts_model_from_checkpoint(checkpoint_path)
        self.config = checkpoint['config']
        self.dsp = DSP.from_config(self.config, device=self.device)
        self.multispeaker = is_multispeaker(self.config)
        self.speaker_embeddings = checkpoint.get('speaker_embeddings', {})
        self.inference = TTSInference(model, device=self.device)
        try:
            self.cleaner = Cleaner.from_config(self.config)
        except RuntimeError:
            self.cleaner = Cleaner(
                self.config['preprocessing']['cleaner_name'],
                use_phonemes=False,
                lang=self.config['preprocessing']['language'])
        self.tokenizer = Tokenizer()
        self.vocoder = vocoder if vocoder is not None else self.dsp.griffinlim

    def __call__(self, text: str, alpha: float = 1.0,
                 pitch_amp: float = 1.0,
                 speaker: Optional[str] = None) -> np.ndarray:
        mel = self.synthesize_mel(text, alpha=alpha, pitch_amp=pitch_amp,
                                  speaker=speaker)
        return np.asarray(self.vocoder(mel))

    def synthesize_mel(self, text: str, alpha: float = 1.0,
                       pitch_amp: float = 1.0,
                       speaker: Optional[str] = None) -> np.ndarray:
        """The [n_mels, T] log-mel of ``text``; a multispeaker model speaks
        as ``speaker``, else as the table's first speaker (zeros without a
        table)."""
        x = np.asarray(self.tokenizer(self.cleaner(text)))
        kwargs = {'alpha': alpha,
                  'pitch_function': lambda p: p * pitch_amp}
        if self.multispeaker:
            if speaker and speaker in self.speaker_embeddings:
                emb = self.speaker_embeddings[speaker]
            elif self.speaker_embeddings:
                emb = next(iter(self.speaker_embeddings.values()))
            else:
                emb = np.zeros(self.inference.model.speaker_emb_dims)
            kwargs['speaker_emb'] = np.asarray(emb, np.float32)
        return self.inference.generate_cropped(x, **kwargs)['mel_post']
