"""Synthesis orchestrator (port of forwardtacotron_tpu/models/synthesis.py
for ForwardTacotron, FastPitch and their multispeaker variants): the
two-phase ``generate``, the single-call ``generate_fused`` and the
length-routed ``generate_routed`` (optionally vocoding each group with a
``Vocoder``), in float32 or bfloat16; multispeaker models take
``speaker_emb``.

Two-phase: phase 1 predicts durations, pitch and energy; the host reads the
expanded frame counts; phase 2 decodes at the frame count rounded up to a
bucket, so each decode sees the same padded length as in the JAX package.

Data parallel (``mesh=``): one replica of the model on each device of the
mesh; every call pads its batch to a multiple of the replicas (repeating
row 0), launches each replica on its share in turn on its device's current
stream, gathers the shares on the first device and crops the padding
(the JAX package's ``_shard`` and ``_crop``). The two-phase entry points
read the whole batch's expanded lengths once, so every share decodes at
the same bucket. One difference from the JAX package remains: the
all-zero duration guard (``guard_durations``) sums over each share, where
the JAX package's sharded graph sums over the whole batch.
"""

import contextlib
import copy
import math
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from forwardtacotron_torch.ops.length_regulator import expanded_lengths
from forwardtacotron_torch.utils.device import resolve_device
from forwardtacotron_torch.utils.vocoder_checkpoints import (load_hifigan,
                                                             load_melgan)

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def bucket_frames(n: int, bucket: int = 128, max_frames: int = 16384) -> int:
    """Round a frame count up to a bucket boundary."""
    return min(max_frames, int(math.ceil(max(n, 1) / bucket)) * bucket)


def bucket_group_size(n: int, cap: int) -> int:
    """Round a routed decode group's batch size up to a power of two
    (capped at the request batch size), so a changing request mix reuses
    O(log2(B) x #frame-buckets) decode shapes."""
    return min(cap, 1 << max(0, (int(n) - 1).bit_length()))


class Vocoder:
    """Batched neural vocoding, mel [B, T, n_mels] -> wav [B, T * hop], for
    the serving path: the counterpart of the JAX package's ``JittedVocoder``
    (PyTorch runs eagerly, so there is nothing to jit). ``dtype='bfloat16'``
    casts the generator's parameters, as ``JittedVocoder`` casts its
    variables. The generator is moved (and cast) in place, as ``Module.to``
    does; ``device`` defaults to CUDA and raises when no GPU is present.
    Pass as ``vocoder=`` to :meth:`TTSInference.generate_routed`."""

    def __init__(self, model: torch.nn.Module, dtype: str = 'bfloat16',
                 device: Optional[Union[str, torch.device]] = None):
        if dtype not in DTYPES:
            raise ValueError(
                f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device, DTYPES[dtype]).eval()
        self.hop_length = int(model.hop_length)

    @classmethod
    def from_checkpoint(cls, path: str, vocoder_type: str = 'hifigan',
                        config: Optional[dict] = None,
                        dtype: str = 'bfloat16',
                        device: Optional[Union[str, torch.device]] = None
                        ) -> 'Vocoder':
        """A published generator checkpoint: jik876 HiFi-GAN (``config``
        its config.json dict) or seungwonpark MelGAN (``config`` unused).
        The generator's plain forward serves, as ``JittedVocoder`` calls
        the JAX module's ``__call__``."""
        if vocoder_type == 'hifigan':
            return cls(load_hifigan(path, config=config, device=device),
                       dtype=dtype, device=device)
        if vocoder_type == 'melgan':
            return cls(load_melgan(path, device=device), dtype=dtype,
                       device=device)
        raise ValueError(f'unknown vocoder_type: {vocoder_type}')

    @torch.inference_mode()
    def __call__(self, mel) -> torch.Tensor:
        mel = torch.as_tensor(mel if torch.is_tensor(mel) else np.asarray(mel))
        return self.model(mel.to(self.device, torch.float32))


class TTSInference:
    """Wraps a ForwardTacotron, a FastPitch or a multispeaker variant with
    the synthesis entry points.

    ``dtype='bfloat16'`` casts every floating parameter and BatchNorm
    statistic to bfloat16, as the JAX package casts its variables; the
    recurrences and the frame trunk then take the recurrent kernels
    (FastPitch's transformers compute in float32 with the bfloat16
    weights, as the JAX package's promote them). The
    model is moved (and cast) in place, as ``Module.to`` does. ``device``
    defaults to CUDA and raises when no GPU is present; pass
    ``device='cpu'`` to run on the CPU.

    ``multispeaker`` is whether the model has ``speaker_emb_dims``, as the
    JAX package decides. A multispeaker model's entry points need
    ``speaker_emb``, [B, D] for a batch or [D] for one request, never
    broadcast over a batch; the series carry the predicted ``pitch_cond``
    into the decode. A single-speaker model refuses one.

    ``mesh``: a sequence of devices (``parallel.mesh.make_mesh``) for data
    parallel serving, one replica each (the model itself on the first, in
    place of ``device``); outputs come back on the first. A mesh of one
    device is the plain path on that device."""

    def __init__(self, model: torch.nn.Module, dtype: str = 'float32',
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Sequence[Union[str, torch.device]]] = None):
        if dtype not in DTYPES:
            raise ValueError(
                f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        devices = [resolve_device(d) for d in mesh or (device,)]
        self.device = devices[0]
        self.model = model.to(self.device, DTYPES[dtype]).eval()
        self.multispeaker = hasattr(model, 'speaker_emb_dims')
        # (device, model) of each replica; the model's weight-dependent
        # caches (prepared launch weights) are per replica
        self.replicas = [(self.device, self.model)] + [
            (d, copy.deepcopy(self.model).to(d)) for d in devices[1:]]

    def _tokens(self, x) -> torch.Tensor:
        """Token ids (a sequence, numpy array or tensor) as a [B, N] long
        tensor on the device."""
        x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                            dtype=torch.long, device=self.device)
        return x[None, :] if x.dim() == 1 else x

    def _speaker(self, speaker_emb) -> Optional[torch.Tensor]:
        """The speaker embedding as [B, D] on the device (a [D] one as
        [1, D]); None for a single-speaker model."""
        if not self.multispeaker:
            if speaker_emb is not None:
                raise ValueError('speaker_emb given to a single-speaker '
                                 'model')
            return None
        if speaker_emb is None:
            raise ValueError('a multispeaker model needs speaker_emb')
        semb = torch.as_tensor(
            speaker_emb if torch.is_tensor(speaker_emb)
            else np.asarray(speaker_emb), device=self.device)
        return semb[None, :] if semb.dim() == 1 else semb

    def _sharded(self, fn: Callable, *batch) -> Dict[str, torch.Tensor]:
        """``fn(model, *shares)`` on every replica, each with its share of
        the rows of the ``batch`` tensors (None passes as None), launched
        in turn without waiting; the outputs joined on the first device.
        With one replica, ``fn(model, *batch)`` as it is."""
        if len(self.replicas) == 1:
            return fn(self.model, *batch)
        n = len(self.replicas)
        b = batch[0].shape[0]
        pad = (-b) % n

        def shares(t):
            if t is None:
                return [None] * n
            if pad:
                t = torch.cat([t, t[:1].expand(pad, *t.shape[1:])])
            return t.chunk(n)
        parts = []
        for (dev, model), args in zip(self.replicas,
                                      zip(*map(shares, batch))):
            with (torch.cuda.device(dev) if dev.type == 'cuda'
                  else contextlib.nullcontext()):
                parts.append(fn(model, *(None if a is None
                                         else a.to(dev, non_blocking=True)
                                         for a in args)))
        return {k: torch.cat([p[k].to(self.device) for p in parts])[:b]
                for k in parts[0]}

    @staticmethod
    def _predict(model, x: torch.Tensor, semb: Optional[torch.Tensor],
                 alpha: float) -> Dict[str, torch.Tensor]:
        if semb is None:
            return model.predict_series(x, alpha)
        return model.predict_series(x, semb, alpha)

    @staticmethod
    def _generate(model, x, semb, series, max_len: int
                  ) -> Dict[str, torch.Tensor]:
        """The model's ``generate`` on the series ``(dur, pitch, energy[,
        pitch_cond])``."""
        if semb is None:
            return model.generate(x, *series, max_len)
        dur, pitch, energy, pitch_cond = series
        return model.generate(x, semb, dur, pitch, energy, pitch_cond,
                              max_len)

    def _decode(self, x, semb, series, max_len: int
                ) -> Dict[str, torch.Tensor]:
        """``_generate`` over the replicas."""
        return self._sharded(
            lambda m, xs, ss, *ser: self._generate(m, xs, ss, ser, max_len),
            x, semb, *series)

    def _series(self, x: torch.Tensor, semb: Optional[torch.Tensor],
                alpha: float, pitch_function: Callable,
                energy_function: Callable):
        """(dur, pitch, energy[, pitch_cond]) of the whole batch with the
        user hooks applied to pitch and energy."""
        series = self._sharded(
            lambda m, xs, ss: self._predict(m, xs, ss, alpha), x, semb)
        pitch = torch.as_tensor(pitch_function(series['pitch']),
                                device=self.device)
        energy = torch.as_tensor(energy_function(series['energy']),
                                 device=self.device)
        out = (series['dur'], pitch, energy)
        return out if semb is None else out + (series['pitch_cond'],)

    @torch.inference_mode()
    def generate(self, x, speaker_emb=None, alpha: float = 1.0,
                 pitch_function: Callable = lambda p: p,
                 energy_function: Callable = lambda e: e
                 ) -> Dict[str, torch.Tensor]:
        """Two-phase synthesis of a batch at the bucket of its longest
        item."""
        x, semb = self._tokens(x), self._speaker(speaker_emb)
        series = self._series(x, semb, alpha, pitch_function,
                              energy_function)
        mel_lens = expanded_lengths(series[0])
        max_len = bucket_frames(int(mel_lens.max()))
        out = self._decode(x, semb, series, max_len)
        out['mel_len'] = mel_lens
        return out

    @torch.inference_mode()
    def generate_fused(self, x, max_len: int, speaker_emb=None,
                       alpha: float = 1.0) -> Dict[str, torch.Tensor]:
        """Serving-mode synthesis at a fixed frame budget ``max_len``:
        series prediction and decode in one call
        (``ForwardTacotron.generate_combined``; a model without it, as
        FastPitch and the multispeaker models, runs ``predict_series`` then
        ``generate``), no host read in between. Durations that would exceed
        the budget are cropped; ``mel_len`` is the uncropped expanded
        length."""
        def fused(model, x, semb):
            if semb is None and hasattr(model, 'generate_combined'):
                out = model.generate_combined(x, max_len, alpha)
            else:
                s = self._predict(model, x, semb, alpha)
                series = tuple(s[k] for k in ('dur', 'pitch', 'energy',
                                              'pitch_cond') if k in s)
                out = self._generate(model, x, semb, series, max_len)
            out['mel_len'] = expanded_lengths(out['dur'])
            return out
        return self._sharded(fused, self._tokens(x),
                             self._speaker(speaker_emb))

    @torch.inference_mode()
    def generate_routed(self, x, speaker_emb=None, alpha: float = 1.0,
                        frame_bucket: int = 128,
                        pitch_function: Callable = lambda p: p,
                        energy_function: Callable = lambda e: e,
                        vocoder: Optional[Callable] = None
                        ) -> Dict[str, torch.Tensor]:
        """Length-routed batch synthesis: series prediction once for the
        batch, then one decode per group of requests that share a
        ``frame_bucket``-rounded length, at that group's budget, so short
        requests do not pay the longest one's. Group sizes are padded up to
        a power of two (``bucket_group_size``, repeating the group's first
        request; the padding is cropped); a multispeaker group takes its
        speaker rows and ``pitch_cond`` by the same padded index. With a
        mesh, the series and each group's decode are split over the
        replicas. Outputs
        come back in request order, mels padded to the largest bucket,
        with ``mel_len`` capped at each request's bucket.

        ``vocoder``: an optional batched [B, T, n_mels] -> [B, T * hop]
        callable (a :class:`Vocoder`). It runs inside the per-bucket loop,
        so each group is vocoded at its own frame budget; the outputs gain
        ``'wav'`` (padded to the largest bucket) and ``'wav_len'`` =
        ``mel_len`` * hop."""
        x, semb = self._tokens(x), self._speaker(speaker_emb)
        series = self._series(x, semb, alpha, pitch_function,
                              energy_function)
        mel_lens = expanded_lengths(series[0]).cpu().numpy()
        buckets = np.array([bucket_frames(int(n), frame_bucket)
                            for n in mel_lens])
        parts, order = [], []
        for bucket in np.unique(buckets):
            idx = np.nonzero(buckets == bucket)[0]
            n_pad = bucket_group_size(len(idx), x.shape[0])
            gi = torch.as_tensor(np.concatenate(
                [idx, np.full(n_pad - len(idx), idx[0])]), device=self.device)
            out = self._decode(x[gi], None if semb is None else semb[gi],
                               [s[gi] for s in series], int(bucket))
            if vocoder is not None:
                out['wav'] = vocoder(out['mel_post'])
            parts.append({k: v[:len(idx)] for k, v in out.items()})
            order.append(idx)
        # request order with one gather per key over the concatenated
        # groups, mels and wavs padded in time to the largest bucket's
        inv = torch.as_tensor(np.argsort(np.concatenate(order)),
                              device=self.device)
        width = int(buckets.max())
        merged = {}
        for key in parts[0]:
            cat = [p[key] for p in parts]
            if key in ('mel', 'mel_post', 'wav'):
                n = max(t.shape[1] for t in cat)
                cat = [torch.nn.functional.pad(
                    t, (0, 0) * (t.dim() - 2) + (0, n - t.shape[1]))
                    for t in cat]
            merged[key] = torch.cat(cat)[inv]
        merged['mel_len'] = torch.as_tensor(np.minimum(mel_lens, buckets),
                                            device=self.device)
        if vocoder is not None:
            merged['wav_len'] = merged['mel_len'] * (merged['wav'].shape[1]
                                                     // width)
        return merged

    def generate_cropped(self, x, **kwargs) -> Dict[str, np.ndarray]:
        """Single utterance: outputs cropped to the true length, as float32
        numpy arrays, mels as [n_mels, T] (the reference's layout)."""
        out = self.generate(x, **kwargs)
        length = int(out['mel_len'][0])

        def host(t):
            return t.float().cpu().numpy()
        return {'mel': host(out['mel'][0, :length].T),
                'mel_post': host(out['mel_post'][0, :length].T),
                'dur': host(out['dur'][0]),
                'pitch': host(out['pitch'][0]),
                'energy': host(out['energy'][0])}
