"""Teacher -> student bridge: batched attention extraction on the device and
parallel duration extraction on the host (the port of
forwardtacotron_tpu/duration/pipeline.py, reference
duration_extraction/duration_extraction_pipe.py).

* ``extract_attentions`` (reference :88-127): equal-token-length batches of
  the binned loader through the teacher's teacher-forced forward at r = 1,
  in eval mode with the decoder PreNet's dropout forced on (reference
  train_tacotron.py:120), drawn from a ``torch.Generator`` seeded with
  ``seed``; each attention is cropped to (mel_len, x_len) and saved. Both
  CBHGs run their kernels (rows 1 and 2) once a batch each.
* ``extract_durations`` (reference :129-194): the shortest-path extraction
  is host work, spread over a ``spawn`` process pool. Nothing a worker
  imports imports torch, so no worker can initialise CUDA.
"""

import warnings
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from forwardtacotron_torch.data.dataset import (DurationStats,
                                                get_binned_taco_dataloader)
from forwardtacotron_torch.duration.extractor import DurationExtractor
from forwardtacotron_torch.native import load_library
from forwardtacotron_torch.text.tokenizer import Tokenizer
from forwardtacotron_torch.utils.files import unpickle_binary
from forwardtacotron_torch.utils.metrics import attention_score
from forwardtacotron_torch.utils.paths import Paths


@dataclass
class DurationResult:
    item_id: str
    att_score: float
    align_score: float
    durations: np.ndarray


def max_consecutive_ones(durations: np.ndarray) -> int:
    best = run = 0
    for d in durations:
        run = run + 1 if d == 1 else 0
        best = max(best, run)
    return best


# module-level worker state, so that the pool can pickle the worker function
_WORKER_STATE: Dict[str, Any] = {}


def _init_worker(paths_data: str, text_dict, silence_threshold: float,
                 silence_prob_shift: float) -> None:
    _WORKER_STATE['paths_data'] = paths_data
    _WORKER_STATE['text_dict'] = text_dict
    _WORKER_STATE['tokenizer'] = Tokenizer()
    _WORKER_STATE['extractor'] = DurationExtractor(
        silence_threshold=silence_threshold,
        silence_prob_shift=silence_prob_shift)


def _extract_one(item_id: str) -> Optional[DurationResult]:
    data = Path(_WORKER_STATE['paths_data'])
    tokenizer = _WORKER_STATE['tokenizer']
    extractor = _WORKER_STATE['extractor']
    text = _WORKER_STATE['text_dict'][item_id]

    x = np.asarray(tokenizer(text))
    mel = np.load(str(data / 'mel' / f'{item_id}.npy'))
    attention = np.load(str(data / 'att_pred' / f'{item_id}.npy'))
    mel_len = mel.shape[-1]

    align_score, _ = attention_score(attention[None, ...],
                                     np.array([mel_len]), r=1)
    durations, att_score = extractor(x, mel, attention)
    if durations.sum() != mel_len:
        warnings.warn(f'Sum of durations != mel length for {item_id}')
    np.save(str(data / 'alg' / f'{item_id}.npy'),
            durations.astype(np.int64), allow_pickle=False)
    return DurationResult(item_id=item_id, att_score=float(att_score),
                          align_score=float(align_score[0]),
                          durations=durations)


class DurationExtractionPipeline:

    def __init__(self, paths: Paths, config: Dict[str, Any],
                 duration_extractor: DurationExtractor) -> None:
        self.paths = paths
        self.config = config
        self.duration_extractor = duration_extractor

    def extract_attentions(self, model, max_batch_size: int = 32,
                           seed: int = 42, device=None) -> float:
        """Run the teacher ``model`` (moved to ``device``: CUDA unless the
        caller names another) over the whole dataset and save each item's
        attention [mel_len, x_len] to ``att_pred/<id>.npy``; returns the
        mean sharpness score."""
        import torch

        from forwardtacotron_torch.utils.device import resolve_device

        device = resolve_device(device)
        model.to(device).eval()
        generator = torch.Generator(device=device).manual_seed(seed)
        loader = get_binned_taco_dataloader(self.paths, max_batch_size)
        sum_score, n_items = 0.0, 0
        with torch.inference_mode():
            for batch in loader:
                inputs = {k: torch.as_tensor(batch[k], device=device)
                          for k in ('x', 'mel', 'speaker_emb')}
                _, _, attn = model(inputs, r=1, prenet_dropout_on=True,
                                   generator=generator)
                attn = attn.float().cpu().numpy()
                _, sharp = attention_score(attn, batch['mel_len'], r=1)
                sum_score += float(sharp.sum())
                n_items += len(sharp)
                for b, item_id in enumerate(batch['item_id']):
                    mel_len = int(batch['mel_len'][b])
                    x_len = int(batch['x_len'][b])
                    np.save(str(self.paths.att_pred / f'{item_id}.npy'),
                            attn[b, :mel_len, :x_len], allow_pickle=False)
        return sum_score / max(n_items, 1)

    def extract_durations(self, num_workers: int = 0
                          ) -> Dict[str, DurationStats]:
        """Durations from the saved attentions: writes ``alg/<id>.npy``
        (int64) and returns each item's DurationStats. ``num_workers`` > 1
        spreads the items over a ``spawn`` pool."""
        dataset = (unpickle_binary(self.paths.train_dataset)
                   + unpickle_binary(self.paths.val_dataset))
        text_dict = unpickle_binary(self.paths.text_dict)
        items = [item_id for item_id, _ in dataset
                 if (self.paths.att_pred / f'{item_id}.npy').is_file()]

        init_args = (str(self.paths.data), text_dict,
                     self.duration_extractor.silence_threshold,
                     self.duration_extractor.silence_prob_shift)
        # build the native DP once, here, before the workers load it
        load_library('duration_dp')
        if num_workers and num_workers > 1:
            import multiprocessing
            ctx = multiprocessing.get_context('spawn')
            with ProcessPoolExecutor(max_workers=num_workers,
                                     mp_context=ctx,
                                     initializer=_init_worker,
                                     initargs=init_args) as pool:
                results = list(pool.map(_extract_one, items, chunksize=4))
        else:
            _init_worker(*init_args)
            results = [_extract_one(i) for i in items]

        stats = {}
        for res in results:
            if res is None:
                continue
            stats[res.item_id] = DurationStats(
                att_sharpness_score=res.att_score,
                att_align_score=res.align_score,
                max_consecutive_ones=max_consecutive_ones(res.durations),
                max_duration=int(np.max(res.durations)))
        return stats
