"""Data layer of the teacher's and the forward models' training and of
attention extraction: npy-backed datasets, length-binned sampling,
bucketed collation, a threaded prefetch loader and the binned loader of
equal-token-length batches.

The port's copy of the training subset of forwardtacotron_tpu/data/dataset.py
(itself the reference's utils/dataset.py): the same numpy code, so that both
packages draw the same batches from the same seed. Collators round padded
lengths up to ``bucket_multiple``, which bounds the shapes a training run
sees. Mels are emitted channels-last [B, T, n_mels]; the on-disk npy layout
stays [n_mels, T].
"""

import pickle
import queue
import threading
from collections import Counter
from dataclasses import dataclass
from random import Random
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from forwardtacotron_torch.text.tokenizer import Tokenizer
from forwardtacotron_torch.utils.files import unpickle_binary
from forwardtacotron_torch.utils.paths import Paths

SHUFFLE_SEED = 42
PAD_VALUE = -11.5129


@dataclass
class DurationStats:
    att_sharpness_score: float
    att_align_score: float
    max_consecutive_ones: int
    max_duration: int


class _StatsUnpickler(pickle.Unpickler):
    """Reads duration statistics pickled by either package's preprocessing
    into this module's DurationStats (the classes have the same fields)."""

    def find_class(self, module, name):
        if name == 'DurationStats':
            return DurationStats
        return super().find_class(module, name)


def load_duration_stats(path) -> Dict[str, DurationStats]:
    with open(str(path), 'rb') as f:
        return _StatsUnpickler(f).load()


class DataFilter:
    """Keeps items whose duration stats pass all four thresholds
    (reference utils/dataset.py:28-51)."""

    def __init__(self,
                 duration_stats: Dict[str, DurationStats],
                 min_attention_alignment: float,
                 min_attention_sharpness: float,
                 max_consecutive_duration_ones: int,
                 max_duration: int) -> None:
        self._stats = duration_stats
        self._min_align = min_attention_alignment
        self._min_sharp = min_attention_sharpness
        self._max_ones = max_consecutive_duration_ones
        self._max_dur = max_duration

    def __call__(self, dataset: List[Tuple[str, int]]) -> List[Tuple[str, int]]:
        kept = []
        for item_id, mel_len in dataset:
            s = self._stats[item_id]
            if (s.att_align_score >= self._min_align
                    and s.att_sharpness_score >= self._min_sharp
                    and s.max_consecutive_ones <= self._max_ones
                    and s.max_duration <= self._max_dur):
                kept.append((item_id, mel_len))
        return kept


class BinnedLengthSampler:
    """Approximate length bucketing: sort by length, shuffle within bins of
    ``bin_size``, shuffle bin order (reference utils/dataset.py:54-83)."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 bin_size: int, seed: Optional[int] = None) -> None:
        assert bin_size % batch_size == 0
        self.sorted_idx = np.argsort(np.asarray(lengths))
        self.batch_size = batch_size
        self.bin_size = bin_size
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[int]:
        idx = self.sorted_idx.copy()
        n_bins = len(idx) // self.bin_size
        bins = [idx[i * self.bin_size:(i + 1) * self.bin_size].copy()
                for i in range(n_bins)]
        for b in bins:
            self._rng.shuffle(b)
        order = self._rng.permutation(len(bins))
        out = [bins[i] for i in order]
        tail = idx[n_bins * self.bin_size:].copy()
        self._rng.shuffle(tail)
        out.append(tail)
        return iter(np.concatenate(out).tolist())

    def __len__(self) -> int:
        return len(self.sorted_idx)


class TacoDataset:
    """Tokens + mel + speaker embedding (reference utils/dataset.py:86-113)."""

    def __init__(self, paths: Paths, dataset_ids: List[str],
                 text_dict: Dict[str, str], speaker_dict: Dict[str, str],
                 tokenizer: Tokenizer) -> None:
        self.paths = paths
        self.metadata = list(dataset_ids)
        self.text_dict = text_dict
        self.speaker_dict = speaker_dict
        self.tokenizer = tokenizer

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item_id = self.metadata[index]
        x = self.tokenizer(self.text_dict[item_id])
        mel = np.load(str(self.paths.mel / f'{item_id}.npy'))
        speaker_emb = np.load(str(self.paths.speaker_emb / f'{item_id}.npy'))
        return {'x': np.asarray(x, np.int64), 'mel': mel, 'item_id': item_id,
                'mel_len': mel.shape[-1], 'x_len': len(x),
                'speaker_emb': speaker_emb,
                'speaker_name': self.speaker_dict[item_id]}

    def __len__(self) -> int:
        return len(self.metadata)


class ForwardDataset(TacoDataset):
    """Adds durations, phoneme pitch/energy, and the derived 3-class
    pitch_cond (reference utils/dataset.py:116-149)."""

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = super().__getitem__(index)
        item_id = item['item_id']
        dur = np.load(str(self.paths.alg / f'{item_id}.npy'))
        pitch = np.load(str(self.paths.phon_pitch / f'{item_id}.npy'))
        energy = np.load(str(self.paths.phon_energy / f'{item_id}.npy'))
        pitch_cond = np.ones(pitch.shape)
        pitch_cond[pitch != 0] = 2
        item.update({'dur': dur, 'pitch': pitch, 'energy': energy,
                     'pitch_cond': pitch_cond})
        return item


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _pad1d(x: np.ndarray, length: int) -> np.ndarray:
    return np.pad(x, (0, length - len(x)), mode='constant')


class TacoCollator:
    """Pads tokens to max (optionally bucket-rounded) and mels to
    ``max + 1`` rounded up to a multiple of r with the log-floor constant
    (reference utils/dataset.py:210-236); ``bucket_multiple`` > 1 rounds the
    padded shapes up further."""

    def __init__(self, r: int, bucket_multiple: int = 1) -> None:
        self.r = r
        self.bucket = bucket_multiple

    def __call__(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        x_lens = np.asarray([b['x_len'] for b in batch], np.int64)
        max_x = _round_up(int(x_lens.max()), self.bucket)
        x = np.stack([_pad1d(b['x'], max_x) for b in batch]).astype(np.int64)

        mel_lens = np.asarray([b['mel_len'] for b in batch], np.int64)
        max_mel = int(mel_lens.max()) + 1
        if max_mel % self.r != 0:
            max_mel += self.r - max_mel % self.r
        max_mel = _round_up(max_mel, self.bucket)
        mel = np.stack([
            np.pad(b['mel'], ((0, 0), (0, max_mel - b['mel'].shape[-1])),
                   mode='constant', constant_values=PAD_VALUE)
            for b in batch])

        return {'x': x, 'mel': mel.transpose(0, 2, 1).astype(np.float32),
                'item_id': [b['item_id'] for b in batch],
                'x_len': x_lens, 'mel_len': mel_lens,
                'speaker_emb': np.stack([b['speaker_emb'] for b in batch]).astype(np.float32),
                'speaker_name': [b['speaker_name'] for b in batch]}


class ForwardCollator:
    """Adds dur/pitch/energy/pitch_cond padded to the token length
    (reference utils/dataset.py:239-263)."""

    def __init__(self, taco_collator: TacoCollator) -> None:
        self.taco_collator = taco_collator

    def __call__(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        out = self.taco_collator(batch)
        max_x = out['x'].shape[1]
        for key, dtype in (('dur', np.float32), ('pitch', np.float32),
                           ('energy', np.float32), ('pitch_cond', np.int64)):
            out[key] = np.stack([
                _pad1d(np.asarray(b[key][:max_x]), max_x) for b in batch
            ]).astype(dtype)
        return out


class DataLoader:
    """Minimal host-side loader: sampler order (or dataset order) ->
    batches -> collate, PREFETCH batches ahead on a background thread."""

    PREFETCH = 2

    def __init__(self, dataset, collate_fn, batch_size: int,
                 sampler=None) -> None:
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.sampler = sampler

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        order = (list(self.sampler) if self.sampler is not None
                 else list(range(len(self.dataset))))
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        sentinel = object()

        def producer():
            try:
                for idx in batches:
                    q.put(self.collate_fn([self.dataset[i] for i in idx]))
                q.put(sentinel)
            except BaseException as e:  # surface in the consumer: a
                q.put(e)                # swallowed error would silently
                                        # truncate the epoch

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                thread.join()
                raise item
            yield item
        thread.join()


class BinnedTacoDataLoader:
    """Batches of identical token length for padding-free attention
    extraction (reference utils/dataset.py:152-207): items sorted by token
    count, each run of equal counts cut into batches of at most
    ``max_batch_size``, the batches shuffled by ``Random(SHUFFLE_SEED)``,
    so that the batches and their order are the JAX package's."""

    def __init__(self, paths: Paths, dataset: List[Tuple[str, int]],
                 max_batch_size: int = 8) -> None:
        tokenizer = Tokenizer()
        text_dict = unpickle_binary(paths.text_dict)
        speaker_dict = unpickle_binary(paths.speaker_dict)

        id_lens = sorted(((item_id, len(tokenizer(text_dict[item_id])))
                          for item_id, _ in dataset), key=lambda p: p[1])
        dataset_ids = [i for i, _ in id_lens]
        lens = np.asarray([n for _, n in id_lens], int)

        split_points = np.where(np.diff(lens, append=0, prepend=0) != 0)[0]
        indices = list(range(len(dataset_ids)))
        all_batches = []
        for a, b in zip(split_points[:-1], split_points[1:]):
            group = indices[a:b]
            all_batches.extend(group[i:i + max_batch_size]
                               for i in range(0, len(group), max_batch_size))
        Random(SHUFFLE_SEED).shuffle(all_batches)

        self.all_batches = all_batches
        self.taco_dataset = TacoDataset(paths=paths, dataset_ids=dataset_ids,
                                        text_dict=text_dict,
                                        speaker_dict=speaker_dict,
                                        tokenizer=tokenizer)
        self.collator = TacoCollator(r=1)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for batch in self.all_batches:
            yield self.collator([self.taco_dataset[i] for i in batch])

    def __len__(self) -> int:
        return len(self.all_batches)


def get_binned_taco_dataloader(paths: Paths, max_batch_size: int = 8
                               ) -> BinnedTacoDataLoader:
    """The binned loader over the train and val splits together."""
    dataset = (unpickle_binary(paths.train_dataset)
               + unpickle_binary(paths.val_dataset))
    return BinnedTacoDataLoader(paths=paths, dataset=dataset,
                                max_batch_size=max_batch_size)


def shard_for_host(data: List[Tuple[str, int]], process_index: int,
                   process_count: int) -> List[Tuple[str, int]]:
    """This process's share of (id, length) items for data parallelism,
    balanced by length: sorted by length descending (ties by id) and dealt
    serpentine (0..P-1, P-1..0, ...), so the ranks' frame totals differ by
    at most one longest item. Each rank then bins its own share."""
    if process_count <= 1:
        return data
    order = sorted(range(len(data)), key=lambda i: (-data[i][1], data[i][0]))
    mine = []
    for rank, idx in enumerate(order):
        block, pos = divmod(rank, process_count)
        host = pos if block % 2 == 0 else process_count - 1 - pos
        if host == process_index:
            mine.append(data[idx])
    return mine


# the token-axis keys of a collated batch; 'mel' is the frame axis
TOKEN_KEYS = ('x', 'dur', 'pitch', 'energy', 'pitch_cond')


def pad_to(batch: Dict[str, Any], n_tokens: int,
           n_frames: int) -> Dict[str, Any]:
    """A collated batch padded further, as the collators pad, to
    ``n_tokens`` tokens and ``n_frames`` mel frames: the common shape of
    the ranks' batches in a data-parallel step."""
    out = dict(batch)
    for key in TOKEN_KEYS:
        if key in out:
            v = out[key]
            out[key] = np.pad(v, ((0, 0), (0, n_tokens - v.shape[1])))
    mel = out['mel']
    out['mel'] = np.pad(mel, ((0, 0), (0, n_frames - mel.shape[1]), (0, 0)),
                        constant_values=PAD_VALUE)
    return out


def get_taco_dataloaders(paths: Paths, batch_size: int, r: int,
                         max_mel_len: int, filter_duration_stats: bool,
                         min_attention_alignment: float,
                         min_attention_sharpness: float,
                         max_consecutive_ones: int, max_duration: int,
                         bucket_multiple: int = 1,
                         seed: Optional[int] = None,
                         process_index: int = 0, process_count: int = 1
                         ) -> Tuple[DataLoader, DataLoader]:
    """(train, val) loaders of the teacher's items, mels padded to a
    multiple of ``r``; ``seed`` seeds the training sampler (None draws a
    fresh order, as the JAX package's factory does). The train loader
    holds this process's share (``shard_for_host``), the val loader
    every item."""
    return _dataloaders(
        paths, TacoDataset, TacoCollator(r=r, bucket_multiple=bucket_multiple),
        batch_size, seed, (process_index, process_count), max_mel_len,
        filter_duration_stats, min_attention_alignment,
        min_attention_sharpness, max_consecutive_ones, max_duration)


def get_forward_dataloaders(paths: Paths, batch_size: int,
                            max_mel_len: int, filter_duration_stats: bool,
                            min_attention_alignment: float,
                            min_attention_sharpness: float,
                            max_consecutive_ones: int, max_duration: int,
                            bucket_multiple: int = 1,
                            seed: Optional[int] = None,
                            process_index: int = 0, process_count: int = 1
                            ) -> Tuple[DataLoader, DataLoader]:
    """(train, val) loaders; ``seed`` seeds the training sampler (None draws
    a fresh order, as the JAX package's factory does). The train loader
    holds this process's share (``shard_for_host``), the val loader every
    item."""
    return _dataloaders(
        paths, ForwardDataset,
        ForwardCollator(TacoCollator(r=1, bucket_multiple=bucket_multiple)),
        batch_size, seed, (process_index, process_count), max_mel_len,
        filter_duration_stats, min_attention_alignment,
        min_attention_sharpness, max_consecutive_ones, max_duration)


def _dataloaders(paths: Paths, dataset_cls, collator, batch_size: int,
                 seed: Optional[int], process: Tuple[int, int],
                 *filters) -> Tuple[DataLoader, DataLoader]:
    """The train loader (length-binned sampler over the process's share)
    and the val loader (in order) of ``dataset_cls`` over the filtered
    splits."""
    train_data, val_data = _get_filtered_datasets(paths, *filters)
    train_data = shard_for_host(train_data, *process)
    tokenizer = Tokenizer()
    text_dict = unpickle_binary(paths.text_dict)
    speaker_dict = unpickle_binary(paths.speaker_dict)
    train_ids, train_lens = zip(*train_data)
    val_ids, _ = zip(*val_data)
    train_set = DataLoader(
        dataset_cls(paths, list(train_ids), text_dict, speaker_dict,
                    tokenizer),
        collate_fn=collator, batch_size=batch_size,
        sampler=BinnedLengthSampler(train_lens, batch_size, batch_size * 3,
                                    seed=seed))
    val_set = DataLoader(
        dataset_cls(paths, list(val_ids), text_dict, speaker_dict, tokenizer),
        collate_fn=collator, batch_size=batch_size)
    return train_set, val_set


def _get_filtered_datasets(paths: Paths, max_mel_len: int,
                           filter_duration_stats: bool,
                           min_attention_alignment: float,
                           min_attention_sharpness: float,
                           max_consecutive_ones: int,
                           max_duration: int) -> Tuple[List[tuple], List[tuple]]:
    train_data = unpickle_binary(paths.train_dataset)
    val_data = unpickle_binary(paths.val_dataset)
    speaker_dict = unpickle_binary(paths.speaker_dict)

    train_data = _filter_max_len(train_data, max_mel_len)
    val_data = _filter_max_len(val_data, max_mel_len)

    if filter_duration_stats:
        stats = load_duration_stats(paths.duration_stats)
        data_filter = DataFilter(
            duration_stats=stats,
            min_attention_alignment=min_attention_alignment,
            min_attention_sharpness=min_attention_sharpness,
            max_consecutive_duration_ones=max_consecutive_ones,
            max_duration=max_duration)
        before = Counter(speaker_dict[i] for i, _ in train_data + val_data
                         if i in speaker_dict)
        train_data = data_filter(train_data)
        val_data = data_filter(val_data)
        after = Counter(speaker_dict[i] for i, _ in train_data + val_data
                        if i in speaker_dict)
        for speaker, count in after.most_common():
            print(f'{speaker}: using {count}/{before[speaker]} files')
        print(f'Total: {sum(after.values())} files, '
              f'removed {sum(before.values()) - sum(after.values())}')

    return train_data, val_data


def _filter_max_len(dataset: List[tuple], max_mel_len: Optional[int]) -> List[tuple]:
    if max_mel_len is None:
        return dataset
    return [(i, l) for i, l in dataset if l <= max_mel_len]
