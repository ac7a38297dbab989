"""Metadata readers for the four supported dataset layouts (the port's copy
of forwardtacotron_tpu/text/recipes.py).

Parity with reference utils/text/recipes.py:13-77:
  - ``ljspeech``: pipe-separated ``id|text`` (last field is text)
  - ``ljspeech_multi``: ``id|speaker|text``
  - ``vctk``: tree of per-utterance .txt files, speaker = parent directory
  - ``pandas``: tab-separated table with file_id / speaker_id / text columns
Each reader returns ``(text_dict, speaker_dict)`` keyed by file id.
"""

from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

from forwardtacotron_torch.utils.files import get_files

DEFAULT_SPEAKER_NAME = 'default_speaker'

TextSpeakerDicts = Tuple[Dict[str, str], Dict[str, str]]


def read_metadata(path: Path,
                  metafile: str,
                  format: str,
                  n_workers: int = 1) -> TextSpeakerDicts:
    readers = {
        'ljspeech': lambda: read_ljspeech_format(Path(path) / metafile, multispeaker=False),
        'ljspeech_multi': lambda: read_ljspeech_format(Path(path) / metafile, multispeaker=True),
        'vctk': lambda: read_vctk_format(Path(path), n_workers=n_workers),
        'pandas': lambda: read_pandas_format(Path(path) / metafile),
    }
    if format not in readers:
        raise ValueError(f'Unknown metadata format: {format!r}, '
                         f'expected one of {sorted(readers)}')
    return readers[format]()


def read_ljspeech_format(path: Path, multispeaker: bool = False) -> TextSpeakerDicts:
    if not path.is_file():
        raise ValueError(f'Could not find metafile: {path}')
    text_dict, speaker_dict = {}, {}
    with open(str(path), encoding='utf-8') as f:
        for line in f:
            fields = line.split('|')
            file_id, text = fields[0], fields[-1].rstrip('\n')
            if multispeaker and len(fields) > 2:
                speaker = fields[-2]
            else:
                speaker = DEFAULT_SPEAKER_NAME
            text_dict[file_id] = text
            speaker_dict[file_id] = speaker
    return text_dict, speaker_dict


def _read_first_line(file: Path) -> Tuple[Path, str]:
    with open(str(file), encoding='utf-8') as f:
        return file, f.readline()


def read_vctk_format(path: Path,
                     n_workers: int = 1,
                     extension: str = '.txt') -> TextSpeakerDicts:
    files = get_files(path, extension=extension)
    text_dict, speaker_dict = {}, {}
    if n_workers > 1:
        # spawn: the caller may already hold a CUDA context
        import multiprocessing
        ctx = multiprocessing.get_context('spawn')
        with ProcessPoolExecutor(max_workers=n_workers,
                                 mp_context=ctx) as pool:
            results = list(pool.map(_read_first_line, files))
    else:
        results = [_read_first_line(f) for f in files]
    for file, line in results:
        text_id = file.name[:-len(extension)]
        text_dict[text_id] = line.rstrip('\n')
        speaker_dict[text_id] = file.parent.stem
    return text_dict, speaker_dict


def read_pandas_format(path: Path) -> TextSpeakerDicts:
    import pandas as pd
    if not path.is_file():
        raise ValueError(f'Could not find metafile: {path}')
    df = pd.read_csv(str(path), sep='\t', encoding='utf-8')
    text_dict, speaker_dict = {}, {}
    for _, row in df.iterrows():
        text_dict[row['file_id']] = row['text']
        speaker_dict[row['file_id']] = row['speaker_id']
    return text_dict, speaker_dict
