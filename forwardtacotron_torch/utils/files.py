"""File helpers: globbing, YAML configs, pickles and schedule parsing (the
port's copy of forwardtacotron_tpu/utils/files.py; reference
utils/files.py)."""

import pickle
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import yaml


def get_files(path: Union[str, Path], extension: str = '.wav') -> List[Path]:
    """Every file under ``path`` with the given extension, recursively,
    sorted for determinism."""
    return sorted(Path(path).expanduser().resolve().rglob(f'*{extension}'))


def read_config(path: Union[str, Path]) -> Dict[str, Any]:
    with open(str(path), 'r', encoding='utf-8') as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def save_config(config: Dict[str, Any], path: Union[str, Path]) -> None:
    with open(str(path), 'w+', encoding='utf-8') as f:
        yaml.dump(config, f, default_flow_style=False)


def pickle_binary(data: Any, file: Union[str, Path]) -> None:
    with open(str(file), 'wb') as f:
        pickle.dump(data, f)


def unpickle_binary(file: Union[str, Path]) -> Any:
    with open(str(file), 'rb') as f:
        return pickle.load(f)


def parse_schedule(schedule: List[str]) -> List[Tuple]:
    """Parse CSV schedule rows: Tacotron rows are ``r, lr, max_step,
    batch_size``, forward rows ``lr, max_step, batch_size`` (reference
    utils/files.py:33-43). Values may use underscores (``10_000``) and
    scientific notation."""
    parsed = []
    for row in schedule:
        if isinstance(row, str):
            parts = [p.strip().replace('_', '') for p in row.split(',')]
        else:
            parts = list(row)
        nums = [float(p) for p in parts]
        if len(nums) == 4:
            r, lr, step, bs = nums
            parsed.append((int(r), lr, int(step), int(bs)))
        elif len(nums) == 3:
            lr, step, bs = nums
            parsed.append((lr, int(step), int(bs)))
        else:
            raise ValueError(f'Cannot parse schedule row: {row!r}')
    return parsed
