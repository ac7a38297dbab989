"""YAML config reading (the ``read_config`` of forwardtacotron_tpu/utils/files.py)."""

from pathlib import Path
from typing import Any, Dict, Union

import yaml


def read_config(path: Union[str, Path]) -> Dict[str, Any]:
    with open(str(path), 'r', encoding='utf-8') as f:
        return yaml.load(f, Loader=yaml.FullLoader)
