"""Device selection for the port's entry points."""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or left as the default) and no
    CUDA device is present: the port never moves to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'No CUDA device is available; pass device="cpu" to run on the '
            'CPU explicitly.')
    return dev
