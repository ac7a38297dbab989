"""Profiling and throughput observability: the port's counterpart of
forwardtacotron_tpu/utils/profiler.py on ``torch.profiler``.

``trace`` records the enclosed block (host ops and, on a card, its CUDA
kernels) into a Chrome trace file under ``log_dir``
(``<host>.<pid>.<ns>.pt.trace.json``, viewable in Perfetto, chrome://tracing
or TensorBoard's profile plugin); ``annotate`` names a region inside it
(``record_function``). ``ThroughputMeter`` counts audio-domain work
(frames/s, audio-seconds/s, tokens/s) between reports, and
``device_memory_stats`` reads the card's allocator.
"""

import contextlib
import os
import socket
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

import torch


@contextlib.contextmanager
def trace(log_dir: Union[str, Path], enabled: bool = True) -> Iterator[None]:
    """Profile the enclosed block into a trace file under ``log_dir``
    (written also when the block raises)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(
            log_dir / f'{socket.gethostname()}.{os.getpid()}.'
                      f'{time.time_ns()}.pt.trace.json'))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield


@dataclass
class ThroughputMeter:
    """Accumulates work counters between ``report`` calls."""
    hop_length: int = 256
    sample_rate: int = 22050
    _t0: float = field(default_factory=time.time)
    _frames: int = 0
    _tokens: int = 0
    _steps: int = 0

    def add(self, frames: int = 0, tokens: int = 0, steps: int = 1) -> None:
        self._frames += frames
        self._tokens += tokens
        self._steps += steps

    def report(self, reset: bool = True) -> Dict[str, float]:
        elapsed = max(time.time() - self._t0, 1e-9)
        out = {
            'steps_per_s': self._steps / elapsed,
            'frames_per_s': self._frames / elapsed,
            'tokens_per_s': self._tokens / elapsed,
            'audio_seconds_per_s':
                self._frames * self.hop_length / self.sample_rate / elapsed,
        }
        if reset:
            self._t0 = time.time()
            self._frames = self._tokens = self._steps = 0
        return out


def device_memory_stats(device: Union[str, torch.device] = 'cuda'
                        ) -> Optional[Dict[str, int]]:
    """Live and peak bytes of the card's allocator and the card's memory,
    as the JAX package names them; None for a CPU device (or without a
    card), where nothing reports them."""
    device = torch.device(device)
    if device.type != 'cuda' or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {'bytes_in_use': int(stats.get('allocated_bytes.all.current', 0)),
            'peak_bytes_in_use': int(stats.get('allocated_bytes.all.peak',
                                               0)),
            'bytes_limit': int(
                torch.cuda.get_device_properties(device).total_memory)}
