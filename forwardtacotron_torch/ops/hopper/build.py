"""Build and load the hand-written Hopper kernels.

Each ``.cu`` source beside this file has a plain C interface and includes no
PyTorch header, so ``nvcc`` compiles it in seconds into a shared library that
``ctypes`` loads; the wrappers pass ``tensor.data_ptr()`` and the current
stream as integers. Libraries are built at first use into ``_build/`` next to
this file, named by a hash of their source, the shared headers (``*.cuh``)
and the flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built or imported when this
module is imported.

Target: ``sm_90a`` (H100). A failed build raises; there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / '_build'
SOURCES = ('highway', 'cbhg_front', 'griffin_lim', 'rnn', 'lr_bidir', 'lr',
           'rnn_bwd', 'mrf', 'pool')
ARCH_FLAGS = ['-gencode=arch=compute_90a,code=sm_90a']
NVCC_FLAGS = ['-O3', '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas=-v'] + ARCH_FLAGS

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then the toolkit's
    default install prefix."""
    for var in ('CUDA_HOME', 'CUDA_PATH'):
        home = os.environ.get(var)
        if home and (Path(home) / 'bin' / 'nvcc').is_file():
            return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.is_file():
        return str(default)
    raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit')


def _flags(defines: Sequence[str]) -> List[str]:
    return NVCC_FLAGS + [f'-D{d}' for d in defines]


def _lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    src = (SRC_DIR / f'{name}.cu').read_bytes() + b''.join(
        p.read_bytes() for p in sorted(SRC_DIR.glob('*.cuh')))
    flags = ' '.join(_flags(defines))
    digest = hashlib.sha1(src + flags.encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:12]}.so'


def build(names: List[str] = SOURCES,
          variants: Sequence[Tuple[str, Sequence[str]]] = ()
          ) -> Dict[str, float]:
    """Compile the named sources that are not built yet, and each
    ``(name, macros)`` of ``variants`` (the source with ``-D`` of each
    macro, a library of its own, labelled ``name-MACRO``), one ``nvcc`` per
    library, all started together. Returns seconds per label built (0 for a
    library already present). Raises with the compiler output on failure.
    The ``-Xptxas=-v`` report is kept in ``_build/<label>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, times = {}, {}
    for name, defines in [(n, ()) for n in names] + list(variants):
        label = '-'.join([name, *defines])
        out = _lib_path(name, defines)
        if out.is_file():
            times[label] = 0.0
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *_flags(defines), '-o', str(tmp),
               str(SRC_DIR / f'{name}.cu')]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT),
                        time.perf_counter(), tmp, out)
    errors = []
    for label, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[label] = time.perf_counter() - t0
        (BUILD_DIR / f'{label}.log').write_bytes(log)
        if proc.returncode != 0:
            errors.append(f'nvcc failed for {label}:\n'
                          f'{log.decode(errors="replace")}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError('\n'.join(errors))
    return times


def library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built with ``-D`` of each of
    ``defines``), built first if needed."""
    with _lock:
        key = (name, tuple(defines))
        lib = _libs.get(key)
        if lib is None:
            build([], [(name, tuple(defines))])
            lib = ctypes.CDLL(str(_lib_path(name, defines)))
            _libs[key] = lib
        return lib


def check(status: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f'{kernel}: CUDA launch failed with error {status}')


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
