"""g++ build and ctypes loader of the native (C++) components (the port's
copy of forwardtacotron_tpu/native/build.py).

A library is built at its first use, never at import, into ``_build/``
beside its source (a per-user directory under the temporary directory
when the package's directory is read-only), and rebuilt when the source is
newer. Concurrent builds race benignly: each compiles to its own file and
renames it into place.
"""

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_SRC_DIR = Path(__file__).parent
_LOADED = {}


def _cache_dir() -> Path:
    d = _SRC_DIR / '_build'
    try:
        d.mkdir(parents=True, exist_ok=True)
        probe = d / f'.probe{os.getpid()}'
        probe.touch()
        probe.unlink()
        return d
    except OSError:
        d = Path(tempfile.gettempdir()) / f'ftt_torch_native_{os.getuid()}'
        d.mkdir(parents=True, exist_ok=True)
        return d


def _build(src: Path, out: Path) -> bool:
    tmp = out.with_suffix(f'.tmp{os.getpid()}.so')
    cmd = ['g++', '-O3', '-std=c++17', '-shared', '-fPIC',
           '-fno-math-errno', str(src), '-o', str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Load ``<name>.cpp`` of this directory, building it if needed; None
    when it cannot be built or loaded (callers then take their numpy
    version)."""
    if name in _LOADED:
        return _LOADED[name]
    src = _SRC_DIR / f'{name}.cpp'
    lib = None
    if src.is_file():
        out = _cache_dir() / f'lib{name}.so'
        try:
            if (out.is_file() and out.stat().st_mtime >= src.stat().st_mtime) \
                    or _build(src, out):
                lib = ctypes.CDLL(str(out))
        except OSError:
            lib = None
    _LOADED[name] = lib
    return lib
