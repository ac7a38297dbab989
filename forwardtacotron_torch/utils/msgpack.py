"""The MessagePack subset of flax's ``serialization.msgpack_serialize`` /
``msgpack_restore`` (flax 0.12), in plain Python: the JAX package's native
``.ckpt`` checkpoints are written and read with it, with no ``msgpack``
package.

Types: nil, bool, int (the smallest encoding, up to 64 bits), float (64
bits), str, bin, array (a list) and map (a dict), and flax's extension
types: code 1, an array packed as the msgpack array (shape, dtype name,
C-order bytes); code 3, a numpy scalar packed the same way. ``bfloat16``
has no numpy dtype: a bfloat16 leaf decodes to a ``torch.bfloat16`` tensor,
and a ``torch.bfloat16`` tensor encodes under flax's dtype name
``'bfloat16'``. Other torch tensors encode as their numpy arrays.

``msgpack_serialize`` writes every map's keys sorted, as flax's copy of
the tree through ``jax.tree_util`` leaves them, and refuses an array over
``MAX_CHUNK_SIZE`` bytes (flax would split it; no model here comes near
that size). ``msgpack_restore`` joins the arrays that flax split (a map
holding ``'__msgpack_chunked_array__'``, the shape and the flat chunks).
"""

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax's limit on the bytes of one array leaf
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = '__msgpack_chunked_array__'


# ----------------------------------------------------------------- writing

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xff)
    elif n >= 0:
        for code, fmt, top in ((0xcc, '>B', 1 << 8), (0xcd, '>H', 1 << 16),
                               (0xce, '>I', 1 << 32), (0xcf, '>Q', 1 << 64)):
            if n < top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f'integer too large for msgpack: {n}')
    else:
        for code, fmt, low in ((0xd0, '>b', -(1 << 7)), (0xd1, '>h', -(1 << 15)),
                               (0xd2, '>i', -(1 << 31)),
                               (0xd3, '>q', -(1 << 63))):
            if n >= low:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f'integer too small for msgpack: {n}')


def _pack_len(n: int, fix: Tuple[int, int], codes, out: bytearray) -> None:
    """A length header: the fix form (base, limit) when n < limit, else the
    first of ``codes`` ((code, struct format, limit), ...) that holds n."""
    base, limit = fix
    if n < limit:
        out.append(base | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f'object too large for msgpack: {n}')


_NO_FIX = (0, 0)
_STR = ((0xd9, '>B', 1 << 8), (0xda, '>H', 1 << 16), (0xdb, '>I', 1 << 32))
_BIN = ((0xc4, '>B', 1 << 8), (0xc5, '>H', 1 << 16), (0xc6, '>I', 1 << 32))
_ARRAY = ((0xdc, '>H', 1 << 16), (0xdd, '>I', 1 << 32))
_MAP = ((0xde, '>H', 1 << 16), (0xdf, '>I', 1 << 32))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, '>B', 1 << 8), (0xc8, '>H', 1 << 16), (0xc9, '>I', 1 << 32))


def _array_bytes(shape, dtype_name: str, data: bytes) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    out = bytearray()
    out.append(0x93)
    _pack_len(len(shape), (0x90, 16), _ARRAY, out)
    for n in shape:
        _pack_int(int(n), out)
    _pack(dtype_name, out)
    _pack(data, out)
    return bytes(out)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _pack_len(len(data), _NO_FIX, _EXT, out)
    out.append(code)
    out += data


def _pack_array(arr, code: int, out: bytearray) -> None:
    if torch.is_tensor(arr):
        if arr.dtype != torch.bfloat16:
            arr = arr.detach().cpu().numpy()
        else:
            t = arr.detach().cpu().contiguous()
            _pack_ext(code, _array_bytes(
                tuple(t.shape), 'bfloat16',
                t.view(torch.int16).numpy().tobytes()), out)
            return
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError('Object and structured dtypes not supported '
                         'for serialization of ndarrays.')
    _pack_ext(code, _array_bytes(arr.shape, arr.dtype.name,
                                 arr.tobytes('C')), out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(0xcb)
        out += struct.pack('>d', obj)
    elif type(obj) is str:
        data = obj.encode('utf-8')
        _pack_len(len(data), (0xa0, 32), _STR, out)
        out += data
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(len(data), _NO_FIX, _BIN, out)
        out += data
    elif type(obj) is list:
        _pack_len(len(obj), (0x90, 16), _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), (0x80, 16), _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        _pack_array(obj, EXT_NDARRAY, out)
    elif isinstance(obj, np.generic):
        _pack_array(np.asarray(obj), EXT_NPSCALAR, out)
    else:
        raise TypeError(f'can not serialize {type(obj).__name__!r} object')


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if torch.is_tensor(arr) \
        else arr.size * arr.dtype.itemsize


def _sorted(tree):
    """The tree with every map's keys sorted, as ``jax.tree_util`` rebuilds
    it; an array over MAX_CHUNK_SIZE bytes raises."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    if (isinstance(tree, np.ndarray) or torch.is_tensor(tree)) \
            and _nbytes(tree) > MAX_CHUNK_SIZE:
        raise ValueError(f'an array of {_nbytes(tree)} bytes is over the '
                         f'{MAX_CHUNK_SIZE} that one msgpack leaf may hold')
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes flax's ``msgpack_serialize`` writes for ``tree``."""
    out = bytearray()
    _pack(_sorted(tree), out)
    return bytes(out)


# ----------------------------------------------------------------- reading

class _Reader:

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, raw: bool = False) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.read_map(b & 0x0f, raw)
        if 0x90 <= b <= 0x9f:
            return [self.read(raw) for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.read_str(b & 0x1f, raw)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            n = self.unpack({0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}[b])
            return bytes(self.take(n))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[b])
            return self.read_ext(n)
        if b == 0xca:
            return self.unpack('>f')
        if b == 0xcb:
            return self.unpack('>d')
        ints = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q', 0xd0: '>b',
                0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if b in ints:
            return self.unpack(ints[b])
        if 0xd4 <= b <= 0xd8:
            return self.read_ext(1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            n = self.unpack({0xd9: '>B', 0xda: '>H', 0xdb: '>I'}[b])
            return self.read_str(n, raw)
        if b in (0xdc, 0xdd):
            n = self.unpack('>H' if b == 0xdc else '>I')
            return [self.read(raw) for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.read_map(self.unpack('>H' if b == 0xde else '>I'),
                                 raw)
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def read_str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode('utf-8')

    def read_map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.read(raw)
            out[k] = self.read(raw)
        return out

    def read_ext(self, n: int):
        code = self.take(1)[0]
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_bytes(data)
            return arr[()] if isinstance(arr, np.ndarray) else arr
        raise ValueError(f'unsupported msgpack extension type {code}')


def _array_from_bytes(data: bytes):
    """flax's ``_ndarray_from_bytes``; bfloat16 as a torch tensor."""
    shape, dtype_name, buffer = _Reader(data).read(raw=True)
    if dtype_name == b'bfloat16':
        if not buffer:      # torch.frombuffer refuses an empty buffer
            return torch.empty(shape, dtype=torch.bfloat16)
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order='C')


def _unchunk(tree):
    """Chunked arrays joined back (flax's ``_unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree['shape'][str(i)] for i in range(len(tree['shape']))]
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        if torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree of ``msgpack_serialize`` (or of flax's): dicts, lists,
    Python scalars, str and bytes, numpy arrays (read-only views of
    ``data``) and scalars, bfloat16 tensors."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError('trailing bytes after msgpack data')
    return _unchunk(tree)
