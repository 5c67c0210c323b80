"""The msgpack subset that flax checkpoints use, without ``msgpack``.

The JAX package writes its checkpoints with
``flax.serialization.msgpack_serialize`` (``to_bytes`` of a TrainState, or
a plain ``{'params', 'batch_stats'}`` tree from the reference converter).
``restore`` reads such a body and ``serialize`` writes one, byte for byte
as flax does for the same tree, so that a file written here loads in the
JAX package and the other way round. The subset:

- maps with str keys, lists, nil, bool, int, float, str and bin;
- ext type 1, an ndarray: its payload is a packed ``(shape, dtype name,
  C-order bytes)``;
- ext type 3, a numpy scalar, packed as a 0-d ndarray;
- the ``__msgpack_chunked_array__`` map that flax writes for an array
  over 2**30 bytes;
- ``bfloat16`` by name.

Tuples and NamedTuples reach the format as maps (``{'0': ...}``, field
names), so they come back as dicts. Arrays come back as read-only numpy
arrays, except bfloat16 ones, which numpy cannot hold: those come back
as ``torch.bfloat16`` tensors. ``serialize`` takes numpy arrays and
scalars and torch tensors as leaves.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30       # flax's limit for one array leaf, in bytes
CHUNKED = '__msgpack_chunked_array__'


class _Reader:
    """A cursor over msgpack bytes."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError('msgpack: truncated input')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack('>' + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n):
        return bytes(self.take(n)).decode('utf-8')

    def ext(self, n):
        code = self.unpack('b')
        return _ext_unpack(code, bytes(self.take(n)))

    def value(self):
        t = self.unpack('B')
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map_(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.value() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return self.str_(t & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in simple:
            return simple[t]
        fixed = {0xca: 'f', 0xcb: 'd', 0xcc: 'B', 0xcd: 'H', 0xce: 'I',
                 0xcf: 'Q', 0xd0: 'b', 0xd1: 'h', 0xd2: 'i', 0xd3: 'q'}
        if t in fixed:
            return self.unpack(fixed[t])
        sized = {0xc4: 'B', 0xc5: 'H', 0xc6: 'I', 0xd9: 'B', 0xda: 'H',
                 0xdb: 'I', 0xdc: 'H', 0xdd: 'I', 0xde: 'H', 0xdf: 'I',
                 0xc7: 'B', 0xc8: 'H', 0xc9: 'I'}
        if t in sized:
            n = self.unpack(sized[t])
            if t in (0xc4, 0xc5, 0xc6):
                return bytes(self.take(n))
            if t in (0xd9, 0xda, 0xdb):
                return self.str_(n)
            if t in (0xdc, 0xdd):
                return [self.value() for _ in range(n)]
            if t in (0xde, 0xdf):
                return self.map_(n)
            return self.ext(n)
        if 0xd4 <= t <= 0xd8:                    # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (t - 0xd4))
        raise ValueError(f'msgpack: type byte 0x{t:02x} is not in the '
                         'subset flax writes')

    def map_(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _loads(data):
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError('msgpack: trailing bytes after the top-level object')
    return out


def _array_from_bytes(payload):
    """(shape, dtype name, C bytes) -> a numpy array (bfloat16: a torch
    tensor), as flax's ``_ndarray_from_bytes``."""
    shape, name, buffer = _loads(payload)
    shape = tuple(shape)
    if name == 'bfloat16':
        if not buffer:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buffer),
                                dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext_unpack(code, payload):
    if code == EXT_NDARRAY:
        return _array_from_bytes(payload)
    if code == EXT_NPSCALAR:
        arr = _array_from_bytes(payload)
        return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
    raise ValueError(f'msgpack: ext type {code} is not one flax writes')


def _unchunk(tree):
    """Chunked-array maps back into arrays, in place (flax's
    ``_unchunk_array_leaves_in_place``)."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        cat = torch.cat if torch.is_tensor(chunks[0]) else np.concatenate
        return cat(chunks).reshape(shape)
    for key, val in tree.items():
        tree[key] = _unchunk(val)
    return tree


def restore(data) -> dict:
    """A flax msgpack body -> its tree (``flax.serialization.msgpack_restore``)."""
    return _unchunk(_loads(data))


# --------------------------------------------------------------- encoding

def _pack_uint(out, n, codes):
    for code, fmt, top in codes:
        if n <= top:
            out += struct.pack('>B' + fmt, code, n)
            return
    raise ValueError(f'msgpack: length {n} too large')


def _pack_int(out, v):
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out += struct.pack('>b' if v < 0 else '>B', v)
    elif v >= 0:
        for code, fmt, top in ((0xcc, 'B', 0xff), (0xcd, 'H', 0xffff),
                               (0xce, 'I', 0xffffffff),
                               (0xcf, 'Q', 0xffffffffffffffff)):
            if v <= top:
                out += struct.pack('>B' + fmt, code, v)
                return
        raise ValueError(f'msgpack: int {v} out of range')
    else:
        for code, fmt, low in ((0xd0, 'b', -0x80), (0xd1, 'h', -0x8000),
                               (0xd2, 'i', -0x80000000),
                               (0xd3, 'q', -0x8000000000000000)):
            if v >= low:
                out += struct.pack('>B' + fmt, code, v)
                return
        raise ValueError(f'msgpack: int {v} out of range')


def _pack_str(out, s):
    b = s.encode('utf-8')
    if len(b) <= 31:
        out.append(0xa0 | len(b))
    else:
        _pack_uint(out, len(b), ((0xd9, 'B', 0xff), (0xda, 'H', 0xffff),
                                     (0xdb, 'I', 0xffffffff)))
    out += b


def _pack_bin(out, b):
    _pack_uint(out, len(b), ((0xc4, 'B', 0xff), (0xc5, 'H', 0xffff),
                                 (0xc6, 'I', 0xffffffff)))
    out += b


def _pack_ext(out, code, payload):
    n = len(payload)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fix:
        out += struct.pack('>Bb', fix[n], code)
    else:
        _pack_uint(out, n, ((0xc7, 'B', 0xff), (0xc8, 'H', 0xffff),
                                (0xc9, 'I', 0xffffffff)))
        out += struct.pack('>b', code)
    out += payload


def _dtype_name(arr):
    if torch.is_tensor(arr):
        return str(arr.dtype).replace('torch.', '')
    return arr.dtype.name


def _array_bytes(arr) -> bytes:
    """(shape, dtype name, C bytes), packed as flax's ``_ndarray_to_bytes``."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        # through bytes: numpy has no bfloat16
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        shape = tuple(t.shape)
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError('object and structured dtypes cannot be '
                             'serialized')
        raw, shape = arr.tobytes('C'), arr.shape
    out = bytearray()
    out.append(0x93)
    _pack(out, [int(n) for n in shape])
    _pack_str(out, _dtype_name(arr))
    _pack_bin(out, raw)
    return bytes(out)


def _chunk(arr):
    """An array over ``MAX_CHUNK_SIZE`` bytes as flax's chunked map."""
    itemsize = arr.element_size() if torch.is_tensor(arr) \
        else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True,
            'shape': {str(i): int(n) for i, n in enumerate(arr.shape)},
            'chunks': {str(i): c for i, c in enumerate(chunks)}}


def _nbytes(arr):
    return arr.numel() * arr.element_size() if torch.is_tensor(arr) \
        else arr.size * arr.dtype.itemsize


def _pack(out, v, sort=True):
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out += struct.pack('>Bd', 0xcb, v)
    elif type(v) is str:
        _pack_str(out, v)
    elif type(v) in (bytes, bytearray):
        _pack_bin(out, bytes(v))
    elif type(v) is dict:
        n = len(v)
        if n <= 15:
            out.append(0x80 | n)
        else:
            _pack_uint(out, n, ((0xde, 'H', 0xffff),
                                    (0xdf, 'I', 0xffffffff)))
        for key, val in (sorted(v.items()) if sort else v.items()):
            if type(key) is not str:
                raise TypeError(f'msgpack: map key {key!r} is not a str')
            _pack_str(out, key)
            _pack(out, val, sort)
    elif type(v) is list:
        n = len(v)
        if n <= 15:
            out.append(0x90 | n)
        else:
            _pack_uint(out, n, ((0xdc, 'H', 0xffff),
                                    (0xdd, 'I', 0xffffffff)))
        for val in v:
            _pack(out, val)
    elif isinstance(v, np.ndarray) or torch.is_tensor(v):
        if _nbytes(v) > MAX_CHUNK_SIZE:
            # flax chunks after its sorted tree copy: insertion order
            _pack(out, _chunk(v), sort=False)
        else:
            _pack_ext(out, EXT_NDARRAY, _array_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(v)))
    else:
        raise TypeError(f'msgpack: {type(v).__name__} is not in the subset '
                        'flax writes')


def serialize(tree) -> bytes:
    """A tree of dicts (str keys), lists, scalars and arrays -> the bytes
    ``flax.serialization.msgpack_serialize`` writes for it. Map keys go
    out sorted, as that function's tree copy leaves them."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)
