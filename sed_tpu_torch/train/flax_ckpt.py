"""Reader of ``sed_tpu``'s msgpack checkpoints, without flax or msgpack.

``sed_tpu`` writes a checkpoint with ``flax.serialization.to_bytes`` of its
train state (``sed_tpu/train/checkpoint.py``): one msgpack map
``{"step", "params", "batch_stats", "opt_state"}`` whose leaves are numpy
arrays in msgpack's extension type 1, each a nested msgpack array
``(shape, dtype name, C-order bytes)``.  flax also writes numpy scalars
(type 3, the same payload), Python complex numbers (type 2, a nested
``(real, imag)``) and, for arrays over 2**30 bytes, maps
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``.

:func:`read_flax_checkpoint` decodes that subset of msgpack in pure Python
and numpy and returns the nested dict with numpy arrays as leaves.  Anything
outside the subset raises ``ValueError`` naming the byte offset.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
STATE_KEYS = ("step", "params", "batch_stats", "opt_state")

# Fixed-width scalars: type byte -> struct format (big-endian).
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# Length-prefixed types: type byte -> (kind, width of the length).
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Decoder:
    """Decodes one msgpack value from ``data``; ``base`` is the offset of
    ``data`` in the file, so nested payloads report file offsets."""

    def __init__(self, data, base: int = 0):
        self.data = memoryview(data)
        self.base = base
        self.pos = 0

    def fail(self, at: int, what: str):
        raise ValueError(f"flax checkpoint: {what} at byte {self.base + at}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            self.fail(self.pos, f"truncated value (needs {n} more bytes)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def value(self):
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, at)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.text(b & 0x1f, at)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            fmt = _SCALARS[b]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if b in _FIXEXT:
            code = struct.unpack(">b", self.take(1))[0]
            return self.ext(code, _FIXEXT[b], at)
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.uint(width)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.text(n, at)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n, at)
            code = struct.unpack(">b", self.take(1))[0]
            return self.ext(code, n, at)
        self.fail(at, f"msgpack type byte 0x{b:02x} is not used by flax")

    def text(self, n: int, at: int) -> str:
        try:
            return bytes(self.take(n)).decode("utf-8")
        except UnicodeDecodeError:
            self.fail(at, "a string that is not UTF-8")

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if not isinstance(key, (str, int)):
                self.fail(key_at, f"a map key of type {type(key).__name__}")
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int, at: int):
        payload_at = self.base + self.pos
        payload = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = self.ndarray(payload, payload_at, at)
            return arr if code == EXT_NDARRAY else arr[()]
        if code == EXT_COMPLEX:
            pair = _Decoder(payload, payload_at).whole()
            if not (isinstance(pair, list) and len(pair) == 2):
                self.fail(at, "a complex number that is not a (real, imag) pair")
            return complex(pair[0], pair[1])
        self.fail(at, f"msgpack extension type {code} is not used by flax")

    def ndarray(self, payload, payload_at: int, at: int) -> np.ndarray:
        tpl = _Decoder(payload, payload_at).whole()
        if not (isinstance(tpl, list) and len(tpl) == 3):
            self.fail(at, "an ndarray payload that is not (shape, dtype, bytes)")
        shape, name, buf = tpl
        if isinstance(name, bytes):
            name = name.decode("ascii", "replace")
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)
                and isinstance(name, str) and isinstance(buf, bytes)):
            self.fail(at, "an ndarray payload that is not (shape, dtype, bytes)")
        if name == "bfloat16":   # the upper half of a float32: widen exactly
            bits = np.frombuffer(buf, np.dtype("<u2")).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            try:
                dtype = np.dtype(name)
            except TypeError:
                self.fail(at, f"an ndarray of unknown dtype {name!r}")
            if dtype.hasobject or dtype.fields is not None:
                self.fail(at, f"an ndarray of unsupported dtype {name!r}")
            if len(buf) % dtype.itemsize:
                self.fail(at, f"{len(buf)} bytes of {name}")
            arr = np.frombuffer(buf, dtype)
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            self.fail(at, f"{arr.size} elements of {name} for shape {tuple(shape)}")
        return arr.reshape(shape).copy()

    def whole(self):
        """The value that fills ``data``; trailing bytes are an error."""
        out = self.value()
        if self.pos != len(self.data):
            self.fail(self.pos, f"{len(self.data) - self.pos} trailing bytes")
        return out


def _unchunk(tree):
    """Replace flax's chunked-array maps by the arrays they hold."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tree["shape"]
        chunks = tree["chunks"]
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        return flat.reshape(tuple(shape[str(i)] for i in range(len(shape))))
    return {k: _unchunk(v) for k, v in tree.items()}


def decode(data: bytes):
    """The msgpack tree of one flax ``to_bytes`` blob, chunked arrays
    joined."""
    return _unchunk(_Decoder(data).whole())


def read_flax_checkpoint(path: str) -> dict:
    """``{"step", "params", "batch_stats", "opt_state"}`` of a ``sed_tpu``
    ``.ckpt`` file, numpy arrays at the leaves (``opt_state`` keeps optax's
    layout: ``{"0": {"count", "mu", "nu", "nu_max"}, ...}``)."""
    with open(path, "rb") as f:
        tree = decode(f.read())
    if not isinstance(tree, dict) or not set(STATE_KEYS) <= set(tree):
        keys = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path}: not a sed_tpu train state (top level {keys}, "
                         f"expected {list(STATE_KEYS)}) at byte 0")
    return tree
