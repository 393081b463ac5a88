"""Compression codec for persisted blobs (port of ``repro.core.codec``).

Every blob is tagged with a one-byte codec id, so any reader opens any
file whatever codecs its environment has:

  * ``0x01``: zstd-compressed payload (needs ``zstandard`` to read);
  * ``0x02``: zlib-compressed payload (stdlib, always readable).

Writers take zstd when ``zstandard`` is importable and zlib otherwise; it
is an optional import, never a requirement.  Blobs from before the codec
byte existed are raw zstd frames (magic ``28 B5 2F FD``), which
:func:`decompress` still reads.

The structure inside is MessagePack.  The module carries its own writer
and reader of the subset the twin's payloads use (nil, bool, int,
float64, str, bin, array, map with str or int keys): its bytes are those
of ``msgpack.packb(payload, use_bin_type=True)``, so a blob written here
is byte for byte the JAX package's blob of the same payload under the
same codec, and the ``msgpack`` package is not needed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:  # optional dependency: never a hard import
    import zstandard  # type: ignore

    HAVE_ZSTD = True
except ImportError:  # pragma: no cover - environment dependent
    zstandard = None  # type: ignore
    HAVE_ZSTD = False

#: one-byte codec ids prepended to every blob
CODEC_ZSTD = b"\x01"
CODEC_ZLIB = b"\x02"

#: magic prefix of a raw (un-tagged, pre-codec-byte) zstd frame
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def default_codec() -> bytes:
    """The codec id a writer should use in this environment."""
    return CODEC_ZSTD if HAVE_ZSTD else CODEC_ZLIB


def compress(data: bytes, level: int = 3, codec: bytes | None = None) -> bytes:
    """Compress ``data`` and prepend the codec id byte.

    ``codec`` forces a specific codec; by default the best available one
    is used.
    """
    codec = default_codec() if codec is None else codec
    if codec == CODEC_ZSTD:
        if not HAVE_ZSTD:
            raise RuntimeError("zstd codec requested but zstandard is not installed")
        return CODEC_ZSTD + zstandard.ZstdCompressor(level=level).compress(data)
    if codec == CODEC_ZLIB:
        return CODEC_ZLIB + zlib.compress(data, level=min(level * 2, 9))
    raise ValueError(f"unknown codec id {codec!r}")


def decompress(blob: bytes) -> bytes:
    """Decompress a tagged blob (or a legacy raw zstd frame)."""
    if not blob:
        raise ValueError("empty blob")
    tag, payload = blob[:1], blob[1:]
    if tag == CODEC_ZSTD or blob[:4] == _ZSTD_MAGIC:
        if not HAVE_ZSTD:
            raise RuntimeError(
                "blob was written with the zstd codec but zstandard is not "
                "installed; install it or re-write the file with zlib")
        data = blob if blob[:4] == _ZSTD_MAGIC else payload
        return zstandard.ZstdDecompressor().decompress(data)
    if tag == CODEC_ZLIB:
        return zlib.decompress(payload)
    raise ValueError(f"unknown codec id {tag!r}")


def pack_array(x) -> dict:
    """Lossless wire form of one array: raw bytes + dtype + shape.

    Round-trips bit for bit: ``unpack_array(pack_array(x)) == x`` with
    dtype and shape kept.  A tensor is read through numpy (copied to the
    host first).
    """
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return {"b": a.tobytes(), "d": a.dtype.str, "s": list(a.shape)}


def unpack_array(rec: dict) -> np.ndarray:
    """Inverse of :func:`pack_array` (a read-only numpy array)."""
    return np.frombuffer(rec["b"], np.dtype(rec["d"])).reshape(rec["s"])


# -- the MessagePack subset ---------------------------------------------------

def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 1 << 8:
            out += b"\xcc" + struct.pack(">B", v)
        elif v < 1 << 16:
            out += b"\xcd" + struct.pack(">H", v)
        elif v < 1 << 32:
            out += b"\xce" + struct.pack(">I", v)
        elif v < 1 << 64:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise OverflowError(f"int {v} too large for MessagePack")
    elif v >= -32:
        out += struct.pack(">b", v)
    elif v >= -(1 << 7):
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -(1 << 15):
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -(1 << 31):
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -(1 << 63):
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"int {v} too small for MessagePack")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes,
              out: bytearray) -> None:
    """Header of a str/bin/array/map of ``n`` items: the fix form below
    ``fix_max`` (``fix`` is its tag, 0 where there is none), then 8-, 16-
    or 32-bit lengths (``codes`` holds the three tags; a zero tag skips
    that width)."""
    if fix and n < fix_max:
        out.append(fix | n)
    elif codes[0] and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out += bytes((codes[1],)) + struct.pack(">H", n)
    elif n < 1 << 32:
        out += bytes((codes[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"{n} items exceed MessagePack's 32-bit lengths")


def _pack(o, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(int(o), out)
    elif isinstance(o, float):
        out += b"\xcb" + struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, b"\xd9\xda\xdb", out)
        out += b
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        _pack_len(len(b), 0, 0, b"\xc4\xc5\xc6", out)
        out += b
    elif isinstance(o, (list, tuple)):
        _pack_len(len(o), 0x90, 16, b"\x00\xdc\xdd", out)
        for x in o:
            _pack(x, out)
    elif isinstance(o, dict):
        _pack_len(len(o), 0x80, 16, b"\x00\xde\xdf", out)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def packb(payload) -> bytes:
    """MessagePack bytes of ``payload``, as ``msgpack.packb(payload,
    use_bin_type=True)`` gives them (tuples as arrays, floats as float64)."""
    out = bytearray()
    _pack(payload, out)
    return bytes(out)


#: fixed-width scalars of the reader: tag -> struct format
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
#: length-prefixed items: tag -> (kind, length format)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: bytes, pos: int):
    if pos >= len(buf):
        raise ValueError("truncated MessagePack data")
    tag = buf[pos]
    pos += 1
    if tag < 0x80:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif tag == 0xC0:
        return None, pos
    elif tag == 0xC2:
        return False, pos
    elif tag == 0xC3:
        return True, pos
    elif tag in _SCALARS:
        fmt = _SCALARS[tag]
        end = pos + struct.calcsize(fmt)
        if end > len(buf):
            raise ValueError("truncated MessagePack data")
        return struct.unpack(fmt, buf[pos:end])[0], end
    elif tag in _SIZED:
        kind, fmt = _SIZED[tag]
        end = pos + struct.calcsize(fmt)
        if end > len(buf):
            raise ValueError("truncated MessagePack data")
        n = struct.unpack(fmt, buf[pos:end])[0]
        pos = end
    else:
        raise ValueError(f"MessagePack type 0x{tag:02x} is outside the "
                         "subset this codec reads")
    if kind in ("str", "bin"):
        if pos + n > len(buf):
            raise ValueError("truncated MessagePack data")
        raw = buf[pos:pos + n]
        return (raw.decode("utf-8") if kind == "str" else bytes(raw)), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            x, pos = _unpack(buf, pos)
            items.append(x)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes):
    """Inverse of :func:`packb`, as ``msgpack.unpackb(data, raw=False,
    strict_map_key=False)`` reads it (arrays as lists, int map keys kept)."""
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes of extra data after the payload")
    return obj


def dumps(payload, level: int = 3) -> bytes:
    """MessagePack-encode ``payload`` and compress it with the codec-id tag."""
    return compress(packb(payload), level=level)


def loads(blob: bytes):
    """Inverse of :func:`dumps` (int map keys kept, e.g. window ids)."""
    return unpackb(decompress(blob))
