"""Deterministic CBOR (RFC 8949 core deterministic encoding) with tags.

Role parity: gnark serializes the constraint-system body with
fxamacker/cbor's ``CoreDetEncOptions`` + a required-tag set for blueprint
and commitment types (reference constraint/marshal.go:128-145, 336-361).
This is a self-contained implementation of the subset gnark's structs
exercise: unsigned/negative integers, byte/text strings, arrays, maps with
bytewise-sorted keys, tags, booleans and null.

Core deterministic rules applied (matching fxamacker's encoder):
* shortest-form ("preferred") integer heads everywhere;
* definite lengths only;
* map keys sorted by their encoded bytes (length-first bytewise order).

Go-side conventions this mirrors:
* structs encode as maps keyed by exported field name (no cbor struct tags
  in the reference types);
* nil slices/maps encode as null (0xf6) — the decoder maps null to None
  and callers treat None/[]/{}, uniformly;
* interface values carry their registered tag (EncTagRequired).

Copied whole from gnark_icicle_tpu/io/cbor.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_io.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Tagged:
    """A CBOR tag wrapper (major type 6)."""

    tag: int
    value: object


def _head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    if arg < 0x100:
        return bytes([(major << 5) | 24, arg])
    if arg < 0x10000:
        return bytes([(major << 5) | 25]) + arg.to_bytes(2, "big")
    if arg < 0x100000000:
        return bytes([(major << 5) | 26]) + arg.to_bytes(4, "big")
    return bytes([(major << 5) | 27]) + arg.to_bytes(8, "big")


def encode(obj) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _encode(obj, out: bytearray) -> None:
    if obj is None:
        out += b"\xf6"
    elif obj is True:
        out += b"\xf5"
    elif obj is False:
        out += b"\xf4"
    elif isinstance(obj, Tagged):
        out += _head(6, obj.tag)
        _encode(obj.value, out)
    elif isinstance(obj, int):
        if obj >= 0:
            out += _head(0, obj)
        else:
            out += _head(1, -1 - obj)
    elif isinstance(obj, bytes):
        out += _head(2, len(obj)) + obj
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += _head(3, len(b)) + b
    elif isinstance(obj, (list, tuple)):
        out += _head(4, len(obj))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        items = [(encode(k), v) for k, v in obj.items()]
        items.sort(key=lambda kv: kv[0])  # bytewise-sorted encoded keys
        out += _head(5, len(items))
        for kb, v in items:
            out += kb
            _encode(v, out)
    else:
        raise TypeError(f"cbor: cannot encode {type(obj).__name__}")


def decode(buf: bytes, off: int = 0):
    """Decode one item. Returns (value, new_off)."""
    if off >= len(buf):
        raise ValueError("cbor: truncated input")
    ib = buf[off]
    major, info = ib >> 5, ib & 0x1F
    off += 1
    if info < 24:
        arg = info
    elif info == 24:
        arg = buf[off]
        off += 1
    elif info == 25:
        arg = int.from_bytes(buf[off : off + 2], "big")
        off += 2
    elif info == 26:
        arg = int.from_bytes(buf[off : off + 4], "big")
        off += 4
    elif info == 27:
        arg = int.from_bytes(buf[off : off + 8], "big")
        off += 8
    elif info == 31:
        raise ValueError("cbor: indefinite lengths not in deterministic form")
    else:
        raise ValueError(f"cbor: reserved additional info {info}")

    if major == 0:
        return arg, off
    if major == 1:
        return -1 - arg, off
    if major == 2:
        if off + arg > len(buf):
            raise ValueError("cbor: truncated byte string")
        return bytes(buf[off : off + arg]), off + arg
    if major == 3:
        if off + arg > len(buf):
            raise ValueError("cbor: truncated text string")
        return buf[off : off + arg].decode("utf-8"), off + arg
    if major == 4:
        items = []
        for _ in range(arg):
            v, off = decode(buf, off)
            items.append(v)
        return items, off
    if major == 5:
        d = {}
        for _ in range(arg):
            k, off = decode(buf, off)
            if isinstance(k, (list, dict)):
                raise ValueError("cbor: unhashable map key")
            v, off = decode(buf, off)
            d[k] = v
        return d, off
    if major == 6:
        v, off = decode(buf, off)
        return Tagged(arg, v), off
    # major 7 simple values
    if info == 20:
        return False, off
    if info == 21:
        return True, off
    if info == 22:
        return None, off
    raise ValueError(f"cbor: unsupported simple/float value {info}")
