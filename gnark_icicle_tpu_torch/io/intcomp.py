"""Delta + varint-byte integer streams (gnark's intcomp serialization layer).

Role parity: reference internal/backend/ioutils/intcomp.go — gnark frames
its constraint-system ``levels`` / ``instructions`` sections as
length-prefixed compressed ``[]uint32`` / ``[]uint64`` streams produced by
the ronanh/intcomp v1.1.0 Go library (delta coding + byte packing).

Container framing (byte-exact to ioutils.CompressAndWriteUints32/64 and
ReadAndDecompressUints32/64, intcomp.go:12-34,38-77):

    [n_words u64 LE][n_words x u32/u64 LE compressed words]

Word-stream payload — REVERSE-ENGINEERED byte-exactly from the only real
gnark ciphertext available in the reference tree
(internal/regression_tests/issue1045/testdata/issue1045.{r1cs,scs}; the
library itself is not vendored and this machine has no network). Every
tail block in those fixtures decodes/encodes byte-for-byte under this
model (tests/test_gnark_cs.py):

    block   : [word0][len][payload words ...][len]
      u32   : word0 = count;            len is its own word
      u64   : word0 = count | len<<32
      len   : number of words in the block after word0 (payload + trailer
              [+ the u32 len word itself]); duplicated as the last word
    payload : a byte stream packed MSB-first into words (first byte in
              bits W-8..W-1), final partial word padded with 0x80 bytes
    bytes   : per-value wrapped unsigned deltas d_i = v_i - v_{i-1}
              (v_{-1} = 0), each LEB128-varint encoded (low 7 bits first,
              0x80 = continuation)

Confirmed against the fixtures: single-byte deltas (<= 0x7f), the 0x80
padding, MSB-first byte order, len=3 (u32, 1 payload word) and len=2
(u64) with the trailing duplicate. UNVERIFIED extrapolations, isolated
here and called out per function: (1) multi-byte varint group order,
(2) the 128-value delta bit-pack block layout (the Go library switches
to binary packing at 128; the layout below self-round-trips and is
fuzzed in tests/test_intcomp.py, but no ciphertext pins it — the encoder
therefore still emits <=127-value varint blocks by DEFAULT, with
bitpack=True opting in), (3) whether ``len`` is really a length (it
could be a constant scheme tag that coincidentally equals these values —
the two readings only diverge for payloads > 1 word).

Copied whole from gnark_icicle_tpu/io/intcomp.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_io.py holds it to the original.
"""

from __future__ import annotations

import struct

# The Go library bit-packs groups of 128; everything below that goes
# through the varint tail path that the fixtures pin down. By default we
# chunk all data into <=127-value varint blocks so every emitted block
# stays inside the byte-verified regime; bitpack=True opts into the
# 128-value delta bit-pack blocks below.
_BLOCK = 127
_BITPACK = 128


# -- >=128-value delta bit-pack blocks ---------------------------------------
# The Go library switches to binary packing for full 128-value groups:
# wrapped deltas, the block's max delta bit width b, then 128 deltas packed
# into ceil(128*b/W) words. No ciphertext in the reference tree exercises
# this regime (the issue1045 fixtures only contain tail blocks), so the
# exact header/word layout here is EXTRAPOLATED within the observed block
# framing and kept SELF-CONSISTENT (encoder and decoder round-trip each
# other, fuzzed in tests/test_intcomp.py): a real gnark file whose full
# blocks deviate fails the trailer/shape checks loudly instead of
# mis-decoding. Layout used:
#   u32 : [128][len][b][packed words ...][len]        len = npacked + 3
#   u64 : [128 | len<<32][b][packed words ...][len]   len = npacked + 2
# Deltas are packed LSB-first: value i occupies bits [i*b, (i+1)*b) of the
# packed little-endian bit stream.


def _bitpack_words(deltas, b: int, width: int) -> list[int]:
    if b == 0:
        return []
    total = _BITPACK * b
    n_words = -(-total // width)
    words = [0] * n_words
    for i, d in enumerate(deltas):
        bit = i * b
        wi, off = divmod(bit, width)
        words[wi] |= (d << off) & ((1 << width) - 1)
        spill = off + b - width
        if spill > 0:
            words[wi + 1] |= d >> (b - spill)
    return words


def _bitunpack_words(words, b: int, width: int) -> list[int]:
    if b == 0:
        return [0] * _BITPACK
    mask = (1 << b) - 1
    out = []
    for i in range(_BITPACK):
        bit = i * b
        wi, off = divmod(bit, width)
        v = words[wi] >> off
        spill = off + b - width
        if spill > 0:
            v |= (words[wi + 1] & ((1 << spill) - 1)) << (b - spill)
        out.append(v & mask)
    return out


def _encode_payload(deltas, width: int) -> list[int]:
    """Varint bytes, packed MSB-first into width-bit words, 0x80 pad."""
    byts = bytearray()
    for d in deltas:
        while d >= 0x80:
            byts.append((d & 0x7F) | 0x80)
            d >>= 7
        byts.append(d)
    bpw = width // 8
    while len(byts) % bpw:
        byts.append(0x80)
    words = []
    for lo in range(0, len(byts), bpw):
        w = 0
        for b in byts[lo : lo + bpw]:
            w = (w << 8) | b
        words.append(w)
    return words


def _decode_payload(words, count: int, width: int):
    """Inverse of _encode_payload: first `count` varint deltas."""
    bpw = width // 8
    byts = bytearray()
    for w in words:
        for i in range(bpw - 1, -1, -1):
            byts.append((w >> (8 * i)) & 0xFF)
    deltas = []
    pos = 0
    for _ in range(count):
        v = 0
        shift = 0
        while True:
            if pos >= len(byts):
                raise ValueError("intcomp: truncated varint payload")
            b = byts[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
        deltas.append(v)
    return deltas


def _compress(values, width: int, bitpack: bool = False) -> list[int]:
    mask = (1 << width) - 1
    out = []
    prev = 0
    lo = 0
    n = len(values)
    while lo < n:
        if bitpack and n - lo >= _BITPACK:
            blk = values[lo : lo + _BITPACK]
            lo += _BITPACK
            deltas = []
            for v in blk:
                deltas.append((v - prev) & mask)
                prev = v
            b = max((d.bit_length() for d in deltas), default=0)
            packed = _bitpack_words(deltas, b, width)
            if width == 32:
                blen = len(packed) + 3  # len word + b word + trailer
                out.append(_BITPACK)
                out.append(blen)
                out.append(b)
                out.extend(packed)
                out.append(blen)
            else:
                blen = len(packed) + 2  # b word + trailer
                out.append(_BITPACK | (blen << 32))
                out.append(b)
                out.extend(packed)
                out.append(blen)
            continue
        blk = values[lo : lo + _BLOCK]
        lo += len(blk)
        deltas = []
        for v in blk:
            deltas.append((v - prev) & mask)
            prev = v
        payload = _encode_payload(deltas, width)
        if width == 32:
            # len counts everything after word0: the len word itself,
            # the payload, and the trailing duplicate (fixture: 3)
            blen = len(payload) + 2
            out.append(len(blk))
            out.append(blen)
            out.extend(payload)
            out.append(blen)
        else:
            blen = len(payload) + 1  # payload + trailer (fixture: 2)
            out.append(len(blk) | (blen << 32))
            out.extend(payload)
            out.append(blen)
    # empty input compresses to zero words (the Go library returns its
    # output buffer unchanged; the ioutils frame then carries n_words=0)
    return out


def _uncompress(words, width: int) -> list[int]:
    mask = (1 << width) - 1
    out = []
    prev = 0
    off = 0
    while off < len(words):
        w0 = words[off]
        off += 1
        if width == 32:
            count = w0
            if off >= len(words):
                raise ValueError("intcomp: truncated block header")
            blen = words[off]
            off += 1
            n_payload = blen - 2
        else:
            count = w0 & 0xFFFFFFFF
            blen = w0 >> 32
            n_payload = blen - 1
        if n_payload < 0 or off + n_payload + 1 > len(words):
            raise ValueError("intcomp: truncated block")
        payload = words[off : off + n_payload]
        off += n_payload
        if words[off] != blen:
            raise ValueError(
                f"intcomp: block trailer {words[off]} != len {blen} — "
                "likely an unverified-format block (see module docstring)"
            )
        off += 1
        if count > 128:
            raise ValueError(
                f"intcomp: block claims {count} values — outside both the "
                "varint tail regime (<128) and the bit-pack regime (==128)"
            )
        if count == _BITPACK:
            # full-group delta bit-pack block (extrapolated layout — see
            # the module docstring; shape mismatches fail loudly above)
            if not payload:
                raise ValueError("intcomp: bit-pack block missing width")
            b = payload[0]
            if b > width:
                raise ValueError(
                    f"intcomp: bit-pack width {b} > word width {width}"
                )
            expect = -(-(_BITPACK * b) // width) if b else 0
            if len(payload) - 1 != expect:
                raise ValueError(
                    f"intcomp: bit-pack block has {len(payload) - 1} packed "
                    f"words, want {expect} for width {b}"
                )
            deltas = _bitunpack_words(payload[1:], b, width)
        else:
            deltas = _decode_payload(payload, count, width)
        for d in deltas:
            prev = (prev + d) & mask
            out.append(prev)
    return out


def compress_u32(values, bitpack: bool = False) -> list[int]:
    """[]uint32 -> compressed u32 words (≙ intcomp.CompressUint32).

    bitpack=False (default) stays inside the byte-verified varint regime;
    bitpack=True emits 128-value delta bit-pack blocks (extrapolated
    layout — self-round-trips, not validated against Go ciphertext)."""
    return _compress([v & 0xFFFFFFFF for v in values], 32, bitpack)


def uncompress_u32(words) -> list[int]:
    return _uncompress(words, 32)


def compress_u64(values, bitpack: bool = False) -> list[int]:
    """[]uint64 -> compressed u64 words (≙ intcomp.CompressUint64)."""
    return _compress([v & 0xFFFFFFFFFFFFFFFF for v in values], 64, bitpack)


def uncompress_u64(words) -> list[int]:
    return _uncompress(words, 64)


# -- container framing (ioutils.go byte layout) ------------------------------

def write_u32_stream(out: bytearray, values) -> None:
    """≙ ioutils.CompressAndWriteUints32: u64 word-count + LE u32 words."""
    words = compress_u32(values)
    out += struct.pack("<Q", len(words))
    out += struct.pack(f"<{len(words)}I", *words)


def read_u32_stream(buf: bytes, off: int):
    """≙ ioutils.ReadAndDecompressUints32. Returns (values, new_off)."""
    if len(buf) - off < 8:
        raise ValueError("intcomp: truncated u32 stream header")
    (n_words,) = struct.unpack_from("<Q", buf, off)
    off += 8
    if len(buf) - off < 4 * n_words:
        raise ValueError("intcomp: truncated u32 stream body")
    words = struct.unpack_from(f"<{n_words}I", buf, off)
    return uncompress_u32(list(words)), off + 4 * n_words


def write_u64_stream(out: bytearray, values) -> None:
    """≙ ioutils.CompressAndWriteUints64."""
    words = compress_u64(values)
    out += struct.pack("<Q", len(words))
    out += struct.pack(f"<{len(words)}Q", *words)


def read_u64_stream(buf: bytes, off: int):
    """≙ ioutils.ReadAndDecompressUints64. Returns (values, new_off)."""
    if len(buf) - off < 8:
        raise ValueError("intcomp: truncated u64 stream header")
    (n_words,) = struct.unpack_from("<Q", buf, off)
    off += 8
    if len(buf) - off < 8 * n_words:
        raise ValueError("intcomp: truncated u64 stream body")
    words = struct.unpack_from(f"<{n_words}Q", buf, off)
    return uncompress_u64(list(words)), off + 8 * n_words
