"""LZSS decompression circuits + matching host compressor
(≙ reference std/compress/lzss/snark.go:1-201, std/compress/io.go NumReader/
Pack, std/compress/internal/io.go BreakUpBytesIntoWords/RangeChecker).

The in-circuit decompressor proves `d = decompress(c, dict)` for an LZSS
byte stream: a 3-byte header [version-hi, version-lo, bypassed], then a
BIT stream (MSB-first within each byte) of symbols:

    literal  : 8 bits — the byte itself (never a delimiter value)
    backref  : 8-bit delimiter + 8-bit length (1..255 copies) + address
               bits, address = distance-1 back into dict ‖ produced-output
               (overlapping copies read bytes produced by the same copy)

Two backref types (≙ lzss.NewShortBackrefType / NewDynamicBackrefType):
    short   : delimiter 0xFE, SHORT_ADDR_BITS-bit address (recent window)
    dynamic : delimiter 0xFF, address bits sized to cover the whole
              dict ‖ output space

Literal 0xFE/0xFF bytes cannot appear as literals; the dictionary is
pre-AUGMENTED with both delimiter bytes (augment_dict, ≙ the upstream
"dict must come pre augmented" contract) and escapes are emitted as
length-1 dynamic backrefs into those positions.

FORMAT PROVENANCE: the reference's circuit consumes the external
consensys/compress library, which is not in the reference tree and not
fetchable here. The symbol values, field widths and address convention
above are reconstructed operationally from what snark.go enforces (3-byte
header with boolean bypass, bit-level stream, delimiter + 8-bit length-1 +
address distance into dict‖output, zero never a delimiter); the one free
parameter the consumer does not pin — exact address bit widths — is fixed
here (SHORT_ADDR_BITS, dynamic = bit_length(len(dict)+len(d))) and used
identically by the compressor, the circuit and the host decompressor, so
the scheme is self-consistent and round-trip tested over the reference's
own testdata corpus. Streams from the Go library may differ in those
widths; the circuit fails loudly (unsatisfied) rather than mis-decoding.

Copied from gnark_icicle_tpu/std/compress_lzss.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original. The
original passes ``_break_bits_hint`` to ``api.new_hint`` unnamed, so that its
name, and with it its id, comes from its module's path; the copy registers it
under the original's name (``BREAK_BITS``), so that both give one system.
"""

from __future__ import annotations

from ..constraint import hints as hintlib

SYMBOL_SHORT = 0xFE
SYMBOL_DYNAMIC = 0xFF
SHORT_ADDR_BITS = 14
LEN_BITS = 8  # length-1 field: copies of 1..256 bytes
HEADER = 3


def augment_dict(dict_bytes: bytes) -> bytes:
    """Append the delimiter symbols so escapes have something to reference
    (≙ lzss.AugmentDict)."""
    return bytes(dict_bytes) + bytes([SYMBOL_SHORT, SYMBOL_DYNAMIC])


def dyn_addr_bits(dict_len: int, max_out: int) -> int:
    """Address width of dynamic backrefs for a given output buffer size."""
    return max(1, (dict_len + max_out).bit_length())


# ---------------------------------------------------------------------------
# host compressor / decompressor
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def write(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):  # MSB first
            self.bits.append((value >> i) & 1)

    def to_bytes(self) -> bytes:
        bits = self.bits + [0] * ((-len(self.bits)) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            out.append(b)
        return bytes(out)


def lzss_compress(data: bytes, dict_bytes: bytes, max_out: int | None = None,
                  level: int = 1, min_match: int = 5) -> bytes:
    """Greedy LZSS compressor emitting the circuit's format.

    dict_bytes must already be augmented (augment_dict). level=0 writes a
    bypass stream (raw bytes after the header). max_out sizes the dynamic
    address field; defaults to len(data).
    """
    if level == 0:  # header byte 2 is the BYPASS flag (1 = raw payload)
        return bytes([0, 1, 1]) + bytes(data)
    if max_out is None:
        max_out = len(data)
    a_dyn = dyn_addr_bits(len(dict_bytes), max_out)
    hist = bytearray(dict_bytes)  # dict ‖ produced output
    w = _BitWriter()
    i = 0
    n = len(data)
    while i < n:
        # longest match in hist allowing overlap (source may extend into
        # the bytes this very copy produces)
        best_len = 0
        best_src = -1
        max_len = min(255, n - i)
        # scan candidate sources newest-first (smaller addresses)
        for src in range(len(hist) - 1, -1, -1):
            length = 0
            while length < max_len:
                ref = (hist[src + length] if src + length < len(hist)
                       else data[i + (src + length - len(hist))])
                if ref != data[i + length]:
                    break
                length += 1
            if length > best_len:
                best_len, best_src = length, src
                if length == max_len:
                    break
        b = data[i]
        is_delim = b in (SYMBOL_SHORT, SYMBOL_DYNAMIC)
        if best_len >= min_match or (is_delim and best_len >= 1):
            addr = (len(hist) - 1) - best_src
            if is_delim and best_len < min_match:
                best_len = 1  # escape: copy exactly the delimiter byte
                best_src = hist.index(b)
                addr = (len(hist) - 1) - best_src
            if addr < (1 << SHORT_ADDR_BITS):
                w.write(SYMBOL_SHORT, 8)
                w.write(best_len, LEN_BITS)
                w.write(addr, SHORT_ADDR_BITS)
            else:
                assert addr < (1 << a_dyn), "dynamic address overflow"
                w.write(SYMBOL_DYNAMIC, 8)
                w.write(best_len, LEN_BITS)
                w.write(addr, a_dyn)
            hist.extend(data[i : i + best_len])
            i += best_len
        else:
            w.write(b, 8)
            hist.append(b)
            i += 1
    return bytes([0, 1, 0]) + w.to_bytes()


def lzss_decompress_host(c: bytes, dict_bytes: bytes, max_out: int) -> bytes:
    """Host reference decoder (the circuit's semantics, byte for byte)."""
    assert c[0] == 0 and c[1] == 1
    if c[2] == 1:  # bypassed
        return bytes(c[HEADER:])
    bits = []
    for b in c[HEADER:]:
        for i in range(7, -1, -1):
            bits.append((b >> i) & 1)

    def read(pos, nb):
        v = 0
        for k in range(nb):
            v = (v << 1) | (bits[pos + k] if pos + k < len(bits) else 0)
        return v

    a_dyn = dyn_addr_bits(len(dict_bytes), max_out)
    hist = bytearray(dict_bytes)
    out = bytearray()
    pos = 0
    while len(bits) - pos >= 8 and len(out) < max_out:
        b = read(pos, 8)
        if b in (SYMBOL_SHORT, SYMBOL_DYNAMIC):
            length = read(pos + 8, LEN_BITS)
            a_bits = SHORT_ADDR_BITS if b == SYMBOL_SHORT else a_dyn
            addr = read(pos + 16, a_bits)
            for _ in range(length):
                src = len(hist) - 1 - addr
                hist.append(hist[src])
                out.append(hist[-1])
                if len(out) >= max_out:
                    break
            pos += 16 + a_bits
        else:
            hist.append(b)
            out.append(b)
            pos += 8
    return bytes(out)


# ---------------------------------------------------------------------------
# circuit gadgets
# ---------------------------------------------------------------------------

def _break_bits_hint(q, inputs):
    outs = []
    for v in inputs:
        v = int(v)
        if v >= 256:
            raise ValueError("not a byte")
        outs.extend((v >> i) & 1 for i in range(7, -1, -1))
    return outs


BREAK_BITS = hintlib.register_hint(
    _break_bits_hint, "gnark_icicle_tpu.std.compress_lzss._break_bits_hint")


class NumReader:
    """Sliding big-endian window over a word stream (≙ compress.NumReader,
    io.go:147-250): successive Next() calls return (b_i ... b_{i+n-1})_r for
    i = 0, 1, ... at one constraint each after the first."""

    def __init__(self, api, to_read, num_nb_bits: int, word_nb_bits: int):
        assert num_nb_bits % word_nb_bits == 0
        self.api = api
        self.to_read = list(to_read)
        self.radix = 1 << word_nb_bits
        self.num_bound = 1 << num_nb_bits
        self.words_per_num = num_nb_bits // word_nb_bits
        self.pos = 0
        self.last = None

    def next(self):
        api = self.api
        if self.pos >= len(self.to_read):
            return 0
        if self.last is None:
            first = self.to_read[: self.words_per_num]
            acc = first[0] if first else 0
            for wv in first[1:]:
                acc = api.add(wv, api.mul(acc, self.radix))
            self.last = acc
            return self.last
        head = self.to_read[self.pos]
        nxt_i = self.pos + self.words_per_num
        nxt = self.to_read[nxt_i] if nxt_i < len(self.to_read) else 0
        self.last = api.add(
            api.sub(api.mul(self.last, self.radix),
                    api.mul(head, self.num_bound)),
            nxt,
        )
        self.pos += 1
        return self.last


def _bytes_to_bits(api, byte_vars):
    """Byte vars -> bit vars (MSB first) + sliding recombined-byte vars
    (≙ RangeChecker.BreakUpBytesIntoWords(1, ...): the hint provides the
    bits, booleanity is asserted, and a NumReader proves the bits
    recombine to the claimed bytes)."""
    bits = api.new_hint(BREAK_BITS, 8 * len(byte_vars), *byte_vars)
    for b in bits:
        api.assert_is_boolean(b)
    reader = NumReader(api, bits, 8, 1)
    recombined = [None] * len(bits)
    for i, bv in enumerate(byte_vars):
        first = reader.next()
        api.assert_is_equal(first, bv)  # bits recombine to the input bytes
        recombined[8 * i] = bv
        for j in range(1, 8):
            recombined[8 * i + j] = reader.next()
    return bits, recombined


def _is_less_than_8(api, v):
    """1 if v ∈ {0..7}, else 0 (≙ RangeChecker.IsLessThan(8, ·))."""
    prod = v
    for k in range(1, 8):
        prod = api.mul(prod, api.sub(v, k))
    return api.is_zero(prod)


def decompress(api, c, c_length, dict_vars, max_out: int):
    """In-circuit LZSS decompression (≙ lzss.Decompress, snark.go:22-141).

    c: compressed byte variables (header included); c_length: its byte
    length as a variable; dict_vars: AUGMENTED dictionary byte variables;
    max_out: output buffer size (static).

    Returns (d, d_length): max_out output byte variables (zero-padded past
    the end) and the decompressed length (-1 if d overflows).
    """
    from .logderivlookup import Table

    api.assert_is_less_or_equal(c_length, len(c))
    api.assert_is_equal(c[0], 0)
    api.assert_is_equal(c[1], 1)
    bypassed = c[2]
    api.assert_is_boolean(bypassed)
    if len(c) <= HEADER:
        return [], 0

    payload = list(c[HEADER:]) + [0]  # zero pad (≙ snark.go:52)
    bits, recomb = _bytes_to_bits(api, payload)
    c_bits = api.mul(api.sub(c_length, HEADER), 8)

    a_dyn = dyn_addr_bits(len(dict_vars), max_out)

    out_table = Table(api)
    for dv in dict_vars:
        out_table.insert(dv)
    bytes_table = Table(api)
    for rv in recomb:
        bytes_table.insert(rv)

    # address table: entry i = the address field of a backref whose
    # delimiter starts at bit i (type chosen by the byte at i)
    delim_len_bits = 8 + LEN_BITS
    tail = bits[delim_len_bits:]
    rd_short = NumReader(api, tail, SHORT_ADDR_BITS, 1)
    rd_dyn = NumReader(api, tail, a_dyn, 1)
    addr_table = Table(api)
    for i in range(len(bits)):
        is_short = api.is_zero(api.sub(recomb[i], SYMBOL_SHORT))
        addr_table.insert(api.select(is_short, rd_short.next(),
                                     rd_dyn.next()))

    in_i = 0
    copy_len = 0
    copy_len01 = 1
    eof = api.is_zero(c_bits)
    d_length = api.add(-1, eof)
    d = [None] * max_out

    for out_i in range(max_out):
        curr = bytes_table.lookup(in_i)[0]

        # bypassing forces both indicators to 0
        not_bypassed = api.sub(1, bypassed)
        ind_short = api.is_zero(
            api.add(api.mul(api.sub(SYMBOL_SHORT, curr), not_bypassed),
                    api.mul(bypassed, -1))  # nonzero when bypassed
        )
        ind_dyn = api.is_zero(
            api.add(api.mul(api.sub(SYMBOL_DYNAMIC, curr), not_bypassed),
                    api.mul(bypassed, -1))
        )
        ind_br = api.add(ind_short, ind_dyn)

        br_len = bytes_table.lookup(api.add(in_i, 8))[0]  # length-1 field
        br_len = api.mul(ind_br, br_len)  # 0 when not at a backref
        br_addr = addr_table.lookup(in_i)[0]

        copy_len = api.select(copy_len01, br_len, api.sub(copy_len, 1))
        copy_len01 = api.is_zero(
            api.sub(api.mul(copy_len, copy_len), copy_len))
        # copying = copy_len01 ? copy_len : 1
        copying = api.add(api.mul(copy_len01, copy_len),
                          api.sub(1, copy_len01))

        copy_addr = api.mul(
            api.sub(out_i + len(dict_vars) - 1, br_addr), ind_br
        )
        to_copy = out_table.lookup(copy_addr)[0]

        out_val = api.select(copying, to_copy, curr)
        d[out_i] = api.mul(out_val, api.sub(1, eof))  # zeros past eof
        out_table.insert(d[out_i])

        in_delta = api.add(
            8,
            api.mul(ind_dyn, LEN_BITS + a_dyn),
            api.mul(ind_short, LEN_BITS + SHORT_ADDR_BITS),
        )
        in_delta = api.mul(in_delta, copy_len01)
        in_i = api.add(in_i, api.mul(in_delta, api.sub(1, eof)))

        eof_now = _is_less_than_8(api, api.sub(c_bits, in_i))
        d_length = api.add(d_length,
                           api.mul(api.sub(eof_now, eof), out_i + 2))
        eof = eof_now

    return d, d_length
