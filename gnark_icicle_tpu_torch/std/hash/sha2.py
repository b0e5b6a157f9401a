"""SHA-256 circuit gadget (≙ reference std/hash/sha2 + internal sha2
permutation, std/permutation/sha2).

Message input is a list of 32-bit word variables (big-endian words of the
padded message, as in the FIPS-180 schedule); callers pad on the host — the
reference gadget takes padded blocks the same way. Built on the UWord bit
API (std/math_bits).

Copied from gnark_icicle_tpu/std/hash/sha2.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_precompiles.py holds it to the original.
"""

from __future__ import annotations

from ..math_bits import UWord

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_H0 = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def _small_sigma0(w: UWord) -> UWord:
    return w.ror(7).xor(w.ror(18)).xor(w.shr(3))


def _small_sigma1(w: UWord) -> UWord:
    return w.ror(17).xor(w.ror(19)).xor(w.shr(10))


def _big_sigma0(w: UWord) -> UWord:
    return w.ror(2).xor(w.ror(13)).xor(w.ror(22))


def _big_sigma1(w: UWord) -> UWord:
    return w.ror(6).xor(w.ror(11)).xor(w.ror(25))


def _ch(api, e: UWord, f: UWord, g: UWord) -> UWord:
    return e.and_(f).xor(e.not_().and_(g))


def _maj(api, a: UWord, b: UWord, c: UWord) -> UWord:
    return a.and_(b).xor(a.and_(c)).xor(b.and_(c))


def sha256_compress(api, state: list, block_words: list) -> list:
    """One FIPS-180 compression: 8 UWord state + 16 UWord message words."""
    w = list(block_words)
    for t in range(16, 64):
        w.append(
            _small_sigma1(w[t - 2]).add(
                w[t - 7], _small_sigma0(w[t - 15]), w[t - 16]
            )
        )
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        k = UWord.constant(api, _K[t], 32)
        t1 = h.add(_big_sigma1(e), _ch(api, e, f, g), k, w[t])
        t2 = _big_sigma0(a).add(_maj(api, a, b, c))
        h, g, f = g, f, e
        e = d.add(t1)
        d, c, b = c, b, a
        a = t1.add(t2)
    return [
        s.add(v) for s, v in zip(
            state, (a, b, c, d, e, f, g, h)
        )
    ]


def sha256_words(api, padded_words: list) -> list:
    """Padded 32-bit message word vars (multiple of 16) -> 8 digest words."""
    assert len(padded_words) % 16 == 0
    state = [UWord.constant(api, h, 32) for h in _H0]
    for off in range(0, len(padded_words), 16):
        block = [
            UWord.from_var(api, v, 32)
            for v in padded_words[off : off + 16]
        ]
        state = sha256_compress(api, state, block)
    return [s.value() for s in state]


def pad_message_words(data: bytes) -> list:
    """Host-side FIPS-180 padding -> list of 32-bit big-endian word ints."""
    bit_len = 8 * len(data)
    padded = data + b"\x80"
    while (len(padded) + 8) % 64:
        padded += b"\x00"
    padded += bit_len.to_bytes(8, "big")
    return [
        int.from_bytes(padded[i : i + 4], "big")
        for i in range(0, len(padded), 4)
    ]
