"""gnark-crypto's G1 point encoding, as PLONK's transcript binds points.

A partial copy of gnark_icicle_tpu/io/serialize.py: the flag schemes
(``_FlagScheme`` :32, ``_scheme`` :58), ``_fp_bytes`` (:62),
``_lex_largest_fp`` (:98) and ``g1_to_bytes`` (:113), which
``backend/transcript.py`` needs (its :49). Coordinates are fixed-width
big-endian with the flags in the most significant byte: gnark's 2-bit
scheme, or for BLS12-381 the 3-bit zcash scheme. The rest of that module
(G2, proofs, keys, witnesses) is not on the port's path.
"""

from __future__ import annotations


class _FlagScheme:
    """Per-curve msb flag layout (gnark-crypto marshal.go constants)."""

    def __init__(self, mask, unc, unc_inf, small, large, inf):
        self.mask = mask
        self.unc = unc
        self.unc_inf = unc_inf  # None = uncompressed infinity is all-zero
        self.small = small
        self.large = large
        self.inf = inf


_SCHEME_GNARK = _FlagScheme(
    0b11 << 6, 0b00 << 6, None, 0b10 << 6, 0b11 << 6, 0b01 << 6
)
_SCHEME_ZCASH = _FlagScheme(
    0b111 << 5, 0b000 << 5, 0b010 << 5, 0b100 << 5, 0b101 << 5, 0b110 << 5
)


def _scheme(curve) -> _FlagScheme:
    return _SCHEME_ZCASH if curve.name == "bls12-381" else _SCHEME_GNARK


def _fp_bytes(v: int, nb: int) -> bytes:
    return int(v).to_bytes(nb, "big")


def _lex_largest_fp(y: int, p: int) -> bool:
    return y > (p - 1) // 2


def g1_to_bytes(curve, pt, compressed: bool = True) -> bytes:
    nb = curve.fp.nb_bytes
    s = _scheme(curve)
    if compressed:
        if pt is None:
            return bytes([s.inf]) + bytes(nb - 1)
        x, y = pt
        flag = (
            s.large if _lex_largest_fp(y, curve.fp.modulus) else s.small
        )
        b = bytearray(_fp_bytes(x, nb))
        b[0] |= flag
        return bytes(b)
    if pt is None:
        if s.unc_inf is not None:
            return bytes([s.unc_inf]) + bytes(2 * nb - 1)
        return bytes(2 * nb)
    return _fp_bytes(pt[0], nb) + _fp_bytes(pt[1], nb)
