"""In-circuit EVM precompile contracts.

Role parity: reference std/evmprecompiles (01-ecrecover.go, 02-sha256.go,
04-id.go, 06-bnadd.go, 07-bnmul.go, 08-bnpairing.go) — the circuits zkEVMs
use to prove EVM execution of the precompiled contracts. Built entirely on
the existing gadget layer: sw_emulated curves, the emulated secp256k1
fields, the sha2 gadget, and the sw_bn254 pairing.

Implemented: 0x01 ECRECOVER, 0x02 SHA256, 0x04 IDENTITY, 0x05 MODEXP
(expmod below — arithmetic modulo a WITNESS modulus via the
variable-modulus mulcheck path, emulated.mod_exp ≙ 05-expmod.go:17),
0x06 ECADD, 0x07 ECMUL, 0x08 ECPAIRING.

Differences from the reference's ECRecover: inputs are assumed
well-formed (no isFailure escape hatch — invalid inputs make the circuit
unsatisfiable, which is the right default outside zkEVM tracing), and the
EVM's v ∈ {27, 28} is taken pre-converted as a parity bit v ∈ {0, 1}.

Copied from gnark_icicle_tpu/std/evmprecompiles.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_precompiles.py holds it to the original.
"""

from __future__ import annotations

from ..constraint import hints as hintlib
from .emulated import Element
from .sw_emulated import (
    AffinePoint, BN254G1, EmulatedCurve, SECP256K1,
)

_SECP_P = SECP256K1.fp.modulus
_SECP_N = SECP256K1.fr.modulus
_SECP_G = (SECP256K1.gx, SECP256K1.gy)


# -- host secp256k1 arithmetic for the recover hint --------------------------

def _h_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % _SECP_P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, _SECP_P) % _SECP_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, _SECP_P) % _SECP_P
    x3 = (lam * lam - x1 - x2) % _SECP_P
    return (x3, (lam * (x1 - x3) - y1) % _SECP_P)


def _h_mul(p, k):
    acc = None
    while k:
        if k & 1:
            acc = _h_add(acc, p)
        p = _h_add(p, p)
        k >>= 1
    return acc


def _recover_host(msg: int, v: int, r: int, s: int):
    """The ECRECOVER math: P = r⁻¹·(s·R − msg·G), R = (r, y|parity v)."""
    y2 = (pow(r, 3, _SECP_P) + 7) % _SECP_P
    y = pow(y2, (_SECP_P + 1) // 4, _SECP_P)
    if y * y % _SECP_P != y2:
        raise ValueError("ecrecover: r^3+7 is not a square")
    if y & 1 != v:
        y = _SECP_P - y
    R = (r, y)
    rinv = pow(r, -1, _SECP_N)
    P = _h_mul(_h_add(_h_mul(R, s), _h_mul(_SECP_G, _SECP_N - msg % _SECP_N)),
               rinv)
    if P is None:
        raise ValueError("ecrecover: zero public key")
    return P


def _ecrecover_hint(q, inputs):
    """inputs: 3k fr limbs (msg, r, s) + v + static (k, w) → 2k+k? limbs:
    the public key's (x, y) and R's y coordinate, k fp limbs each."""
    k = int(inputs[-2])
    w = int(inputs[-1])
    mask = (1 << w) - 1

    def val(off):
        t = 0
        for i in range(k):
            t += int(inputs[off + i]) << (w * i)
        return t

    msg, r, s = val(0), val(k), val(2 * k)
    v = int(inputs[3 * k]) & 1
    px, py = _recover_host(msg, v, r, s)
    y2 = (pow(r, 3, _SECP_P) + 7) % _SECP_P
    ry = pow(y2, (_SECP_P + 1) // 4, _SECP_P)
    if ry & 1 != v:
        ry = _SECP_P - ry
    out = []
    for value in (px, py, ry):
        for i in range(k):
            out.append((value >> (w * i)) & mask)
    return out


ECRECOVER = hintlib.register_hint(_ecrecover_hint, "evm.ecrecover")


def _assert_bits_leq_const(api, bits, bound: int):
    """Constrain the little-endian bit vector ≤ bound (the MSB-walk aux
    chain, same scheme as api._assert_leq_constant)."""
    p = 1
    for i in range(len(bits) - 1, -1, -1):
        if (bound >> i) & 1:
            p = api.mul(p, bits[i])
        else:
            api.assert_is_equal(api.mul(p, bits[i]), 0)


def ec_recover(api, native_modulus: int, msg: Element, v, r: Element,
               s: Element, strict_range: bool = False) -> AffinePoint:
    """≙ evmprecompiles.ECRecover (01-ecrecover.go:26), precompile 0x01.

    msg/r/s: emulated secp256k1-Fr elements; v: native parity bit.
    Recovers P through a hint, then constrains the defining equation
    [s]·R == [msg]·G + [r]·P with R = (r, y) reconstructed in-circuit
    (on-curve + parity-pinned) — sound because r ≠ 0, s ≠ 0 are proven by
    the inverse gadgets and the equation determines P uniquely given R.
    strict_range additionally enforces s ≤ (n−1)/2 (transaction-signature
    semantics, Yellow Paper App. F)."""
    curve = EmulatedCurve(api, SECP256K1, native_modulus)
    fp, fr = curve.fp, curve.fr
    api.assert_is_boolean(v)
    fr.assert_canonical(r)
    fr.assert_canonical(s)
    fr.inverse(r)   # proves r ≠ 0
    fr.inverse(s)   # proves s ≠ 0
    if strict_range:
        _assert_bits_leq_const(api, fr.bits(s), (_SECP_N - 1) // 2)

    # hint the recovered key and R's y, then verify everything in-circuit
    static = (fr.k, fr.w)
    out = api.new_hint(
        ECRECOVER, 3 * fp.k,
        *(list(fr.reduce(msg).limbs) + list(fr.reduce(r).limbs)
          + list(fr.reduce(s).limbs) + [v]),
        static_args=static,
    )
    kk = fp.k
    for lim in out:
        fp._check_width(lim, fp.w)
    P = AffinePoint(Element(out[:kk], 1 << fp.w),
                    Element(out[kk:2 * kk], 1 << fp.w))
    ry = Element(out[2 * kk:], 1 << fp.w)

    # R = (r, ry): on-curve with the claimed parity
    rx = fp.from_foreign(r, fr)      # r < n < p embeds exactly
    y2 = fp.mul(ry, ry)
    rhs = fp.add(fp.mul(fp.mul(rx, rx), rx), fp.constant(7))
    fp.assert_equal(y2, rhs)
    fp.assert_canonical(ry)
    api.assert_is_equal(fp.bits(ry)[0], v)
    R = AffinePoint(rx, ry)

    curve.assert_on_curve(P)
    api.assert_is_equal(curve.is_infinity(P), 0)

    # [s]R == [msg]G + [r]P
    lhs = curve.scalar_mul(R, s)
    rhs_pt = curve.add_unified(
        curve.scalar_mul_base(msg), curve.scalar_mul(P, r)
    )
    curve.assert_is_equal(lhs, rhs_pt)
    return P


def sha256(api, data_words: list) -> list:
    """≙ evmprecompiles.Sha256 (02-sha256.go), precompile 0x02: thin
    wrapper over the std sha2 gadget (padded 32-bit words in/out)."""
    from .hash.sha2 import sha256_words

    return sha256_words(api, data_words)


def identity(data: list) -> list:
    """≙ evmprecompiles.Identity (04-id.go), precompile 0x04."""
    return list(data)


def ec_add(api, native_modulus: int, p: AffinePoint,
           q: AffinePoint) -> AffinePoint:
    """≙ evmprecompiles.ECAdd (06-bnadd.go:12), precompile 0x06: unified
    BN254 G1 add (handles P == ±Q and the (0,0) identity encoding)."""
    curve = EmulatedCurve(api, BN254G1, native_modulus)
    curve.assert_on_curve(p)
    curve.assert_on_curve(q)
    return curve.add_unified(p, q)


def ec_mul(api, native_modulus: int, p: AffinePoint,
           u: Element) -> AffinePoint:
    """≙ evmprecompiles.ECMul (07-bnmul.go:13), precompile 0x07.

    Handles the (0,0) identity encoding by routing a dummy generator
    through the ladder and selecting the identity back out."""
    curve = EmulatedCurve(api, BN254G1, native_modulus)
    fp = curve.fp
    is_inf = curve.is_infinity(p)
    safe = curve.select(is_inf, curve.generator(), p)
    curve.assert_on_curve(safe)
    prod = curve.scalar_mul(safe, u)
    return curve.select(is_inf, curve.infinity(), prod)


def ec_pair(api, native_modulus: int, pairs) -> None:
    """≙ evmprecompiles.ECPair (08-bnpairing.go:31), precompile 0x08:
    constrain ∏ e(Pᵢ, Qᵢ) == 1 with full G2 membership checks.

    pairs: [(AffinePoint, (E2, E2)), ...] — G1 points and G2 twist points.
    """
    from ..curves import bn254
    from .pairing_bn254 import BN254Pairing

    curve = EmulatedCurve(api, BN254G1, native_modulus)
    pairing = BN254Pairing(api, native_modulus)
    e2 = pairing.e2
    twist_b = e2.constant(bn254.G2_B.c0, bn254.G2_B.c1)
    flat = []
    for p, q in pairs:
        curve.assert_on_curve(p)  # BN254 G1 cofactor 1 ⇒ membership
        x, y = q
        lhs = e2.square(y)
        rhs = e2.add(e2.mul(e2.square(x), x), twist_b)
        e2.assert_equal(lhs, rhs)
        acc = q
        for bit in bin(bn254.R - 1)[3:]:
            acc, _ = pairing._twist_double(acc)
            if bit == "1":
                acc, _ = pairing._twist_add(acc, q)
        e2.assert_equal(acc[0], x)
        e2.assert_equal(acc[1], e2.neg(y))
        flat.append(((p.x, p.y), q))
    pairing.assert_pairing_check(flat)


def expmod(api, fp, base: Element, exp: Element, modulus: Element) -> Element:
    """≙ evmprecompiles.Expmod (05-expmod.go:17), precompile 0x05:
    base^exp mod modulus with the EVM edge semantics x mod 0 = 0 and
    x mod 1 = 0. fp: an EmulatedField whose (k, w) layout bounds the
    input sizes (the reference's Element[P] role); the modulus is a
    WITNESS — arithmetic runs through the variable-modulus mulcheck path
    (emulated.mod_exp)."""
    one = fp.constant_raw(1)
    is_zero_mod = fp._limbs_is_zero(modulus)
    # modulus == 1: limb0 == 1 and every other limb zero
    lz = api.is_zero(api.sub(modulus.limbs[0], 1))
    for limb in modulus.limbs[1:]:
        lz = api.and_(lz, api.is_zero(limb))
    degenerate = api.or_(is_zero_mod, lz)
    safe_mod = fp.select(degenerate, fp.constant_raw(2), modulus)
    res = fp.mod_exp(base, exp, safe_mod)
    zero = fp.constant_raw(0)
    return fp.select(degenerate, zero, res)
