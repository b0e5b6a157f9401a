"""BLS24-315 parameters — derived entirely from in-tree-pinned invariants.

Parity target: the 5th of the reference's 7 curves (doc.go:27-38). The
reference tree does NOT carry the gnark-crypto parameter set; everything
here is DERIVED from what IS in-tree and verified against it
(PARITY.md round-5 feasibility memo; tools/derive_bls24.py):

- seed x = −0xbfcfffff: integer root of r(x) = x⁸−x⁴+1 for the Fr modulus
  in std/math/emulated/emparams/emparams.go:280, sign pinned by
  p(x) = (x−1)²·r(x)/3 + x matching emparams.go:264, independently
  confirmed by the ate loop counter sw_bls24315/pairing.go:29;
- tower: Fp2 = Fp(u), u² = 13 (fields_bls24315/e24.go:70); Fp4 = Fp2(v),
  v² = u; the pairing target here is Fp24 = Fp4[w]/(w⁶ − v) (the in-tree
  3-level Fp4→Fp12→Fp24 tower has w³ = v, i² = w so i⁶ = v — same field,
  flat basis). All 13 in-tree Frobenius coefficients verified as powers
  13^(k(p−1)/d) (test_bls24_315.py);
- GLV λ (sw_bls24315/inner.go:33) and ω (inner.go:37) verified:
  λ²+λ+1 ≡ 0 mod r, λ = x⁴−1, ω³ = 1 mod p;
- curve: y² = x³ + 1 — the SMALLEST coefficient with #E = p+1−(x+1)
  (order-checked); the in-tree data pins the curve only up to the j=0
  sextic-twist isomorphism class (4 ≡ s⁶, so gnark-crypto's literal b is
  isomorphic whichever it is);
- G2: D-twist y² = x³ + b/v over Fp4 (the twist whose order
  p⁴+1−(3f+t₄)/2 is divisible by r — the M-twist is not);
- generators: framework-chosen DETERMINISTIC points (smallest-x valid
  point, cofactor-cleared, order-r asserted). NOT serialization-
  compatible with gnark-crypto's arbitrary generator choice — nothing
  in-tree pins it and no fixture could catch a mismatch (memo).

Pairing: ate e(P, Q) = f_{|x|,Q}(P)^{(p²⁴−1)/r}, inverted post-FE for the
negative seed. The final exponentiation uses the GENERIC exponent
(correctness-first: no Frobenius/cyclotomic shortcuts to get wrong);
host verification pays ~1-2 s per pairing product, cached e(α,β) as
everywhere else. Miller-loop lines: T on the twist, slopes in Fp4, sparse
evaluation l(P) = yp − λ·xp·w + (λ·xt − yt)·w³ under the untwist
ψ(x, y) = (x·w², y·w³).

Copied from gnark_icicle_tpu/curves/bls24_315.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_host_engine.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .field import PrimeField
from .ec import ECGroup

X_SEED = -0xbfcfffff
R = X_SEED**8 - X_SEED**4 + 1
P = (X_SEED - 1) ** 2 * R // 3 + X_SEED
U_SQ = 13  # Fp2 non-residue (fields_bls24315/e24.go:70)

FP = PrimeField("bls24-315.fp", P, two_adicity=20, multiplicative_generator=13)
FR = PrimeField("bls24-315.fr", R, two_adicity=22, multiplicative_generator=7)

# cofactors (tools/derive_bls24.py; order checks in tests)
_T = X_SEED + 1
N1 = P + 1 - _T
H1 = N1 // R
_t2 = _T * _T - 2 * P
_t4 = _t2 * _t2 - 2 * P * P
import math as _math

_f = _math.isqrt((4 * P**4 - _t4 * _t4) // 3)
N2 = P**4 + 1 - (3 * _f + _t4) // 2
H2 = N2 // R
assert H1 * R == N1 and H2 * R == N2


# ---------------------------------------------------------------------------
# Fp4 = Fp(u, v), u² = 13, v² = u — elements as 4-tuples
# (a0 + a1·u) + (a2 + a3·u)·v
# ---------------------------------------------------------------------------

F4_ZERO = (0, 0, 0, 0)
F4_ONE = (1, 0, 0, 0)


def f2_mul(a0, a1, b0, b1):
    m0 = a0 * b0 % P
    m1 = a1 * b1 % P
    m2 = (a0 + a1) * (b0 + b1) % P
    return (m0 + U_SQ * m1) % P, (m2 - m0 - m1) % P


def f4_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def f4_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def f4_neg(a):
    return tuple(-x % P for x in a)


def f4_mul(a, b):
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    c0, c1 = f2_mul(a0, a1, b0, b1)      # A0·B0
    d0, d1 = f2_mul(a2, a3, b2, b3)      # A1·B1
    s0, s1 = f2_mul(a0, a1, b2, b3)
    t0, t1 = f2_mul(a2, a3, b0, b1)
    # + u·(A1·B1):  u·(d0 + d1 u) = 13·d1 + d0·u
    return ((c0 + U_SQ * d1) % P, (c1 + d0) % P,
            (s0 + t0) % P, (s1 + t1) % P)


def f4_muli(a, k: int):
    return tuple(x * k % P for x in a)


def f2_inv(a0, a1):
    """(a0 + a1 u)⁻¹ = (a0 − a1 u)/(a0² − 13 a1²)."""
    n = (a0 * a0 - U_SQ * a1 * a1) % P
    ni = pow(n, -1, P)
    return a0 * ni % P, -a1 * ni % P


def f4_inv(a):
    """(A0 + A1 v)⁻¹ = (A0 − A1 v)·(A0² − u·A1²)⁻¹ (norm to Fp2)."""
    a0, a1, a2, a3 = a
    s0, s1 = f2_mul(a0, a1, a0, a1)
    t0, t1 = f2_mul(a2, a3, a2, a3)
    # u·(t0 + t1 u) = 13 t1 + t0 u
    n0, n1 = (s0 - U_SQ * t1) % P, (s1 - t0) % P
    i0, i1 = f2_inv(n0, n1)
    c0, c1 = f2_mul(a0, a1, i0, i1)
    d0, d1 = f2_mul(-a2 % P, -a3 % P, i0, i1)
    return (c0, c1, d0, d1)


def f4_is_zero(a):
    return all(c % P == 0 for c in a)


class Fp4Ops:
    """Generic-element adapter for ECGroup (G2 coordinates in Fp4)."""

    def zero(self):
        return F4_ZERO

    def one(self):
        return F4_ONE

    def add(self, a, b):
        return f4_add(a, b)

    def sub(self, a, b):
        return f4_sub(a, b)

    def mul(self, a, b):
        return f4_mul(a, b)

    def neg(self, a):
        return f4_neg(a)

    def inv(self, a):
        return f4_inv(a)

    def muli(self, a, k: int):
        return f4_muli(a, k)

    def is_zero(self, a):
        return f4_is_zero(a)

    def eq(self, a, b):
        return f4_sub(a, b) == F4_ZERO


# ---------------------------------------------------------------------------
# E24 = Fp4[w]/(w⁶ − v): elements as 6-tuples of Fp4 4-tuples
# ---------------------------------------------------------------------------

V4 = (0, 0, 1, 0)  # the Fp4 element v
E24_ONE = (F4_ONE,) + (F4_ZERO,) * 5


def e24_mul(a, b):
    acc = [[0, 0, 0, 0] for _ in range(6)]
    hi = [[0, 0, 0, 0] for _ in range(6)]
    for i in range(6):
        ai = a[i]
        if ai == F4_ZERO:
            continue
        for j in range(6):
            bj = b[j]
            if bj == F4_ZERO:
                continue
            m = f4_mul(ai, bj)
            tgt = acc[i + j] if i + j < 6 else hi[i + j - 6]
            for k in range(4):
                tgt[k] = (tgt[k] + m[k]) % P
    out = []
    for k in range(6):
        h = tuple(hi[k])
        if h != F4_ZERO:
            hv = f4_mul(h, V4)  # w⁶ = v
            out.append(tuple((acc[k][t] + hv[t]) % P for t in range(4)))
        else:
            out.append(tuple(acc[k]))
    return tuple(out)


def e24_pow(a, e: int):
    res = E24_ONE
    while e:
        if e & 1:
            res = e24_mul(res, a)
        a = e24_mul(a, a)
        e >>= 1
    return res


FINAL_EXP = (P**24 - 1) // R
assert (P**24 - 1) % R == 0


# ---------------------------------------------------------------------------
# ate Miller loop (T on the twist, slopes in Fp4, sparse line eval)
# ---------------------------------------------------------------------------

def _line_sparse(xp, yp, lam, xt, yt):
    """l(P) for the line through ψ(T) with twist-slope λ:
    yp − λ·xp·w + (λ·xt − yt)·w³ — coefficients at w⁰, w¹, w³."""
    c0 = (yp % P, 0, 0, 0)
    c1 = f4_muli(lam, -xp % P)
    c3 = f4_sub(f4_mul(lam, xt), yt)
    return (c0, c1, F4_ZERO, c3, F4_ZERO, F4_ZERO)


def _miller(pairs):
    """∏ f_{|x|,Qᵢ}(Pᵢ) — shared squaring across pairs."""
    n_bits = bin(abs(X_SEED))[2:]
    f = E24_ONE
    Ts = [q for _, q in pairs]
    for bit in n_bits[1:]:
        f = e24_mul(f, f)
        for idx, (pt, q) in enumerate(pairs):
            xt, yt = Ts[idx]
            # doubling: λ = 3x²/2y
            lam = f4_mul(f4_muli(f4_mul(xt, xt), 3),
                         f4_inv(f4_muli(yt, 2)))
            f = e24_mul(f, _line_sparse(pt[0], pt[1], lam, xt, yt))
            x3 = f4_sub(f4_mul(lam, lam), f4_muli(xt, 2))
            y3 = f4_sub(f4_mul(lam, f4_sub(xt, x3)), yt)
            Ts[idx] = (x3, y3)
            if bit == "1":
                xt, yt = Ts[idx]
                xq, yq = q
                lam = f4_mul(f4_sub(yq, yt), f4_inv(f4_sub(xq, xt)))
                f = e24_mul(f, _line_sparse(pt[0], pt[1], lam, xt, yt))
                x3 = f4_sub(f4_sub(f4_mul(lam, lam), xt), xq)
                y3 = f4_sub(f4_mul(lam, f4_sub(xt, x3)), yt)
                Ts[idx] = (x3, y3)
    return f


def multi_pairing(p_list, q_list):
    """∏ e(Pᵢ, Qᵢ) ∈ GT (E24). Infinity entries contribute 1."""
    pairs = [
        (pt, q) for pt, q in zip(p_list, q_list)
        if pt is not None and q is not None
    ]
    if not pairs:
        return E24_ONE
    m = _miller(pairs)
    res = e24_pow(m, FINAL_EXP)
    # negative seed: f_{x} ~ f_{|x|}⁻¹ up to verticals the FE kills;
    # the result has order r, so invert with a 253-bit pow
    return e24_pow(res, R - 1)


# ---------------------------------------------------------------------------
# groups + curve object
# ---------------------------------------------------------------------------

from .ec import FpOps

_fp_ops = FpOps(P)
_fp4_ops = Fp4Ops()

# deterministic generators (tools/derive_bls24.py; order-r asserted there
# and re-asserted in tests)
G1_GEN = (
    34223510504517033132712852754388476272837911830964394866541204856091481856889569724484362330263,
    24215295174889464585413596429561903295150472552154479431771837786124301185073987899223459122783,
)
G2_B = (0, 0, 0, pow(U_SQ, -1, P))  # b/v = v/u·b with b = 1
G2_GEN = (
    (21956877902198570999634948929998371641822526763670311101122563359426596099872158751793474588770,
     13374917893649176218298374495427680588908993386928898201734510085069557022621437547097539073717,
     25015053282445413380130462545376840074498572930713754582315371492046162741431525208932130214518,
     33653286414850441048304603667443382703040731152484283358966068747674370970765845185410470885523),
    (36555248972725047981561597689716721084403935035491591068597760614701778723965961155821334064010,
     8608652159757122036117237601403183896138401193867109367675087254989071283296870235137758107937,
     16091474487969119812586894822253180644942845730258030691177617672598310612397498919120055715396,
     33891229757461291362013659827104138546697340405661174758378584021660749654748446922692696723345),
)

G1 = ECGroup(_fp_ops, 1, G1_GEN, R, name="bls24-315.g1")
G2 = ECGroup(_fp4_ops, G2_B, G2_GEN, R, name="bls24-315.g2")

# in-tree GLV constants (sw_bls24315/inner.go:33-41) — verified in tests
GLV_LAMBDA = int.from_bytes(bytes([
    0x19, 0x6d, 0xea, 0xc2, 0x4a, 0x9d, 0xa1, 0x2b, 0x25, 0xfc, 0x7e,
    0xc9, 0xcf, 0x92, 0x7a, 0x99, 0x19, 0x73, 0x9f, 0x46, 0x27, 0xd9,
    0x92, 0x6e, 0x38, 0x20, 0xfb, 0xfa, 0x01, 0x80, 0x00, 0x01]), "big")
GLV_OMEGA = int.from_bytes(bytes([
    0x04, 0xc2, 0x3a, 0x02, 0xa2, 0x79, 0x2a, 0xda, 0xed, 0x93, 0x38,
    0xb4, 0xa8, 0x19, 0x5d, 0x81, 0xe9, 0xa0, 0x5f, 0x2f, 0x09, 0x88,
    0xc6, 0x57, 0x4e, 0xbb, 0xb2, 0xb0, 0xf7, 0x7c, 0x94, 0x0a, 0x4f,
    0x58, 0x14, 0xfe, 0x80, 0x60, 0x00, 0x02]), "big")


@dataclass(frozen=True)
class CurveBLS24315:
    name: str = "bls24-315"
    fp: PrimeField = FP
    fr: PrimeField = FR
    g1: ECGroup = dc_field(default_factory=lambda: G1)
    g2: ECGroup = dc_field(default_factory=lambda: G2)
    x_seed: int = X_SEED

    def gt_one(self):
        return E24_ONE

    def pairing(self, pairs):
        """∏ e(Pᵢ, Qᵢ) == 1 check."""
        return multi_pairing(
            [p for p, _ in pairs], [q for _, q in pairs]
        ) == E24_ONE

    def miller_and_final_exp(self, p_list, q_list):
        return multi_pairing(p_list, q_list)


BLS24_315 = CurveBLS24315()
