"""In-circuit BW6-761 pairing over the emulated direct-sextic tower.

Role parity: reference std/algebra/emulated/sw_bw6761 (pairing.go — the
gadget that lets a THIRD curve verify BW6-761 proofs, closing the 2-chain:
BLS12-377 proof → BW6-761 outer proof → e.g. a BN254 wrap for on-chain
verification). Mirrors the host oracle (curves/bw6_761.py BW6Pairing)
step-for-step:

  Miller loop   Tate f_{r,P}(ψ(Q)): 377 double/add steps walking P ∈ G1
                with Fp-affine arithmetic; lines are 3-sparse Fp6 elements
                (c0 = y_R − λx_R, c3 = −y_Q/γ, c4 = λ·x_Q/γ from the
                M-twist untwist ψ(x,y) = (x·w⁴/γ, y·w³/γ))
  final exp     (p⁶−1)/r = (p³−1)·(p+1)·(p²−p+1)/r — easy part via the
                coefficient-scaling Frobenius (w^(p^k) = γ^(i(p^k−1)/6)·w^i
                with all c_i ∈ Fp fixed) + ONE hinted Fp6 inverse; hard
                part (p²−p+1)/r as a literal square-multiply chain. The
                exponent decomposition is an integer identity (asserted),
                so the gadget equals the host oracle bit-for-bit.

Fp6 here is the DIRECT extension Fp[w]/(w⁶ − γ), γ = −4 — a different
tower shape from the 12-degree curves' 2-3-2 towers, so it gets its own
small gadget (E6Direct) rather than reusing E2/E6/E12.

Cost note: one pairing ≈ 377·(36 + lines) + ~1700·36 emulated 12-limb
muls — engine-practical as the semantic base for 2-chain composition;
constraint compilation rides the deferred-mulcheck path (ROADMAP).

Copied from gnark_icicle_tpu/std/pairing_bw6_761.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_recursion.py holds it to the original.
"""

from __future__ import annotations

from .emulated import BW6761_FP, Element, EmulatedField
from ..constraint import hints as hintlib
from ..curves import bw6_761 as bw6
from ..curves.bw6_761 import GAMMA, Fp6D

P = bw6.P
R = bw6.R

# final-exponentiation decomposition (exact integer identity)
assert (P * P - P + 1) % R == 0
_HARD = (P * P - P + 1) // R
assert (P**6 - 1) // R == (P**3 - 1) * (P + 1) * _HARD

# Frobenius coefficient tables: (w^i)^(p^k) = γ^(i·(p^k−1)/6) · w^i
assert P % 6 == 1
_FROB1 = [pow(GAMMA, i * (P - 1) // 6, P) for i in range(6)]
_FROB3 = [pow(GAMMA, i * (P**3 - 1) // 6, P) for i in range(6)]
_GINV = pow(GAMMA, -1, P)


def _inv6_hint(q, inputs):
    """inputs: 6k coefficient limbs + static (k, w) — limbs of the Fp6
    inverse's six coefficients (computed with the host tower)."""
    k = int(inputs[-2])
    w = int(inputs[-1])
    mask = (1 << w) - 1
    coeffs = []
    for c in range(6):
        v = 0
        for i in range(k):
            v += int(inputs[c * k + i]) << (w * i)
        coeffs.append(v % P)
    inv = Fp6D(coeffs).inv()
    out = []
    for v in inv.c:
        for i in range(k):
            out.append((v >> (w * i)) & mask)
    return out


INV6 = hintlib.register_hint(_inv6_hint, "emulated.bw6_761.inv6")


class E6Direct:
    """Fp[w]/(w⁶ − γ) over emulated BW6-761 Fp: elements are 6-tuples."""

    def __init__(self, fp: EmulatedField):
        self.fp = fp

    # -- constructors --------------------------------------------------------
    def constant(self, host: Fp6D):
        return tuple(self.fp.constant(v) for v in host.c)

    def one(self):
        return self.constant(Fp6D.one())

    def zero(self):
        return self.constant(Fp6D((0, 0, 0, 0, 0, 0)))

    # -- linear ops ----------------------------------------------------------
    def add(self, a, b):
        fp = self.fp
        return tuple(fp.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        fp = self.fp
        return tuple(fp.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.fp.neg(x) for x in a)

    def _mul_gamma(self, x):
        """x·γ = −4x (small-scalar fold for the w⁶ reduction)."""
        fp = self.fp
        x4 = fp.add(fp.add(x, x), fp.add(x, x))
        return fp.neg(x4)

    # -- multiplication ------------------------------------------------------
    def mul(self, a, b):
        """Schoolbook 6x6 + γ-fold (36 emulated muls)."""
        fp = self.fp
        t = [None] * 11
        for i in range(6):
            for j in range(6):
                prod = fp.mul(a[i], b[j])
                k = i + j
                t[k] = prod if t[k] is None else fp.add(t[k], prod)
        out = list(t[:6])
        for k in range(6, 11):
            out[k - 6] = fp.add(out[k - 6], self._mul_gamma(t[k]))
        return tuple(out)

    def square(self, a):
        return self.mul(a, a)

    def inverse(self, a):
        """Hint the host inverse, constrain a·inv == 1 (proves a ≠ 0)."""
        fp = self.fp
        api = fp.api
        limbs = []
        for c in a:
            red = fp.reduce(c)
            fp.assert_canonical(red)
            limbs.extend(red.limbs)
        out = api.new_hint(INV6, 6 * fp.k, *limbs,
                           static_args=(fp.k, fp.w))
        inv = []
        for c in range(6):
            el_limbs = out[c * fp.k : (c + 1) * fp.k]
            for v in el_limbs:
                fp._check_width(v, fp.w)
            inv.append(Element(el_limbs, 1 << fp.w))
        inv = tuple(inv)
        self.assert_equal(self.mul(a, inv), self.one())
        return inv

    # -- Frobenius (coefficient scaling — all c_i live in Fp) ---------------
    def frob(self, a, table=None):
        fp = self.fp
        tab = _FROB1 if table is None else table
        return tuple(
            c if t == 1 else fp.mul(c, fp.constant(t))
            for c, t in zip(a, tab)
        )

    def frob3(self, a):
        return self.frob(a, _FROB3)

    def pow_const(self, a, e: int):
        """a^e by MSB-first square-multiply (e a fixed positive int)."""
        acc = a
        for b in bin(e)[3:]:
            acc = self.square(acc)
            if b == "1":
                acc = self.mul(acc, a)
        return acc

    def assert_equal(self, a, b):
        for x, y in zip(a, b):
            self.fp.assert_equal(x, y)


class BW6761Pairing:
    """Pairing gadget over emulated BW6-761 (≙ sw_bw6761.Pairing)."""

    def __init__(self, api, native_modulus: int):
        self.api = api
        self.fp = EmulatedField(api, BW6761_FP, native_modulus)
        self.e6 = E6Direct(self.fp)

    def _line(self, lam, r_pt, q_g2):
        """3-sparse line value (module docstring): evaluated at ψ(Q)."""
        fp = self.fp
        xr, yr = r_pt
        xq, yq = q_g2
        z = fp.constant(0)
        ginv = fp.constant(_GINV)
        c0 = fp.sub(yr, fp.mul(lam, xr))
        c3 = fp.neg(fp.mul(yq, ginv))
        c4 = fp.mul(lam, fp.mul(xq, ginv))
        return (c0, z, z, c3, c4, z)

    def miller_loop(self, p_g1, q_g2):
        """Tate f_{r,P}(ψ(Q)) — the host oracle's exact schedule
        (curves/bw6_761.py:194-227). p_g1/q_g2: (x, y) emulated pairs of
        valid curve points of order r (the vertical-line terminal case of
        the generic loop cannot occur before the last iteration)."""
        fp = self.fp
        e6 = self.e6
        f = e6.one()
        rx, ry = p_g1
        px, py = p_g1
        xq, yq = q_g2
        bits = bin(R)[3:]
        for i, bit in enumerate(bits):
            lam = fp.div(
                fp.mul(fp.constant(3), fp.mul(rx, rx)),
                fp.add(ry, ry),
            )
            f = e6.mul(e6.square(f), self._line(lam, (rx, ry), q_g2))
            x3 = fp.sub(fp.mul(lam, lam), fp.add(rx, rx))
            ry = fp.sub(fp.mul(lam, fp.sub(rx, x3)), ry)
            rx = x3
            if bit == "1":
                if i == len(bits) - 1:
                    # terminal add: R = [r−1]P = −P, so the line through
                    # R and P is VERTICAL — l = x_Q − x_R, R → O and the
                    # loop ends (r is prime so this happens exactly here;
                    # the host branch curves/bw6_761.py:213-217). The
                    # constraint x_R == x_P pins the schedule: it holds
                    # iff P has order dividing r.
                    fp.assert_equal(rx, px)
                    ginv = fp.constant(_GINV)
                    z = fp.constant(0)
                    l = (fp.neg(rx), z, z, z, fp.mul(xq, ginv), z)
                    f = e6.mul(f, l)
                else:
                    lam = fp.div(fp.sub(py, ry), fp.sub(px, rx))
                    f = e6.mul(f, self._line(lam, (rx, ry), q_g2))
                    x3 = fp.sub(fp.sub(fp.mul(lam, lam), rx), px)
                    ry = fp.sub(fp.mul(lam, fp.sub(rx, x3)), ry)
                    rx = x3
        return f

    def final_exponentiation(self, f):
        e6 = self.e6
        f1 = e6.mul(e6.frob3(f), e6.inverse(f))   # f^(p³−1)
        f2 = e6.mul(e6.frob(f1), f1)              # ^(p+1)
        return e6.pow_const(f2, _HARD)            # ^((p²−p+1)/r)

    def pair(self, p_g1, q_g2):
        return self.final_exponentiation(self.miller_loop(p_g1, q_g2))

    # -- verification shapes -------------------------------------------------
    def assert_pairing_check(self, pairs):
        """Constrain ∏ e(Pᵢ, Qᵢ) == 1 (≙ Pairing.PairingCheck)."""
        e6 = self.e6
        f = e6.one()
        for p1, q2 in pairs:
            f = e6.mul(f, self.miller_loop(p1, q2))
        e6.assert_equal(self.final_exponentiation(f), e6.one())

    def gt_constant(self, v: Fp6D):
        return self.e6.constant(v)

    def assert_pairing_equal(self, pairs, gt_const: Fp6D):
        """Constrain ∏ e(Pᵢ, Qᵢ) == gt_const (host Fp6) — the Groth16
        verification equation with precomputed e(α, β) on the right."""
        e6 = self.e6
        f = e6.one()
        for p1, q2 in pairs:
            f = e6.mul(f, self.miller_loop(p1, q2))
        e6.assert_equal(self.final_exponentiation(f),
                        self.gt_constant(gt_const))
