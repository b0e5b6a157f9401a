"""Non-native (emulated) modular arithmetic gadget.

Role parity: reference std/math/emulated (doc.go:1-60 — limb decomposition
with limb width w, multiplication checked through a quotient hint and a
carry-chain polynomial identity; emparams for secp256k1/P256/BN254Fp/…).
Round-2 default is the DEFERRED MULCHECK strategy (≙ field_mul.go:16-116
mulCheck): every mul records `a·b = r + k·p + (2^w − X)·c(X)` as a
polynomial identity over the limb basis, all checks share one multicommit
challenge and are verified by a single evaluation each (Schwartz-Zippel),
and quo/rem limb widths are proven through the shared commit-based range
table (rangecheck.range_checker) instead of per-limb bit decomposition —
~5-10x fewer constraints per mul, which is what makes the pairing /
recursion gadgets compilable. strategy="carry" keeps the round-1
bit-decomposed carry-chain path (field_mul.go's pre-mulcheck design).

An emulated element is k limbs of w bits, value = Σ limbs[i]·2^(w·i), kept
reduced (< p) at op boundaries by construction (mul/reduce enforce it).

Copied from gnark_icicle_tpu/std/emulated.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_emulated.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constraint import hints as hintlib


@dataclass(frozen=True)
class EmulatedParams:
    name: str
    modulus: int
    limb_bits: int
    n_limbs: int

    def __post_init__(self):
        assert self.modulus < (1 << (self.limb_bits * self.n_limbs))


# ≙ emparams presets (std/math/emulated/emparams/emparams.go)
SECP256K1_FP = EmulatedParams(
    "secp256k1.fp",
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    64, 4,
)
SECP256K1_FR = EmulatedParams(
    "secp256k1.fr",
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    64, 4,
)
BN254_FP = EmulatedParams(
    "bn254.fp",
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    64, 4,
)
BN254_FR = EmulatedParams(
    "bn254.fr",
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
    64, 4,
)
P256_FP = EmulatedParams(
    "p256.fp",
    0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    64, 4,
)
P256_FR = EmulatedParams(
    "p256.fr",
    0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    64, 4,
)
# ≙ emparams.BLS12381Fp/Fr, BLS12377Fp/Fr, BW6761Fp/Fr — the cross-curve
# recursion fields (emparams.go); moduli shared with curves/{bls12_381,
# bls12_377,bw6_761}
BLS12381_FP = EmulatedParams(
    "bls12-381.fp",
    0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    64, 6,
)
BLS12381_FR = EmulatedParams(
    "bls12-381.fr",
    0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    64, 4,
)
BLS12377_FP = EmulatedParams(
    "bls12-377.fp",
    258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
    64, 6,
)
BLS12377_FR = EmulatedParams(
    "bls12-377.fr",
    8444461749428370424248824938781546531375899335154063827935233455917409239041,
    64, 4,
)
BLS24315_FP = EmulatedParams(
    "bls24-315.fp",
    39705142709513438335025689890408969744933502416914749335064285505637884093126342347073617133569,
    64, 5,
)
BLS24315_FR = EmulatedParams(
    "bls24-315.fr",
    11502027791375260645628074404575422495959608200132055716665986169834464870401,
    64, 4,
)
BW6761_FP = EmulatedParams(
    "bw6-761.fp",
    6891450384315732539396789682275657542479668912536150109513790160209623422243491736087683183289411687640864567753786613451161759120554247759349511699125301598951605099378508850372543631423596795951899700429969112842764913119068299,
    64, 12,
)
BW6761_FR = EmulatedParams(
    "bw6-761.fr",
    258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
    64, 6,
)


def _mulmod_hint(q, inputs):
    """inputs: [x0..k-1, y0..k-1] + static (k, w, p_limb0..k-1) appended —
    outputs the k+1 quotient limbs then k remainder limbs of x·y mod p."""
    k = (len(inputs) - 2) // 3
    assert int(inputs[2 * k]) == k, "mulmod hint layout mismatch"
    w = int(inputs[2 * k + 1])
    mask = (1 << w) - 1
    p = 0
    for i in range(k):
        p += int(inputs[2 * k + 2 + i]) << (w * i)
    x = 0
    y = 0
    for i in range(k):
        # += not |= : lazy (unreduced) limbs exceed w bits and overlap
        x += int(inputs[i]) << (w * i)
        y += int(inputs[k + i]) << (w * i)
    quo, rem = divmod(x * y, p)
    outs = []
    for i in range(k + 1):
        outs.append((quo >> (w * i)) & mask)
    for i in range(k):
        outs.append((rem >> (w * i)) & mask)
    return outs


MULMOD = hintlib.register_hint(_mulmod_hint, "emulated.mulmod")


def _mulcheck_hint(q, inputs):
    """Quotient/remainder/carry limbs for the deferred polynomial identity
    (≙ mulHint, field_mul.go:325-408).

    inputs: a_limbs (a_len) + b_limbs, then the static tail
    [p_limb0..k-1, w, k, a_len, quo_len, carry_len] (statics are appended
    AFTER dynamic inputs by new_hint; parsed back-to-front).
    outputs: quo (quo_len) + rem (k) + carries (carry_len), where
    carry_i = (carry_{i-1} + ab_i − (quo·p + rem)_i) >> w over ℤ
    (floor shift; negative carries appear mod q like any hint output)."""
    carry_len = int(inputs[-1])
    quo_len = int(inputs[-2])
    a_len = int(inputs[-3])
    k = int(inputs[-4])
    w = int(inputs[-5])
    mask = (1 << w) - 1
    p = 0
    for i in range(k):
        p += int(inputs[-5 - k + i]) << (w * i)
    dyn = inputs[: len(inputs) - 5 - k]
    a_limbs = [int(v) for v in dyn[:a_len]]
    b_limbs = [int(v) for v in dyn[a_len:]]
    b_len = len(b_limbs)
    a = sum(v << (w * i) for i, v in enumerate(a_limbs))
    b = sum(v << (w * i) for i, v in enumerate(b_limbs))
    quo, rem = divmod(a * b, p)
    outs = [(quo >> (w * i)) & mask for i in range(quo_len)]
    outs += [(rem >> (w * i)) & mask for i in range(k)]
    p_limbs = [(p >> (w * i)) & mask for i in range(k)]
    # position-wise schoolbook sums of a·b and quo·p + rem
    xp = [0] * (a_len + b_len - 1)
    yp = [0] * max(quo_len + k - 1, k)
    for i, av in enumerate(a_limbs):
        for j, bv in enumerate(b_limbs):
            xp[i + j] += av * bv
    for i in range(k):
        yp[i] += (rem >> (w * i)) & mask
        for j in range(quo_len):
            yp[i + j] += ((quo >> (w * j)) & mask) * p_limbs[i]
    carry = 0
    for i in range(carry_len):
        if i < len(xp):
            carry += xp[i]
        if i < len(yp):
            carry -= yp[i]
        carry >>= w  # floor shift: negatives stay exact (two's complement)
        outs.append(carry % q)
    return outs


MULCHECK = hintlib.register_hint(_mulcheck_hint, "emulated.mulcheck")


def _varmulcheck_hint(q, inputs):
    """MULCHECK with a WITNESS modulus (≙ the reference's variable-modulus
    mulMod hint backing emulated field_ops ModMul/ModExp, hints.go).

    inputs: a_limbs (a_len) + b_limbs (b_len) + m_limbs (k), static tail
    [w, k, a_len, b_len, quo_len, carry_len]. outputs: quo + rem(k) +
    carries, same layout as _mulcheck_hint."""
    carry_len = int(inputs[-1])
    quo_len = int(inputs[-2])
    b_len = int(inputs[-3])
    a_len = int(inputs[-4])
    k = int(inputs[-5])
    w = int(inputs[-6])
    mask = (1 << w) - 1
    dyn = inputs[: len(inputs) - 6]
    a_limbs = [int(v) for v in dyn[:a_len]]
    b_limbs = [int(v) for v in dyn[a_len : a_len + b_len]]
    m_limbs = [int(v) for v in dyn[a_len + b_len :]]
    assert len(m_limbs) == k
    a = sum(v << (w * i) for i, v in enumerate(a_limbs))
    b = sum(v << (w * i) for i, v in enumerate(b_limbs))
    m = sum(v << (w * i) for i, v in enumerate(m_limbs))
    if m == 0:
        raise ValueError("varmulcheck: zero modulus")
    quo, rem = divmod(a * b, m)
    outs = [(quo >> (w * i)) & mask for i in range(quo_len)]
    outs += [(rem >> (w * i)) & mask for i in range(k)]
    xp = [0] * (a_len + b_len - 1)
    yp = [0] * max(quo_len + k - 1, k)
    for i, av in enumerate(a_limbs):
        for j, bv in enumerate(b_limbs):
            xp[i + j] += av * bv
    for i in range(k):
        yp[i] += (rem >> (w * i)) & mask
        for j in range(quo_len):
            yp[i + j] += ((quo >> (w * j)) & mask) * m_limbs[i]
    carry = 0
    for i in range(carry_len):
        if i < len(xp):
            carry += xp[i]
        if i < len(yp):
            carry -= yp[i]
        carry >>= w
        outs.append(carry % q)
    return outs


VARMULCHECK = hintlib.register_hint(_varmulcheck_hint, "emulated.varmulcheck")


def _ltdec_hint(q, inputs):
    """d = m - r - 1 limbs for the r < m borrow-chain proof.
    inputs: r limbs (k) + m limbs (k), static (k, w)."""
    k = int(inputs[-2])
    w = int(inputs[-1])
    mask = (1 << w) - 1
    r = sum(int(v) << (w * i) for i, v in enumerate(inputs[:k]))
    m = sum(int(v) << (w * i) for i, v in enumerate(inputs[k : 2 * k]))
    d = m - r - 1
    if d < 0:
        d = 0  # caught by the in-circuit identity
    return [(d >> (w * i)) & mask for i in range(k)]


LTDEC = hintlib.register_hint(_ltdec_hint, "emulated.ltdec")


def _invmod_hint(q, inputs):
    """inputs: [x0..k-1] + static (k, w, p_limb0..k-1) — limbs of x⁻¹ mod p
    (0 → 0, caught by the mul check)."""
    k = (len(inputs) - 2) // 2
    w = int(inputs[k + 1])
    mask = (1 << w) - 1
    p = 0
    for i in range(k):
        p += int(inputs[k + 2 + i]) << (w * i)
    x = 0
    for i in range(k):
        x += int(inputs[i]) << (w * i)
    x %= p
    inv = pow(x, -1, p) if x else 0
    return [(inv >> (w * i)) & mask for i in range(k)]


INVMOD = hintlib.register_hint(_invmod_hint, "emulated.invmod")


class Element:
    """k limb variables + a per-limb magnitude bound (python int).

    evaluation/is_evaluated cache the challenge-point evaluation during the
    deferred mulcheck pass (≙ Element.evaluation, element.go)."""

    __slots__ = ("limbs", "bound", "evaluation", "is_evaluated")

    def __init__(self, limbs, bound: int):
        self.limbs = list(limbs)
        self.bound = bound  # every limb value is < bound
        self.evaluation = 0
        self.is_evaluated = False


class EmulatedField:
    """Field ops over circuit variables (≙ emulated.Field[T])."""

    def __init__(self, api, params: EmulatedParams, native_modulus: int,
                 strategy: str = "mulcheck"):
        self.api = api
        self.p = params.modulus
        self.w = params.limb_bits
        self.k = params.n_limbs
        self.q = native_modulus
        # native field must hold conv products + carries with slack
        assert 2 * params.limb_bits + 10 < native_modulus.bit_length()
        self.params = params
        assert strategy in ("mulcheck", "carry")
        self.strategy = strategy
        self._mul_checks: list = []
        if strategy == "mulcheck":
            from ..frontend.compile import defer_circuit
            from .rangecheck import range_checker

            self.checker = range_checker(api)
            defer_circuit(api, self._perform_mul_checks)

    # -- width enforcement ---------------------------------------------------
    def _check_width(self, v, bits: int):
        """Range-proof one limb (table-based under mulcheck, bit decomposition
        under the legacy strategy)."""
        if self.strategy == "mulcheck":
            self.checker.check(v, bits)
        else:
            self.api.to_binary(v, bits)

    # -- constructors -------------------------------------------------------
    def constant(self, value: int) -> Element:
        value %= self.p
        limbs = [
            (value >> (self.w * i)) & ((1 << self.w) - 1)
            for i in range(self.k)
        ]
        return Element(limbs, 1 << self.w)

    def from_limbs(self, limb_vars, canonical: bool = False) -> Element:
        """Witness limbs -> range-checked element.

        canonical=True additionally enforces value < p (≙ the reference's
        AssertIsInRange on witness elements); by default only per-limb
        width is enforced — arithmetic is sound for any bounded value since
        all relations hold mod p, but canonical=True pins the unique
        encoding (needed e.g. for signature components).
        """
        assert len(limb_vars) == self.k
        for v in limb_vars:
            self._check_width(v, self.w)  # range check each limb
        e = Element(limb_vars, 1 << self.w)
        if canonical:
            self.assert_canonical(e)
        return e

    def assert_canonical(self, a: Element):
        """Enforce Σ aᵢ·2^(w·i) < p for width-bounded limbs, by big-endian
        lexicographic comparison against p's limbs (strictly-less borrow
        cascade; each limb comparison is one bounded decomposition)."""
        api = self.api
        from .math_cmp import BoundedComparator

        cmp = BoundedComparator(api, 1 << self.w)
        p_limbs = [
            (self.p >> (self.w * i)) & ((1 << self.w) - 1)
            for i in range(self.k)
        ]
        lt = 0   # strictly less established at a higher limb
        eq = 1   # all higher limbs equal so far
        for i in range(self.k - 1, -1, -1):
            li_less = cmp.is_less(a.limbs[i], p_limbs[i])
            li_eq = api.is_zero(api.sub(a.limbs[i], p_limbs[i]))
            lt = api.or_(lt, api.and_(eq, li_less))
            eq = api.and_(eq, li_eq)
        api.assert_is_equal(lt, 1)

    # -- linear ops (lazy, bound-tracked) -------------------------------------
    def add(self, a: Element, b: Element) -> Element:
        limbs = [self.api.add(x, y) for x, y in zip(a.limbs, b.limbs)]
        out = Element(limbs, a.bound + b.bound)
        if out.bound >= (1 << (self.w + 8)):
            return self.reduce(out)
        return out

    def sub(self, a: Element, b: Element) -> Element:
        """a − b + pad where pad ≡ 0 (mod p) and every pad limb ≥ b.bound —
        so limbs never go negative (≙ the reference's subPadding,
        emulated/field_ops.go)."""
        w, k = self.w, self.k
        T = 1 << b.bound.bit_length()  # per-limb floor ≥ b.bound
        base = sum(T << (w * i) for i in range(k))
        delta = (-base) % self.p
        assert delta < (1 << (w * k))
        pad = [
            T + ((delta >> (w * i)) & ((1 << w) - 1)) for i in range(k)
        ]
        limbs = [
            self.api.add(self.api.sub(x, y), pad[i])
            for i, (x, y) in enumerate(zip(a.limbs, b.limbs))
        ]
        out = Element(limbs, a.bound + T + (1 << w))
        if out.bound >= (1 << (w + 8)):
            return self.reduce(out)
        return out

    # -- multiplication / reduction -------------------------------------------
    def mul(self, a: Element, b: Element) -> Element:
        """x·y mod p via quotient hint; the identity is either deferred to
        the shared mulcheck pass (default) or carry-checked inline."""
        if self.strategy == "mulcheck":
            return self._mul_mulcheck(a, b)
        api = self.api
        k, w = self.k, self.w
        # capacity guard: the k+1 quotient limbs hold quo < 2^(w(k+1)),
        # which needs bound_a*bound_b < 2^(3w-3); the lazy add threshold
        # (w+8 bits) keeps inputs far inside this
        assert a.bound * b.bound < (1 << (3 * w - 3)), "emulated bounds blown"
        assert a.bound * b.bound * k * 8 < self.q, "native overflow"

        p_limbs = [
            (self.p >> (w * i)) & ((1 << w) - 1) for i in range(k)
        ]
        outs = self._call_mulmod(a, b)
        quo = outs[: k + 1]
        rem = outs[k + 1 :]
        for v in quo:
            api.to_binary(v, w)
        for v in rem:
            api.to_binary(v, w)

        # identity: conv(a, b) == conv(quo, p) + rem  position-wise with
        # carries: Σ (lhs_i − rhs_i)·2^(wi) = 0
        n_pos = 2 * k + 1
        lhs = [0] * n_pos
        rhs = [0] * n_pos
        for i in range(k):
            for j in range(k):
                lhs[i + j] = api.add(lhs[i + j], api.mul(a.limbs[i], b.limbs[j]))
        for i in range(k + 1):
            for j in range(k):
                rhs[i + j] = api.add(
                    rhs[i + j], api.mul(quo[i], p_limbs[j])
                )
        for i in range(k):
            rhs[i] = api.add(rhs[i], rem[i])

        # carry chain: (lhs_i − rhs_i + carry) must be divisible by 2^w;
        # shift by a constant to stay non-negative before decomposing
        max_mag = (
            k * a.bound * b.bound + (k + 1) * (1 << (2 * w)) + (1 << w)
        )
        max_bits = max_mag.bit_length() + 2
        shift = ((1 << max_bits) >> w) << w  # ≡ 0 mod 2^w
        carry = 0
        for i in range(n_pos - 1):
            u = api.add(api.sub(lhs[i], rhs[i]), carry, shift)
            bits = api.to_binary(u, max_bits + 2)
            lo = api.from_binary(bits[:w])
            api.assert_is_equal(lo, 0)
            hi = api.from_binary(bits[w:])
            carry = api.sub(hi, shift >> w)
        api.assert_is_equal(api.add(api.sub(lhs[n_pos - 1], rhs[n_pos - 1]),
                                    carry), 0)
        return Element(rem, 1 << w)

    def _call_mulmod(self, a: Element, b: Element):
        api = self.api
        k, w = self.k, self.w
        const_args = [k, w] + [
            (self.p >> (w * i)) & ((1 << w) - 1) for i in range(k)
        ]
        return api.new_hint(
            MULMOD, 2 * k + 1, *a.limbs, *b.limbs,
            static_args=tuple(const_args),
        )

    # -- deferred mulcheck strategy (≙ field_mul.go mulCheck) ----------------
    def _val_max(self, e: Element) -> int:
        """Max integer value of an element with per-limb bound e.bound."""
        k = len(e.limbs)
        return (e.bound - 1) * ((1 << (self.w * k)) - 1) // ((1 << self.w) - 1)

    def _mulcheck_dims(self, a: Element, b: Element):
        """quo/carry limb counts for a given input pair (≙ callMulHint's
        nbQuoLimbs/nbCarryLimbs, field_mul.go:256-296)."""
        w, k = self.w, self.k
        quo_max = (self._val_max(a) * self._val_max(b)) // self.p
        quo_len = max(1, (quo_max.bit_length() + w - 1) // w)
        carry_len = max(len(a.limbs) + len(b.limbs) - 1, quo_len + k - 1) - 1
        return quo_len, carry_len

    def _call_mulcheck(self, a: Element, b: Element, quo_len: int,
                       carry_len: int):
        w, k = self.w, self.k
        statics = tuple(
            (self.p >> (w * i)) & ((1 << w) - 1) for i in range(k)
        ) + (w, k, len(a.limbs), quo_len, carry_len)
        outs = self.api.new_hint(
            MULCHECK, quo_len + k + carry_len, *a.limbs, *b.limbs,
            static_args=statics,
        )
        return outs[:quo_len], outs[quo_len : quo_len + k], outs[quo_len + k :]

    def _strict_rem_widths(self):
        """Per-limb widths pinning rem < 2^(p.bit_length()) (≙ enforceWidth
        strict: the top limb gets only the modulus' residual bits)."""
        w, k = self.w, self.k
        top = self.p.bit_length() - w * (k - 1)
        assert 0 < top <= w
        return [w] * (k - 1) + [top]

    def _value_of(self, e: Element) -> int:
        """Engine-only: concrete integer value of an element."""
        return sum(int(v) << (self.w * i) for i, v in enumerate(e.limbs))

    def _engine_api(self):
        from ..frontend.engine import Engine

        return isinstance(self.api, Engine)

    def _mul_mulcheck(self, a: Element, b: Element) -> Element:
        """Record a·b = r + k·p (+ carry alignment) for the deferred
        evaluation pass; range-check quo/rem limbs via the shared table.

        Under the big-int test Engine everything is concrete, so the
        identity holds by construction and nothing is recorded — raw-Engine
        gadget use (no define lifecycle) stays sound because the only
        failable check, _check_zero, is evaluated inline there."""
        if self._engine_api():
            val = self._value_of(a) * self._value_of(b) % self.p
            return self.constant(val)
        # native capacity: coefficient sums of the limb polynomials must not
        # wrap mod q for the Schwartz-Zippel identity to bind integers
        assert a.bound * b.bound * max(self.k, 2) * (1 << (self.w + 2)) \
            < self.q, "native overflow"
        quo_len, carry_len = self._mulcheck_dims(a, b)
        quo, rem, car = self._call_mulcheck(a, b, quo_len, carry_len)
        for v in quo:
            self._check_width(v, self.w)
        for v, bits in zip(rem, self._strict_rem_widths()):
            self._check_width(v, bits)
        r_el = Element(rem, 1 << self.w)
        self._mul_checks.append(
            (a, b, r_el, Element(quo, 1 << self.w), Element(car, 0), None)
        )
        return r_el

    def _check_zero(self, a: Element):
        """Record a·1 = 0 + k·p (≙ checkZero, field_mul.go:140-160)."""
        if self._engine_api():
            from ..frontend.engine import EngineUnsatisfiedError

            if self._value_of(a) % self.p != 0:
                raise EngineUnsatisfiedError(
                    "emulated assert_equal: difference not ≡ 0 mod p"
                )
            return
        one = Element([1], 2)
        quo_len, carry_len = self._mulcheck_dims(a, one)
        quo, _rem, car = self._call_mulcheck(a, one, quo_len, carry_len)
        for v in quo:
            self._check_width(v, self.w)
        zero = Element([], 1)  # r ≡ 0 on zero limbs
        self._mul_checks.append(
            (a, one, zero, Element(quo, 1 << self.w), Element(car, 0), None)
        )

    def _eval_with_challenge(self, e: Element, at):
        """e(ch) = Σ limbs[i]·ch^i, cached on the element (≙
        evalWithChallenge, field_mul.go:166-183)."""
        if e.is_evaluated:
            return e.evaluation
        s = e.limbs[0] if e.limbs else 0
        for i in range(1, len(e.limbs)):
            s = self.api.add(s, self.api.mul(e.limbs[i], at[i - 1]))
        e.evaluation = s
        e.is_evaluated = True
        return s

    def _perform_mul_checks(self, api):
        """Deferred: one multicommit challenge, every recorded identity
        checked by a single evaluation a(ch)·b(ch) = r(ch) + k(ch)·p(ch) +
        (2^w − ch)·c(ch) (≙ performMulChecks, field_mul.go:187-254)."""
        checks = self._mul_checks
        if not checks:
            return
        from . import multicommit

        to_commit = []
        for rec in checks:
            for el in rec:
                if el is not None:
                    to_commit.extend(el.limbs)

        def run(api_, ch):
            n_pow = max(
                max(len(el.limbs) for el in rec if el is not None)
                for rec in checks
            )
            at = [ch]
            for _ in range(n_pow - 2):
                at.append(api_.mul(at[-1], ch))
            p_el = self.constant_element_p()
            p_eval = self._eval_with_challenge(p_el, at)
            coef = api_.sub(1 << self.w, ch)
            for a, b, r, q_el, c, m_el in checks:
                ls = api_.mul(
                    self._eval_with_challenge(a, at),
                    self._eval_with_challenge(b, at),
                )
                mod_eval = (p_eval if m_el is None
                            else self._eval_with_challenge(m_el, at))
                rs = api_.add(
                    self._eval_with_challenge(r, at),
                    api_.mul(mod_eval, self._eval_with_challenge(q_el, at)),
                    api_.mul(self._eval_with_challenge(c, at), coef),
                )
                api_.assert_is_equal(ls, rs)
            for rec in checks:
                for el in rec:
                    if el is None:
                        continue
                    el.evaluation = 0
                    el.is_evaluated = False
            self._mul_checks = []

        multicommit.with_commitment(api, run, *to_commit)

    def constant_element_p(self) -> Element:
        """p as a (constant-limb) element for the deferred evaluation."""
        w, k = self.w, self.k
        return Element(
            [(self.p >> (w * i)) & ((1 << w) - 1) for i in range(k)],
            1 << w,
        )

    def reduce(self, a: Element) -> Element:
        """a mod p (re-canonicalize after lazy adds) = mul(a, 1)."""
        return self.mul(a, self.constant(1))

    def neg(self, a: Element) -> Element:
        return self.sub(self.constant(0), a)

    def mul_small(self, a: Element, c: int) -> Element:
        """a·c for a small non-negative int constant — lazy limb scaling
        (≙ Field.MulConst)."""
        assert 0 <= c < (1 << 8)
        if c == 0:
            return self.constant(0)
        limbs = [self.api.mul(x, c) for x in a.limbs]
        out = Element(limbs, a.bound * c)
        if out.bound >= (1 << (self.w + 8)):
            return self.reduce(out)
        return out

    def select(self, cond, t: Element, f: Element) -> Element:
        """cond ? t : f, limb-wise (≙ emulated Field.Select)."""
        limbs = [
            self.api.select(cond, x, y) for x, y in zip(t.limbs, f.limbs)
        ]
        return Element(limbs, max(t.bound, f.bound))

    def inverse(self, a: Element) -> Element:
        """a⁻¹ mod p, proving a ≠ 0 (≙ Field.Inverse: hint + a·inv == 1)."""
        api = self.api
        k, w = self.k, self.w
        const_args = [k, w] + [
            (self.p >> (w * i)) & ((1 << w) - 1) for i in range(k)
        ]
        inv_limbs = api.new_hint(
            INVMOD, k, *a.limbs, static_args=tuple(const_args)
        )
        for v in inv_limbs:
            self._check_width(v, w)
        inv = Element(inv_limbs, 1 << w)
        prod = self.mul(a, inv)  # canonical remainder
        one = self.constant(1)
        for x, c in zip(prod.limbs, one.limbs):
            api.assert_is_equal(x, c)
        return inv

    def div(self, a: Element, b: Element) -> Element:
        """a/b, proving b ≠ 0 (≙ Field.Div)."""
        return self.mul(a, self.inverse(b))

    def is_zero(self, a: Element):
        """Native boolean: 1 iff a ≡ 0 (mod p).

        The hint remainder from reduce() is only limb-width-bounded, so a
        malicious witness could encode 0 as p; assert_canonical pins the
        unique representative before the limb-wise zero test."""
        r = self.reduce(a)
        self.assert_canonical(r)
        z = self.api.is_zero(r.limbs[0])
        for limb in r.limbs[1:]:
            z = self.api.and_(z, self.api.is_zero(limb))
        return z

    def bits(self, a: Element):
        """k·w little-endian bits of the canonical value (≙ Field.ToBits).

        assert_canonical forces the unique (< p) decomposition — without it
        a prover could exhibit the +p alias of a small value."""
        r = self.reduce(a)
        self.assert_canonical(r)
        out = []
        for limb in r.limbs:
            out.extend(self.api.to_binary(limb, self.w))
        return out

    def from_native(self, v, n_bits: int | None = None) -> Element:
        """Bind a NATIVE circuit variable to an emulated element of this
        field (≙ emulated.Field.NewElement over a frontend.Variable — the
        recursion verifiers' bridge from native public inputs to emulated
        scalars). By default requires p ≥ q so every native value has a
        canonical representation; the full-width bit decomposition plus the
        canonical check pins the unique encoding (the +q alias of small
        values would fail assert_canonical when p == q, and cannot fit
        when p > q). n_bits overrides the decomposition width for values
        KNOWN to be < 2^n_bits ≤ p even when the native field is larger
        (e.g. 64-bit transcript limbs inside a 377-bit BW6-761 circuit) —
        the n_bits decomposition is itself the range proof."""
        if n_bits is None:
            assert self.p >= self.q, \
                "native field does not embed in this field"
            n = self.q.bit_length()
        else:
            assert (1 << n_bits) <= self.p
            n = n_bits
        api = self.api
        bits = api.to_binary(v, n)
        bits = bits + [0] * (self.k * self.w - n)
        limbs = [
            api.from_binary(bits[i * self.w:(i + 1) * self.w])
            for i in range(self.k)
        ]
        e = Element(limbs, 1 << self.w)
        self.assert_canonical(e)
        return e

    def from_foreign(self, a: Element, other: "EmulatedField") -> Element:
        """Reinterpret another field's element (same limb layout) as a value
        mod this field's modulus — e.g. an Fp x-coordinate reduced mod the
        curve order for ECDSA (≙ the reference's x-mod-n step,
        std/signature/ecdsa/ecdsa.go Verify).

        The element is canonicalized in ITS OWN field first: lazy limbs are
        only congruent mod other.p, and congruence does not survive the
        change of modulus."""
        assert other.w == self.w and other.k == self.k
        a = other.reduce(a)
        return self.reduce(Element(list(a.limbs), a.bound))

    # -- predicates -------------------------------------------------------------
    def assert_equal(self, a: Element, b: Element):
        d = self.sub(a, b)
        if self.strategy == "mulcheck":
            self._check_zero(d)  # d·1 = 0 + k·p — one deferred check
            return
        d = self.reduce(d)
        for limb in d.limbs:
            self.api.assert_is_equal(limb, 0)

    def value_hint(self, a: Element) -> int:
        """Engine-side convenience (tests): collapse constant limbs."""
        total = 0
        for i, v in enumerate(a.limbs):
            total += int(v) << (self.w * i)
        return total % self.p

    # -- variable-modulus arithmetic (≙ emulated field_ops ModMul/ModExp) ----
    def assert_elem_lt(self, a: Element, b: Element):
        """a < b as k·w-bit INTEGERS (not mod p): hint d = b − a − 1 and
        prove a + d + 1 == b by a limb carry chain. Requires canonical-width
        limbs on both sides (reduce/from_limbs first)."""
        api = self.api
        k, w = self.k, self.w
        assert len(a.limbs) == k and len(b.limbs) == k
        d = api.new_hint(LTDEC, k, *a.limbs, *b.limbs,
                         static_args=(k, w))
        for v in d:
            self._check_width(v, w)
        carry = 0
        for i in range(k):
            s = api.add(a.limbs[i], d[i], carry, 1 if i == 0 else 0)
            bits = api.to_binary(s, w + 1)
            low = 0
            for j, bit in enumerate(bits[:w]):
                low = api.add(low, api.mul(bit, 1 << j)) if j else bit
            api.assert_is_equal(low, b.limbs[i])
            carry = bits[w]
        api.assert_is_equal(carry, 0)

    def _limbs_is_zero(self, a: Element):
        """Native boolean: all limbs are literally zero (an INTEGER zero
        test — unlike is_zero, no mod-p aliasing)."""
        api = self.api
        acc = None
        for v in a.limbs:
            z = api.is_zero(v)
            acc = z if acc is None else api.and_(acc, z)
        return acc

    def mod_mul(self, a: Element, b: Element, m: Element) -> Element:
        """a·b mod m for a WITNESS modulus m ≥ 1 (≙ field_ops ModMul):
        hinted (quo, rem), the integer identity a·b == quo·m + rem joins
        the deferred mulcheck pass with m's own challenge evaluation, and
        rem < m is proven by the borrow chain — so the result is the
        canonical representative."""
        if self._engine_api():
            av, bv, mv = (self._value_of(x) for x in (a, b, m))
            if mv == 0:
                from ..frontend.engine import EngineUnsatisfiedError

                raise EngineUnsatisfiedError("mod_mul: zero modulus")
            return self.constant_raw(av * bv % mv)
        api = self.api
        k, w = self.k, self.w
        assert len(m.limbs) == k
        assert a.bound * b.bound * max(self.k, 2) * (1 << (self.w + 2)) \
            < self.q, "native overflow"
        a_len, b_len = len(a.limbs), len(b.limbs)
        # worst-case quotient: m ≥ 1 ⇒ quo ≤ a·b < 2^(w(a_len+b_len))
        quo_len = a_len + b_len
        carry_len = max(a_len + b_len - 1, quo_len + k - 1) - 1
        outs = api.new_hint(
            VARMULCHECK, quo_len + k + carry_len,
            *a.limbs, *b.limbs, *m.limbs,
            static_args=(w, k, a_len, b_len, quo_len, carry_len),
        )
        quo = outs[:quo_len]
        rem = outs[quo_len : quo_len + k]
        car = outs[quo_len + k :]
        for v in quo:
            self._check_width(v, w)
        for v in rem:
            self._check_width(v, w)
        r_el = Element(rem, 1 << w)
        self._mul_checks.append(
            (a, b, r_el, Element(quo, 1 << w), Element(car, 0), m)
        )
        self.assert_elem_lt(r_el, m)
        return r_el

    def constant_raw(self, value: int) -> Element:
        """Limb constant WITHOUT mod-p reduction (variable-modulus values
        live in [0, 2^(k·w)), independent of p)."""
        assert 0 <= value < (1 << (self.w * self.k))
        limbs = [
            (value >> (self.w * i)) & ((1 << self.w) - 1)
            for i in range(self.k)
        ]
        return Element(limbs, 1 << self.w)

    def mod_exp(self, base: Element, exp: Element, m: Element) -> Element:
        """base^exp mod m for witness m ≥ 2 (≙ field_ops ModExp /
        evmprecompiles.Expmod's core): reduce base, then a k·w-bit
        MSB-first square-multiply with per-bit select."""
        if self._engine_api():
            bv, ev, mv = (self._value_of(x) for x in (base, exp, m))
            if mv == 0:
                from ..frontend.engine import EngineUnsatisfiedError

                raise EngineUnsatisfiedError("mod_exp: zero modulus")
            return self.constant_raw(pow(bv, ev, mv))
        api = self.api
        one = self.constant_raw(1)
        acc = one
        base_red = self.mod_mul(base, one, m)  # base mod m
        exp_bits = []
        for limb in exp.limbs:
            exp_bits.extend(api.to_binary(limb, self.w))
        for bit in reversed(exp_bits):
            acc = self.mod_mul(acc, acc, m)
            factor = self.select(bit, base_red, one)
            acc = self.mod_mul(acc, factor, m)
        return acc
