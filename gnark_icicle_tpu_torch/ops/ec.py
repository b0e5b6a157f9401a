"""Plain PyTorch group law of a=0 short-Weierstrass curves (G1 and G2).

Port of gnark_icicle_tpu/ops/ec.py (``DevField`` :30, ``DevField2`` :97,
``DevCurve`` :191): the complete Renes–Costello–Batina 2016 formulas
(algorithms 7-9), identity (0 : 1 : 0), ``from_affine`` and
``to_affine_host`` (:366). This is the plain version that the G1 and G2
kernels (``ops/ec_t.py``) are held against; it is the path their wrappers
take for CPU tensors.

Coordinates are 16-bit limbs in int64, ``(2W, N)`` (``ops/field.py``
``to16``): a G1 coordinate is one such tensor, a G2 coordinate over Fp2 a
pair ``(c0, c1)``. The schedules are the reference's products and sums, each
round of independent products issued as one batched call; every field result
is canonical, so the projective limbs agree with the reference's.
"""

from __future__ import annotations

import torch

from .field import Field, to32


class DevField:
    """Base-field adapter: elements are (2W, N) int64 limb tensors."""

    def __init__(self, F: Field):
        self.F = F

    def mul(self, a, b):
        return self.F.mont_mul16(a, b)

    def add(self, a, b):
        return self.F.add16(a, b)

    # k independent operations as one call over stacked operands: the plain
    # arithmetic's cost is mostly per call at the lane counts of small MSMs
    def _many(self, op, pairs):
        A = torch.stack(torch.broadcast_tensors(*[a for a, _ in pairs]), dim=1)
        B = torch.stack(torch.broadcast_tensors(*[b for _, b in pairs]), dim=1)
        return op(A, B).unbind(dim=1)

    def mul_many(self, pairs):
        return self._many(self.F.mont_mul16, pairs)

    def add_many(self, pairs):
        return self._many(self.F.add16, pairs)

    def sub_many(self, pairs):
        return self._many(self.F.sub16, pairs)

    def sub(self, a, b):
        return self.F.sub16(a, b)

    def neg(self, a):
        return self.F.neg16(a)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        return self.const(1, a)

    def select(self, mask, a, b):
        return torch.where(mask, a, b)

    def const(self, value: int, like):
        m = value % self.F.modulus * self.F.R % self.F.modulus
        col = torch.tensor([(m >> (16 * i)) & 0xFFFF for i in range(self.F.n16)],
                           dtype=torch.int64, device=like.device)
        return col[:, None].expand_as(like).clone()

    def decode(self, a) -> list:
        """(2W, N) Montgomery limbs -> Python ints."""
        return self.F.decode(to32(a))


class DevField2:
    """Fp2 = Fp[u]/(u² − β), β < 0: elements are (c0, c1) pairs."""

    def __init__(self, F: Field, beta: int = -1):
        assert beta < 0, "device Fp2 expects a small negative non-residue"
        self.F = F
        self.beta = beta
        self.base = DevField(F)

    def _beta_term(self, m1):
        """−β·m1 by an add chain (β is −1 or −5)."""
        F = self.F
        k = -self.beta
        acc, run = None, m1
        while k:
            if k & 1:
                acc = run if acc is None else F.add16(acc, run)
            k >>= 1
            if k:
                run = F.add16(run, run)
        return acc

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """Karatsuba for every pair, each stage one base call:
        c0 = m0 + β·m1, c1 = (a0+a1)(b0+b1) − (m0 + m1)."""
        base, k = self.base, len(pairs)
        sums = base.add_many([(a[0], a[1]) for a, _ in pairs]
                             + [(b[0], b[1]) for _, b in pairs])
        m = base.mul_many([(a[0], b[0]) for a, b in pairs]
                          + [(a[1], b[1]) for a, b in pairs]
                          + list(zip(sums[:k], sums[k:])))
        m0, m1, m2 = m[:k], m[k:2 * k], m[2 * k:]
        m01 = base.add_many(list(zip(m0, m1)))
        d = base.sub_many(list(zip(m2, m01))
                          + [(x, self._beta_term(y)) for x, y in zip(m0, m1)])
        return [(d[k + i], d[i]) for i in range(k)]

    def _pairs(self, op, pairs):
        flat = [(a[j], b[j]) for a, b in pairs for j in (0, 1)]
        r = op(flat)
        return [(r[2 * i], r[2 * i + 1]) for i in range(len(pairs))]

    def add_many(self, pairs):
        return self._pairs(self.base.add_many, pairs)

    def sub_many(self, pairs):
        return self._pairs(self.base.sub_many, pairs)

    def add(self, a, b):
        return (self.F.add16(a[0], b[0]), self.F.add16(a[1], b[1]))

    def sub(self, a, b):
        return (self.F.sub16(a[0], b[0]), self.F.sub16(a[1], b[1]))

    def neg(self, a):
        return (self.F.neg16(a[0]), self.F.neg16(a[1]))

    def zero_like(self, a):
        return (torch.zeros_like(a[0]), torch.zeros_like(a[1]))

    def one_like(self, a):
        return (self.base.const(1, a[0]), torch.zeros_like(a[1]))

    def select(self, mask, a, b):
        return (torch.where(mask, a[0], b[0]), torch.where(mask, a[1], b[1]))

    def const(self, value, like):
        """value: host Fp2 (curves.tower) or a (c0, c1) pair of ints."""
        c0, c1 = (value.c0, value.c1) if hasattr(value, "c0") else value
        return (self.base.const(c0, like[0]), self.base.const(c1, like[1]))

    def decode(self, a) -> list:
        return list(zip(self.base.decode(a[0]), self.base.decode(a[1])))


class IntField:
    """DevField's interface over lists of Python ints, one a lane, in
    Montgomery form: the canonical values that the limb arithmetic gives
    (a·b·R⁻¹, a ± b mod p). The plain group law takes it for a few lanes on
    the CPU (``ops/ec_t.py`` ``_plain``), where the limb arithmetic costs
    about a millisecond a call whatever the lane count."""

    def __init__(self, F: Field):
        self.F = F
        self.p = F.modulus

    def mul(self, a, b):
        p, rinv = self.p, self.F.rinv
        return [x * y * rinv % p for x, y in zip(a, b)]

    def add(self, a, b):
        p = self.p
        return [(x + y) % p for x, y in zip(a, b)]

    def sub(self, a, b):
        p = self.p
        return [(x - y) % p for x, y in zip(a, b)]

    def neg(self, a):
        return [-x % self.p for x in a]

    def mul_many(self, pairs):
        return [self.mul(a, b) for a, b in pairs]

    def add_many(self, pairs):
        return [self.add(a, b) for a, b in pairs]

    def sub_many(self, pairs):
        return [self.sub(a, b) for a, b in pairs]

    def const(self, value: int, like):
        return [value % self.p * self.F.R % self.p] * len(like)


class IntField2:
    """DevField2's interface over (c0, c1) pairs of IntField lanes, u² = β."""

    def __init__(self, F: Field, beta: int):
        self.base = IntField(F)
        self.p, self.beta = F.modulus, beta

    def mul(self, a, b):
        p, rinv, beta = self.p, self.base.F.rinv, self.beta
        c0 = [(x0 * y0 + beta * x1 * y1) * rinv % p
              for x0, x1, y0, y1 in zip(a[0], a[1], b[0], b[1])]
        c1 = [(x0 * y1 + x1 * y0) * rinv % p
              for x0, x1, y0, y1 in zip(a[0], a[1], b[0], b[1])]
        return (c0, c1)

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def mul_many(self, pairs):
        return [self.mul(a, b) for a, b in pairs]

    def add_many(self, pairs):
        return [self.add(a, b) for a, b in pairs]

    def sub_many(self, pairs):
        return [self.sub(a, b) for a, b in pairs]

    def const(self, value, like):
        c0, c1 = (value.c0, value.c1) if hasattr(value, "c0") else value
        return (self.base.const(c0, like[0]), self.base.const(c1, like[1]))


class DevCurve:
    """Batched a=0 group law over a field adapter; ``b3`` = 3·b, a host int
    for G1 and a host Fp2 or (c0, c1) pair for G2."""

    def __init__(self, fops, b3_host):
        self.f = fops
        self.b3_host = b3_host

    def from_affine(self, x, y, inf_mask=None):
        f = self.f
        one = f.one_like(x)
        if inf_mask is None:
            return (x, y, one)
        return (f.select(inf_mask, f.zero_like(x), x),
                f.select(inf_mask, one, y),
                f.select(inf_mask, f.zero_like(x), one))

    def _b3(self, like):
        return self.f.const(self.b3_host, like)

    # RCB16 (ops/ec.py:252-332), one batched field call per round
    def add(self, P, Q):
        f = self.f
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        b3 = self._b3(X1)
        s = f.add_many([(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1),
                        (X2, Z2)])
        t0, t1, t2, t3, t4, Y3 = f.mul_many(
            [(X1, X2), (Y1, Y2), (Z1, Z2), (s[0], s[1]), (s[2], s[3]),
             (s[4], s[5])])
        u = f.add_many([(t0, t1), (t1, t2), (t0, t2), (t0, t0)])
        t3, t4, Y3 = f.sub_many([(t3, u[0]), (t4, u[1]), (Y3, u[2])])
        t0 = f.add(u[3], t0)  # 3·X1X2
        t2, Y3 = f.mul_many([(b3, t2), (b3, Y3)])
        Z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        m = f.mul_many([(t3, t1), (t4, Y3), (Y3, t0), (t1, Z3), (Z3, t4),
                        (t0, t3)])
        X3 = f.sub(m[0], m[1])
        Y3, Z3 = f.add_many([(m[2], m[3]), (m[4], m[5])])
        return (X3, Y3, Z3)

    def add_mixed(self, P, Q_affine):
        """P (projective) + Q (affine, not infinity)."""
        f = self.f
        X1, Y1, Z1 = P
        X2, Y2 = Q_affine
        b3 = self._b3(X1)
        s = f.add_many([(X1, Y1), (X2, Y2)])
        t0, t1, t3, y2z1, x2z1, t2 = f.mul_many(
            [(X1, X2), (Y1, Y2), (s[0], s[1]), (Y2, Z1), (X2, Z1), (b3, Z1)])
        u = f.add_many([(t0, t1), (y2z1, Y1), (x2z1, X1), (t0, t0), (t1, t2)])
        t4, Y3, Z3 = u[1], u[2], u[4]
        t3, t1 = f.sub_many([(t3, u[0]), (t1, t2)])
        t0 = f.add(u[3], t0)  # 3·X1X2
        Y3 = f.mul(b3, Y3)
        m = f.mul_many([(t3, t1), (t4, Y3), (Y3, t0), (t1, Z3), (Z3, t4),
                        (t0, t3)])
        X3 = f.sub(m[0], m[1])
        Y3, Z3 = f.add_many([(m[2], m[3]), (m[4], m[5])])
        return (X3, Y3, Z3)

    def double(self, P):
        f = self.f
        X, Y, Z = P
        b3 = self._b3(X)
        t0, t1, zz, xy = f.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        Z3 = f.add(t0, t0)
        Z3 = f.add(Z3, Z3)
        Z3 = f.add(Z3, Z3)  # 8Y²
        t2 = f.mul(b3, zz)
        X3, Z3 = f.mul_many([(t2, Z3), (t1, Z3)])
        Y3, t1 = f.add_many([(t0, t2), (t2, t2)])
        t2 = f.add(t1, t2)
        t0 = f.sub(t0, t2)
        m = f.mul_many([(t0, Y3), (t0, xy)])
        Y3, X3 = f.add_many([(m[0], X3), (m[1], m[1])])
        return (X3, Y3, Z3)

    def neg(self, P):
        X, Y, Z = P
        return (X, self.f.neg(Y), Z)

    def select(self, mask, P, Q):
        return tuple(self.f.select(mask, a, b) for a, b in zip(P, Q))

    def to_affine_host(self, P, p_modulus: int) -> list:
        """Projective points -> host affine tuples (None = infinity).

        The reference inverts each Z on its own (ops/ec.py:366); here all
        nonzero Z are inverted at once by Montgomery's trick (for Fp2 through
        their norms), which gives the same points."""
        f = self.f
        xs, ys, zs = (f.decode(c) for c in P)
        beta = getattr(f, "beta", -1)
        live = [i for i, z in enumerate(zs) if not _is0(z)]
        out = [None] * len(zs)
        for i, zi in zip(live, _inv_many([zs[i] for i in live], p_modulus, beta)):
            out[i] = (_mul(xs[i], zi, p_modulus, beta),
                      _mul(ys[i], zi, p_modulus, beta))
        return out


def _batch_inv(xs, q):
    """Inverses of nonzero ints by Montgomery's trick. Copied from
    gnark_icicle_tpu/backend/groth16/setup.py:62."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % q
    inv = pow(prefix[n], -1, q)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = inv * prefix[i] % q
        inv = inv * xs[i] % q
    return out


def _inv_many(zs, p, beta=-1):
    """Inverses of nonzero Fp ints or Fp2 (c0, c1) pairs:
    1/z = conj(z)/(c0² − β·c1²) for Fp2, one batch inversion of the norms."""
    if not zs or isinstance(zs[0], int):
        return _batch_inv(zs, p)
    norms = _batch_inv([(c0 * c0 - beta * c1 * c1) % p for c0, c1 in zs], p)
    return [(c0 * d % p, -c1 * d % p) for (c0, c1), d in zip(zs, norms)]


# host helpers, copied from gnark_icicle_tpu/ops/ec.py:385-403 (_inv is
# _inv_many above, over a batch)
def _is0(z):
    return z == 0 if isinstance(z, int) else (z[0] == 0 and z[1] == 0)


def _mul(a, b, p, beta=-1):
    if isinstance(a, int) and isinstance(b, int):
        return a * b % p
    a0, a1 = a if isinstance(a, tuple) else (a, 0)
    b0, b1 = b if isinstance(b, tuple) else (b, 0)
    return ((a0 * b0 + beta * a1 * b1) % p, (a0 * b1 + a1 * b0) % p)
