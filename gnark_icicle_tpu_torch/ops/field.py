"""Prime-field elements as 32-bit limbs on the device, and their plain arithmetic.

Port of gnark_icicle_tpu/ops/field.py (``LimbField`` :96, host limb helpers
:42-93). The reference holds an element as K = 2W 16-bit limbs in an
``(N, K)`` int32 array; the kernels here hold it as W 32-bit words,
limb-major, in a ``(W, N)`` int32 tensor whose words are read as uint32. W is
:func:`words_for` the modulus, ceil((bits + 1) / 32): 8 for both BN254 fields
and the BLS12-381 and BLS12-377 Fr, 12 for their Fp and for BW6-761 Fr, 24
for BW6-761 Fp, so 2W is the reference's limb count
(its :121). Both are Montgomery form with R = 2^(32W), so converting between
them is a bit repack with no arithmetic (:func:`repack16_to_32`,
:func:`repack32_to_16`).

The plain arithmetic (:class:`Field` ``mont_mul``/``add``/``sub``/``neg``/
``to_mont``/``from_mont``) is the PyTorch twin of the CUDA kernels. It works
in int64 on 16-bit limbs, ``(2W, N)``: PyTorch's uint32 arithmetic is
incomplete on the CPU, and a 32x32-bit product does not fit int64. A 16x16
product does, and so does a column of 48 of them (< 2^38), which float64
holds exactly. ``mont_pow``/``mont_inv`` (square and multiply over any
product, :func:`pow_by_squaring`), ``is_zero``, ``eq`` and ``select`` follow
the reference's :292-347.
"""

from __future__ import annotations

import numpy as np
import torch

MASK16 = 0xFFFF


def words_for(modulus: int) -> int:
    """32-bit words per element: one spare bit above p, so that 2p < R."""
    return -(-(modulus.bit_length() + 1) // 32)


# ---------------------------------------------------------------------------
# host <-> limb conversions (numpy)
# ---------------------------------------------------------------------------

def ints_to_limbs32(xs, n_limbs: int) -> np.ndarray:
    """Python ints -> (N, n_limbs) uint32 little-endian limbs."""
    nb = 4 * n_limbs
    try:
        buf = b"".join(int(x).to_bytes(nb, "little") for x in xs)
    except OverflowError as e:  # negative or too wide
        raise ValueError(f"value does not fit in {n_limbs} 32-bit limbs") from e
    return np.frombuffer(buf, dtype="<u4").reshape(-1, n_limbs).astype(np.uint32)


def limbs32_to_ints(arr) -> list:
    """(N, K) uint32 limbs -> Python ints."""
    arr = np.ascontiguousarray(np.asarray(arr).astype("<u4"))
    nb = 4 * arr.shape[-1]
    raw = arr.tobytes()
    return [int.from_bytes(raw[i:i + nb], "little") for i in range(0, len(raw), nb)]


def repack16_to_32(x16) -> np.ndarray:
    """(N, 2K) 16-bit limbs (the reference layout) -> (N, K) uint32 limbs."""
    a = np.asarray(x16).astype(np.uint32)
    return a[:, 0::2] | (a[:, 1::2] << 16)


def repack32_to_16(x32) -> np.ndarray:
    """(N, K) uint32 limbs -> (N, 2K) int32 16-bit limbs (reference layout)."""
    a = np.asarray(x32).astype(np.uint32)
    out = np.empty((a.shape[0], 2 * a.shape[1]), dtype=np.int32)
    out[:, 0::2] = a & MASK16
    out[:, 1::2] = a >> 16
    return out


def to_lanes(x32: np.ndarray, device) -> torch.Tensor:
    """(N, K) uint32 host limbs -> (K, N) int32 limb-major device tensor."""
    a = np.ascontiguousarray(np.asarray(x32, dtype=np.uint32).T)
    return torch.from_numpy(a.view(np.int32)).to(device)


def from_lanes(t: torch.Tensor) -> np.ndarray:
    """(K, N) int32 device tensor -> (N, K) uint32 host limbs."""
    return np.ascontiguousarray(t.detach().cpu().numpy().view(np.uint32).T)


# ---------------------------------------------------------------------------
# (K, N) int32 <-> (2K, N) int64 16-bit limbs (the plain arithmetic's form)
# ---------------------------------------------------------------------------

def to16(x: torch.Tensor) -> torch.Tensor:
    """(W, ...) int32 words -> (2W, ...) int64 16-bit limbs."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & MASK16, v >> 16], dim=1).reshape(
        (2 * x.shape[0],) + tuple(x.shape[1:]))


def to32(x16: torch.Tensor) -> torch.Tensor:
    """(2W, ...) int64 16-bit limbs -> (W, ...) int32 words (uint32 bits)."""
    v = x16[0::2] | (x16[1::2] << 16)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _normalize(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Propagate the carries of non-negative int64 limbs, (C, ...).

    Works in place on x, which callers pass as a fresh temporary. Limbs
    0..C-2 come back in [0, 2^16); the top limb keeps whatever overflows.
    Each round moves every limb's high bits one limb up. The caller gives
    the number of rounds after which its input bound leaves at most a
    one-bit carry that is rare (1 below 2^18, 3 below 2^48); such a carry
    survives only where it meets a run of 0xFFFF limbs, so further rounds
    run only while some limb still exceeds 16 bits.
    """
    for _ in range(rounds):
        c = x[:-1] >> 16
        x[:-1] &= MASK16
        x[1:] += c
    while int(x[:-1].max()) > MASK16:
        c = x[:-1] >> 16
        x[:-1] &= MASK16
        x[1:] += c
    return x


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (2W,) limb vector shaped to broadcast against (2W, ...) limbs."""
    return v.view((-1,) + (1,) * (like.dim() - 1))


class Field:
    """Montgomery arithmetic mod an odd prime p over W = words_for(p) 32-bit
    words (one instance per modulus).

    ``encode``/``decode`` move Python ints to and from ``(W, N)`` Montgomery
    tensors; the arithmetic methods are the plain versions of the kernels and
    accept tensors on any device (a ``(W, 1)`` operand broadcasts).
    """

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.n32 = words_for(modulus)   # W
        self.n16 = 2 * self.n32         # 16-bit limbs of the plain version
        self.R = 1 << (32 * self.n32)
        self.R2 = self.R * self.R % modulus
        self.rinv = pow(self.R, -1, modulus)
        self.nprime = (-pow(modulus, -1, self.R)) % self.R   # -p^-1 mod R
        self.one_mont = self.R % modulus
        self._consts: dict = {}

    # -- constants on a device ---------------------------------------------
    def _c(self, device):
        key = torch.device(device)
        if key not in self._consts:
            K = self.n16

            def limbs16(v):
                return [(v >> (16 * i)) & MASK16 for i in range(K)]

            def toeplitz(v, rows):  # T[r, i] = limb r - i of v: T @ x = v·x
                lv = limbs16(v)
                T = np.zeros((rows, K))
                for r in range(rows):
                    for i in range(K):
                        if 0 <= r - i < K:
                            T[r, i] = lv[r - i]
                return torch.from_numpy(T).to(key)

            p1 = limbs16(self.modulus)
            p1[0] += 1
            self._consts[key] = {
                "negp": torch.tensor(limbs16(self.R - self.modulus),
                                     dtype=torch.int64, device=key),
                "p1": torch.tensor(p1, dtype=torch.int64, device=key),  # p + 1
                "np_t": toeplitz(self.nprime, K),           # mod R: K rows
                "p_t": toeplitz(self.modulus, 2 * K + 1),   # full product
            }
        return self._consts[key]

    # -- host encode/decode ------------------------------------------------
    def encode(self, xs, device) -> torch.Tensor:
        """Python ints -> (W, N) Montgomery-form tensor."""
        q, R = self.modulus, self.R
        return to_lanes(ints_to_limbs32([int(x) % q * R % q for x in xs],
                                        self.n32), device)

    def decode(self, t: torch.Tensor) -> list:
        """(W, N) Montgomery-form tensor -> Python ints."""
        q, rinv = self.modulus, self.rinv
        return [v * rinv % q for v in limbs32_to_ints(from_lanes(t))]

    def encode_plain(self, xs, device) -> torch.Tensor:
        return to_lanes(ints_to_limbs32([int(x) % self.modulus for x in xs],
                                        self.n32), device)

    def decode_plain(self, t: torch.Tensor) -> list:
        return limbs32_to_ints(from_lanes(t))

    def const(self, value: int, device) -> torch.Tensor:
        """(W, 1) Montgomery-form constant."""
        return self.encode([value], device)

    def plain_const(self, value: int, device) -> torch.Tensor:
        """(W, 1) constant taken as it is (R^2 for to_mont, 1 for from_mont)."""
        return to_lanes(ints_to_limbs32([value], self.n32), device)

    # -- plain arithmetic on (2W, N) int64 limbs ----------------------------
    def _cond_sub16(self, x: torch.Tensor, hi) -> torch.Tensor:
        """x + hi·R (< 2p; x normalized 2W limbs) -> mod p.

        x − p is formed as x + (R − p): the top limb of the sum is at least 1
        exactly when x ≥ p, and every addend is non-negative."""
        c = self._c(x.device)
        d = _normalize(torch.cat([x + _col(c["negp"], x), hi[None]]), 1)
        return torch.where(d[-1:] >= 1, d[:-1], x)

    def add16(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        s = _normalize(torch.cat([a + b, torch.zeros_like(a[:1])]), 1)
        return self._cond_sub16(s[:-1], s[-1])

    def sub16(self, a, b):
        """a − b + p as a + p + (R − 1 − b) + 1: non-negative addends; the R
        lands in the top limb and is dropped (as ops/field_t.py:231)."""
        a, b = torch.broadcast_tensors(a, b)
        c = self._c(a.device)
        s = a + (MASK16 - b) + _col(c["p1"], a)
        s = _normalize(torch.cat([s, torch.zeros_like(a[:1])]), 1)
        return self._cond_sub16(s[:-1], s[-1] - 1)

    def neg16(self, a):
        return self.sub16(torch.zeros_like(a), a)

    def mont_mul16(self, a, b):
        """a * b * R^-1 mod p (separated REDC, as LimbField.mont_mul).

        All products are taken in float64, which is exact here: every
        partial sum stays below 2^53. t = a·b as 2K + 1 uncarried columns
        (< K·2^32 < 2^38 for K = 2W ≤ 48 limbs); m = (t mod R)·N' mod R and
        u = m·p as products with constant Toeplitz matrices; then
        (t + u) / R < 2p and one conditional subtraction."""
        a, b = torch.broadcast_tensors(a, b)
        c = self._c(a.device)
        K = self.n16
        n = a.shape[1:]
        af, bf = a.to(torch.float64), b.to(torch.float64)
        t = torch.zeros((2 * K + 1,) + n, dtype=torch.float64, device=a.device)
        for i in range(K):
            t[i:i + K].addcmul_(af[i:i + 1], bf)
        ti = t[:K].to(torch.int64)
        # t mod R with limbs < 2^21 (one split round; the value mod R holds)
        tl = ti & MASK16
        tl[1:] += ti[:-1] >> 16
        m = _normalize(torch.matmul(c["np_t"], tl.to(torch.float64).reshape(K, -1))
                       .to(torch.int64).reshape((K,) + n), 3)
        m[-1] &= MASK16                                      # mod R
        u = torch.matmul(c["p_t"], m.to(torch.float64).reshape(K, -1))
        s = (t + u.reshape((2 * K + 1,) + n)).to(torch.int64)
        # t + u ≡ 0 mod R. Carried limb by limb, its low half ripples one
        # limb per round (K rounds). After three rounds every limb is at most
        # 2^16, so the low half is worth 0 or exactly R: it carries 1 into
        # the high half where any of its limbs is nonzero.
        for _ in range(3):
            carry = s[:-1] >> 16
            s[:-1] &= MASK16
            s[1:] += carry
        hi = s[K:]
        hi[0] += (s[:K] != 0).any(dim=0)
        hi = _normalize(hi, 0)
        return self._cond_sub16(hi[:K], hi[K])

    # -- plain arithmetic on (W, N) int32 words (the kernels' twins) --------
    def mont_mul(self, a, b):
        return to32(self.mont_mul16(to16(a), to16(b)))

    def add(self, a, b):
        return to32(self.add16(to16(a), to16(b)))

    def sub(self, a, b):
        return to32(self.sub16(to16(a), to16(b)))

    def neg(self, a):
        return to32(self.neg16(to16(a)))

    def to_mont(self, x):
        return self.mont_mul(x, self.plain_const(self.R2, x.device))

    def from_mont(self, x):
        return self.mont_mul(x, self.plain_const(1, x.device))

    # -- exponentiation, inversion, predicates (LimbField :292-347) ---------
    def ones(self, n: int, device) -> torch.Tensor:
        """(W, n) Montgomery ones."""
        return self.const(1, device).expand(self.n32, n).contiguous()

    def mont_pow(self, a, e: int):
        """a^e for a fixed public exponent (Montgomery form)."""
        return pow_by_squaring(self.mont_mul, self.ones, a, e)

    def mont_inv(self, a):
        """Inversion by Fermat, a^(p-2); 0 maps to 0."""
        return self.mont_pow(a, self.modulus - 2)

    @staticmethod
    def is_zero(a) -> torch.Tensor:
        return (a == 0).all(dim=0)

    @staticmethod
    def eq(a, b) -> torch.Tensor:
        return (a == b).all(dim=0)

    @staticmethod
    def select(mask, a, b):
        """mask ? a : b, lane by lane (mask: (N,) bool)."""
        return torch.where(mask[None], a, b)


def pow_by_squaring(mul, ones, a, e: int):
    """a^e by square and multiply from the low bit, with ``mul`` the
    Montgomery product and ``ones(n, device)`` the (W, n) ones. The
    exponent is public, so its bits choose the products on the host
    (the reference selects lane-wise inside a scan, LimbField.mont_pow
    :292; the values are the same). A multiply by one is skipped: its
    product is the other factor."""
    result, base = None, a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return ones(a.shape[1], a.device) if result is None else result


_FIELDS: dict = {}


def field_for(modulus: int) -> Field:
    """The one :class:`Field` of a modulus (its device constants are cached)."""
    if modulus not in _FIELDS:
        _FIELDS[modulus] = Field(modulus)
    return _FIELDS[modulus]
