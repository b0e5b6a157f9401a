"""MiMC hash: circuit gadget + host implementation.

Role parity: reference std/hash/mimc/ (gadget — Write/Reset/Sum with
Miyaguchi–Preneel chaining, mimc.go:53-80; encryptPow5 rounds,
encrypt.go:145-153) and gnark-crypto's fr/mimc (the host counterpart whose
round constants come from iterated legacy-Keccak-256 of the ASCII seed
"seed", reduced into fr). BN254 uses x⁵ rounds, 110 of them.

keccak256 here is the legacy (pre-NIST, 0x01 padding) Keccak used by
Ethereum/gnark-crypto — hashlib's sha3_256 pads differently and cannot be
substituted.

Copied from gnark_icicle_tpu/std/hash/mimc.py:1 (legacy keccak256, the
round constants, MiMCHost and the MiMC and EmulatedMiMC gadgets), so that
the port imports nothing of the JAX package; tests/test_torch_copies.py
holds it to the original.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# legacy Keccak-256 (from the Keccak reference spec; 0x01 domain padding)
# ---------------------------------------------------------------------------

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_MASK64 = (1 << 64) - 1


def _rotl(x, n):
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def _keccak_f(state):
    for rc in _RC:
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        state[0][0] ^= rc
    return state


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for 256-bit output
    # pad10*1 with 0x01 domain byte (legacy Keccak, not SHA-3's 0x06)
    pad_len = rate - (len(data) % rate)
    if pad_len >= 2:
        padded = data + b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    else:
        padded = data + b"\x81"
    state = [[0] * 5 for _ in range(5)]
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            x, y = i % 5, i // 5
            state[x][y] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        _keccak_f(state)
    out = b""
    for i in range(4):  # 32 bytes from the rate lanes
        x, y = i % 5, i // 5
        out += state[x][y].to_bytes(8, "little")
    return out


# ---------------------------------------------------------------------------
# round constants (gnark-crypto derivation: iterated keccak256 of "seed")
# ---------------------------------------------------------------------------

_PARAMS = {
    # modulus -> (nb_rounds, exponent)
    # BN254 fr / BLS12-381 fr: x^5, 110 rounds (gnark-crypto fr/mimc)
}
_CONST_CACHE: dict = {}


# Per-field cipher parameters (exponent, rounds) matching gnark-crypto's
# per-curve mimc packages (std/hash/mimc/encrypt.go: encryptPow5 for
# BN254/BLS12-381/BW6-761, encryptPow17 for BLS12-377). The exponent MUST
# be coprime to r-1 for x^d to be a permutation — over BLS12-377's fr,
# gcd(5, r-1) = 5, so x^5 is NOT a cipher there. Rounds follow
# ceil(log2 r / log2 d) like the reference (110/111/62/163).
_FIELD_PARAMS = {
    # bn254.r
    21888242871839275222246405745257275088548364400416034343698204186575808495617: (5, 110),
    # bls12-381.r
    0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001: (5, 111),
    # bls12-377.r
    8444461749428370424248824938781546531375899335154063827935233455917409239041: (17, 62),
    # bw6-761.r
    258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177: (5, 163),
}


def mimc_params(modulus: int) -> tuple:
    """(exponent, rounds) for a field — table hit or the generic rule:
    smallest d in (5, 7, 17) coprime to r-1, rounds = ceil(bits/log2 d)."""
    if modulus in _FIELD_PARAMS:
        return _FIELD_PARAMS[modulus]
    import math
    for d in (5, 7, 17):
        if math.gcd(d, modulus - 1) == 1:
            rounds = math.ceil(modulus.bit_length() / math.log2(d))
            return (d, rounds)
    raise ValueError("no suitable MiMC exponent for this field")


def mimc_constants(modulus: int, nb_rounds: int = 110,
                   seed: bytes = b"seed") -> list:
    key = (modulus, nb_rounds, seed)
    if key not in _CONST_CACHE:
        rnd = keccak256(seed)
        out = []
        for _ in range(nb_rounds):
            rnd = keccak256(rnd)
            out.append(int.from_bytes(rnd, "big") % modulus)
        _CONST_CACHE[key] = out
    return _CONST_CACHE[key]


# ---------------------------------------------------------------------------
# host hash (≙ gnark-crypto fr/mimc)
# ---------------------------------------------------------------------------

class MiMCHost:
    """Host MiMC over fr: Miyaguchi–Preneel chaining of the x^5 cipher."""

    def __init__(self, modulus: int, nb_rounds: int | None = None,
                 exponent: int | None = None):
        self.q = modulus
        d, r = mimc_params(modulus)
        self.e = exponent if exponent is not None else d
        self.constants = mimc_constants(
            modulus, nb_rounds if nb_rounds is not None else r)
        self.h = 0

    def reset(self):
        self.h = 0

    def _encrypt(self, m: int) -> int:
        q = self.q
        x = m
        for c in self.constants:
            x = pow((x + self.h + c) % q, self.e, q)
        return (x + self.h) % q

    def write(self, *values):
        for v in values:
            m = int(v) % self.q
            r = self._encrypt(m)
            self.h = (self.h + r + m) % self.q

    def sum(self, *values) -> int:
        self.write(*values)
        return self.h


def mimc_hash(modulus: int, values) -> int:
    h = MiMCHost(modulus)
    h.write(*values)
    return h.h


# ---------------------------------------------------------------------------
# circuit gadget (≙ std/hash/mimc gadget API)
# ---------------------------------------------------------------------------

class MiMC:
    """In-circuit MiMC (Write/Reset/Sum like the reference gadget)."""

    def __init__(self, api, modulus: int, nb_rounds: int | None = None):
        self.api = api
        d, r = mimc_params(modulus)
        self.e = d
        self.constants = mimc_constants(
            modulus, nb_rounds if nb_rounds is not None else r)
        self.h = 0  # frontend value
        self.data = []

    def write(self, *values):
        self.data.extend(values)

    def reset(self):
        self.data = []
        self.h = 0

    def _pow_d(self, x):
        """x^d by square-multiply (d = 5: 3 muls; d = 17: 5 muls)."""
        api = self.api
        acc = x
        for bit in bin(self.e)[3:]:
            acc = api.mul(acc, acc)
            if bit == "1":
                acc = api.mul(acc, x)
        return acc

    def _encrypt(self, m):
        api = self.api
        x = m
        for c in self.constants:
            x = self._pow_d(api.add(x, self.h, c))
        return api.add(x, self.h)

    def sum(self):
        api = self.api
        for stream in self.data:
            r = self._encrypt(stream)
            self.h = api.add(self.h, r, stream)
        self.data = []
        return self.h


class EmulatedMiMC:
    """In-circuit MiMC over an EMULATED field (≙ the reference's use of
    mimc with a nonnative frontend in recursion transcripts).

    Same Miyaguchi–Preneel chain as MiMC, but every round runs through an
    ``std.emulated.EmulatedField`` — the primitive that lets an outer
    circuit over a different curve replay an inner prover's
    ``fs_hash="mimc"`` Fiat-Shamir challenges (cross-curve recursion,
    reference std/recursion/plonk with sw_bls12381)."""

    def __init__(self, fp, nb_rounds: int | None = None):
        """fp: EmulatedField for the INNER scalar field."""
        self.fp = fp
        d, r = mimc_params(fp.p)
        self.e = d
        self.constants = [
            fp.constant(c) for c in mimc_constants(
                fp.p, nb_rounds if nb_rounds is not None else r)
        ]
        self.h = fp.constant(0)
        self.data = []

    def write(self, *values):
        self.data.extend(values)

    def reset(self):
        self.data = []
        self.h = self.fp.constant(0)

    def _pow_d(self, x):
        fp = self.fp
        acc = x
        for bit in bin(self.e)[3:]:
            acc = fp.mul(acc, acc)
            if bit == "1":
                acc = fp.mul(acc, x)
        return acc

    def _encrypt(self, m):
        fp = self.fp
        x = m
        for c in self.constants:
            x = self._pow_d(fp.add(fp.add(x, self.h), c))
        return fp.add(x, self.h)

    def sum(self):
        fp = self.fp
        for stream in self.data:
            r = self._encrypt(stream)
            self.h = fp.add(fp.add(self.h, r), stream)
        self.data = []
        return self.h
