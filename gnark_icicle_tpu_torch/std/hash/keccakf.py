"""Keccak-f[1600] permutation gadget (≙ reference std/permutation/keccakf).

State is 25 lanes of 64-bit UWords (x + 5y order, as in the spec and the
reference gadget). The host reference implementation lives in
std/hash/mimc.py (_keccak_f over python ints) and is the test oracle.

Copied from gnark_icicle_tpu/std/hash/keccakf.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from ..math_bits import UWord
from .mimc import _RC, _ROT


def keccakf(api, lanes: list) -> list:
    """25 UWord(64) lanes -> 25 UWord(64) lanes after 24 rounds."""
    assert len(lanes) == 25
    # lanes[x + 5y] ↔ state[x][y]
    a = [[lanes[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _RC:
        # theta
        c = []
        for x in range(5):
            t = a[x][0]
            for y in range(1, 5):
                t = t.xor(a[x][y])
            c.append(t)
        for x in range(5):
            d = c[(x - 1) % 5].xor(c[(x + 1) % 5].rol(1))
            for y in range(5):
                a[x][y] = a[x][y].xor(d)
        # rho + pi
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = a[x][y].rol(_ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y].xor(
                    b[(x + 1) % 5][y].not_().and_(b[(x + 2) % 5][y])
                )
        # iota
        a[0][0] = a[0][0].xor(UWord.constant(api, rc, 64))
    return [a[x][y] for y in range(5) for x in range(5)]
