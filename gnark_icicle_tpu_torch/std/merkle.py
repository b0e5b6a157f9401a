"""Merkle proof verification gadget (≙ reference std/accumulator/merkle,
used by the rollup example for account-state inclusion).

Path layout matches the reference: leaf + sibling list bottom-up, with
direction bits selecting (left ‖ right) ordering per level; MiMC as the
compression function.

Copied from gnark_icicle_tpu/std/merkle.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from .hash.mimc import MiMC, MiMCHost


def verify_proof(api, modulus: int, root, leaf, siblings, direction_bits):
    """Constrain `leaf` at the position encoded by direction_bits to hash to
    `root`. direction_bits[i] = 1 means current node is the RIGHT child at
    level i."""
    cur = leaf
    for sib, bit in zip(siblings, direction_bits):
        api.assert_is_boolean(bit)
        left = api.select(bit, sib, cur)
        right = api.select(bit, cur, sib)
        h = MiMC(api, modulus)
        h.write(left, right)
        cur = h.sum()
    api.assert_is_equal(cur, root)


class MerkleTreeHost:
    """Host-side MiMC Merkle tree (fixture builder for tests/rollup)."""

    def __init__(self, modulus: int, leaves: list):
        self.q = modulus
        n = len(leaves)
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        self.levels = [list(leaves)]
        cur = list(leaves)
        while len(cur) > 1:
            nxt = []
            for i in range(0, len(cur), 2):
                h = MiMCHost(modulus)
                h.write(cur[i], cur[i + 1])
                nxt.append(h.h)
            self.levels.append(nxt)
            cur = nxt

    @property
    def root(self) -> int:
        return self.levels[-1][0]

    def proof(self, index: int):
        """(siblings, direction_bits) bottom-up for leaf `index`."""
        sibs, dirs = [], []
        idx = index
        for level in self.levels[:-1]:
            sib = level[idx ^ 1]
            sibs.append(sib)
            dirs.append(idx & 1)  # 1 = we are the right child
            idx >>= 1
        return sibs, dirs

    def update(self, index: int, value: int):
        self.levels[0][index] = value % self.q
        idx = index
        for lvl in range(len(self.levels) - 1):
            base = idx & ~1
            h = MiMCHost(self.q)
            h.write(self.levels[lvl][base], self.levels[lvl][base + 1])
            idx >>= 1
            self.levels[lvl + 1][idx] = h.h
