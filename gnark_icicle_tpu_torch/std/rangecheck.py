"""Range checks via lookup tables (the commit-based variant).

Role parity: reference std/rangecheck (rangecheck_commit.go — decompose into
base-2^b limbs, one shared [0, 2^b) lookup table per circuit, shifted lookup
for the partial top limb; picked over bit decomposition when the builder
supports commitments, frontend/builder.go:94-101 Rangechecker). Cost is
amortized O(bits/b) per check vs O(bits) booleans.

Copied from gnark_icicle_tpu/std/rangecheck.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_emulated.py holds it to the original.
"""

from __future__ import annotations

from ..constraint import hints as hintlib
from ..frontend.compile import defer_circuit
from .logderivlookup import Table


def _decompose_hint(q, inputs):
    """[v, base_bits, k] -> k base-2^b limbs, little-endian."""
    v = inputs[0] % q
    b = int(inputs[1])
    k = int(inputs[2])
    mask = (1 << b) - 1
    return [(v >> (b * i)) & mask for i in range(k)]


DECOMPOSE = hintlib.register_hint(_decompose_hint, "rangecheck.decompose")


class RangeChecker:
    """Shared per-circuit checker (≙ rangecheck.New); construct once in
    define() and call check() for every bounded value."""

    def __init__(self, api, base_bits: int = 8):
        self.api = api
        self.b = base_bits
        self.table = Table(api)
        for i in range(1 << base_bits):
            self.table.insert(i)

    def check(self, v, bits: int) -> None:
        """Constrain 0 ≤ v < 2^bits (≙ Rangechecker.Check)."""
        api = self.api
        b = self.b
        if bits <= 0:
            api.assert_is_equal(v, 0)
            return
        k = (bits + b - 1) // b
        limbs = api.new_hint(DECOMPOSE, k, v, b, k)
        for i, limb in enumerate(limbs):
            self.table.lookup(limb)  # proves limb ∈ [0, 2^b)
            top_bits = bits - b * i
            if i == k - 1 and top_bits < b:
                # partial top limb: limb·2^(b−top) must also be in range ⇒
                # limb < 2^top (≙ the reference's shifted lookup)
                self.table.lookup(api.mul(limb, 1 << (b - top_bits)))
        acc = 0
        for i, limb in enumerate(limbs):
            acc = api.add(acc, api.mul(limb, 1 << (b * i)))
        api.assert_is_equal(acc, v)


def _optimal_base(collected) -> int:
    """Pick the base width minimizing total R1CS cost (≙ optimalWidth /
    nbR1CSConstraints, rangecheck_commit.go:144-185): table rows cost one
    div each, every decomposed limb one inverse, plus one recompose
    equality per checked value."""
    best, best_b = None, 8
    for b in range(2, 18):
        nb_dec = 0
        for _, bits in collected:
            k = (bits + b - 1) // b
            if k * b > bits:
                k += 1          # the shifted most-significant partial limb
            nb_dec += k
        cost = (1 << b) + nb_dec + len(collected) + 1
        if best is None or cost < best:
            best, best_b = cost, b
    return best_b


class CommitRangeChecker:
    """Deferred batcher: collect every check, then at finalization pick the
    OPTIMAL table base width for the actual workload and prove all limbs
    with a single 1-column log-derivative argument (2 constraints/limb +
    1/table row) — ≙ rangecheck_commit.go commitChecker. Shared per
    circuit via `range_checker(api)`."""

    def __init__(self, api):
        self.api = api
        self.collected: list = []   # (variable, bits)
        self.closed = False
        defer_circuit(api, self._commit)

    def check(self, v, bits: int) -> None:
        if self.closed:
            raise RuntimeError("range checker already finalized")
        if bits <= 0:
            self.api.assert_is_equal(v, 0)
            return
        if isinstance(v, int):
            # engine values / folded constants: check inline
            if not 0 <= v < (1 << bits):
                from ..frontend.engine import Engine, EngineUnsatisfiedError

                if isinstance(self.api, Engine):
                    raise EngineUnsatisfiedError(
                        f"range check failed: {v} ≥ 2^{bits}"
                    )
                raise AssertionError("constant out of range")
            return
        self.collected.append((v, bits))

    def _commit(self, api):
        self.closed = True
        if not self.collected:
            return
        b = _optimal_base(self.collected)
        decomposed = []
        for v, bits in self.collected:
            k = (bits + b - 1) // b
            if k == 1 and bits == b:
                decomposed.append(v)
                continue
            limbs = api.new_hint(DECOMPOSE, k, v, b, k)
            acc = 0
            for i, limb in enumerate(limbs):
                decomposed.append(limb)
                acc = api.add(acc, api.mul(limb, 1 << (b * i)))
            api.assert_is_equal(acc, v)
            shift = k * b - bits
            if shift > 0:
                # partial top limb: limb·2^shift must ALSO be < 2^b ⇒
                # limb < 2^(bits − (k−1)·b) (≙ the shifted-lookup trick)
                decomposed.append(api.mul(limbs[k - 1], 1 << shift))
        from .logderivlookup import build_argument

        table_rows = [[i] for i in range(1 << b)]
        query_rows = [[q] for q in decomposed]
        build_argument(api, table_rows, query_rows)


def range_checker(api) -> CommitRangeChecker:
    """The circuit-wide shared deferred checker (≙ rangecheck.New caching
    under a context key, rangecheck_commit.go:31-48)."""
    rc = getattr(api, "_commit_range_checker", None)
    if rc is None:
        rc = CommitRangeChecker(api)
        api._commit_range_checker = rc
    return rc
