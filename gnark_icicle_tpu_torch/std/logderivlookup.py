"""Append-only lookup tables via the log-derivative argument.

Role parity: reference std/lookup/logderivlookup (logderivlookup.go Table
Insert/Lookup backed by a lookup hint) + std/internal/logderivarg
(logderivarg.go Build — count-multiplicity hint, multicommit randomness,
and the Σ countᵢ/(α−Tᵢ) == Σ 1/(α−Qⱼ) rational identity). O(n+m) constraints
for n entries and m queries.

Copied from gnark_icicle_tpu/std/logderivlookup.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_emulated.py holds it to the original.
"""

from __future__ import annotations

from ..constraint import hints as hintlib
from ..frontend.compile import defer_circuit
from . import multicommit
from .hash.mimc import MiMC


def _lookup_hint(q, inputs):
    """[nb_entries, entries..., indices...] -> values at those indices."""
    nb = int(inputs[0])
    entries = inputs[1 : 1 + nb]
    out = []
    for ind in inputs[1 + nb :]:
        i = int(ind)
        if not 0 <= i < nb:
            raise ValueError(f"lookup index {i} out of bounds (table {nb})")
        out.append(entries[i])
    return out


def _count_hint(q, inputs):
    """[nb_table, nb_row, table rows..., query rows...] -> multiplicity of
    each table row among the queries (≙ logderivarg countHint)."""
    nb_table = int(inputs[0])
    nb_row = int(inputs[1])
    off = 2
    rows = []
    for _ in range(nb_table):
        rows.append(tuple(v % q for v in inputs[off : off + nb_row]))
        off += nb_row
    counts = {}
    while off < len(inputs):
        key = tuple(v % q for v in inputs[off : off + nb_row])
        counts[key] = counts.get(key, 0) + 1
        off += nb_row
    histo = []
    for row in rows:
        histo.append(counts.get(row, 0))
        counts[row] = 0  # duplicate table rows: count goes to the first
    if any(counts.values()):
        raise ValueError("lookup query not present in the table")
    return histo


LOOKUP = hintlib.register_hint(_lookup_hint, "logderivlookup.lookup")
COUNT = hintlib.register_hint(_count_hint, "logderivlookup.count")


def build_argument(api, table_rows: list, query_rows: list) -> None:
    """Constrain every query row to appear in the table (multiplicity
    counted by hint), ≙ logderivarg.Build."""
    if not table_rows:
        raise ValueError("table empty")
    nb_row = len(table_rows[0])
    count_inputs = []
    for row in table_rows:
        count_inputs.extend(row)
    for row in query_rows:
        count_inputs.extend(row)
    exps = api.new_hint(
        COUNT, len(table_rows), len(table_rows), nb_row, *count_inputs
    )

    to_commit = []
    for row in table_rows:
        to_commit.extend(row)
    for row in query_rows:
        to_commit.extend(row)
    to_commit.extend(exps)

    def check(api_, commitment):
        if nb_row == 1:
            coeffs = [1]
        else:
            coeffs = []
            for i in range(nb_row):
                h = MiMC(api_, api_.q)
                h.write(i + 1, commitment)
                coeffs.append(h.sum())
        challenge = commitment

        def rlc(row):
            acc = 0
            for c, v in zip(coeffs, row):
                acc = api_.add(acc, api_.mul(c, v))
            return acc

        # one variadic merge per side: the incremental version re-copied a
        # linear expression growing by one hint wire per row — O(rows²)
        # compile time (the dominant cost of any lookup-heavy circuit)
        lp_terms = [
            api_.div_unchecked(e, api_.sub(challenge, rlc(row)))
            for e, row in zip(exps, table_rows)
        ]
        rp_terms = [
            api_.inverse(api_.sub(challenge, rlc(row)))
            for row in query_rows
        ]
        lp = lp_terms[0] if len(lp_terms) == 1 else api_.add(*lp_terms)
        rp = rp_terms[0] if len(rp_terms) == 1 else api_.add(*rp_terms)
        api_.assert_is_equal(lp, rp)

    multicommit.with_commitment(api, check, *to_commit)


class Table:
    """≙ logderivlookup.Table (New/Insert/Lookup; the argument is deferred
    until after define like the reference's api.Defer(t.commit))."""

    def __init__(self, api):
        self.api = api
        self.entries: list = []
        self.results: list = []  # (index variable, value variable)
        self.immutable = False
        defer_circuit(api, self._commit)

    def insert(self, val) -> int:
        if self.immutable:
            raise RuntimeError("inserting into committed lookup table")
        self.entries.append(val)
        return len(self.entries) - 1

    def lookup(self, *inds) -> list:
        if self.immutable:
            raise RuntimeError("lookup from committed table")
        if not self.entries:
            raise RuntimeError("lookup from empty table")
        vals = self.api.new_hint(
            LOOKUP, len(inds), len(self.entries), *self.entries, *inds
        )
        self.results.extend(zip(inds, vals))
        return vals

    def _commit(self, api):
        self.immutable = True
        if not self.results:
            return
        table_rows = [
            [i, e] for i, e in enumerate(self.entries)
        ]
        query_rows = [[ind, val] for ind, val in self.results]
        build_argument(api, table_rows, query_rows)
