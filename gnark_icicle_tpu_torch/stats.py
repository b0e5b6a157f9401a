"""Constraint-count regression harness.

Role parity: reference internal/stats — snippet circuits compiled per
curve/backend and diffed against a locked CSV
(internal/stats/latest_stats.csv, 253 rows `circuit,curve,backend,
nbConstraints,nbWires`). Catching silent constraint-count regressions is the
point: a builder change that doubles the gate count is a compile-time perf
bug the test suite would otherwise miss.

Copied from gnark_icicle_tpu/stats.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_host_engine.py holds it to the original.
The port keeps its own copy of the locked CSV
(gnark_icicle_tpu/latest_stats.csv → ``LOCKED_CSV``).
"""

from __future__ import annotations

import csv
import io as _io
import os

from .frontend import compile_circuit


def snapshot(circuits: dict, modulus: int, curve_name: str) -> list[dict]:
    """circuits: name -> circuit class. Returns stat rows for both builders."""
    rows = []
    for name, cls in sorted(circuits.items()):
        r1 = compile_circuit(modulus, cls)
        rows.append({
            "circuit": name, "curve": curve_name, "backend": "groth16",
            "nbConstraints": r1.nb_constraints, "nbWires": r1.nb_wires,
        })
        s = compile_circuit(modulus, cls, builder="scs")
        rows.append({
            "circuit": name, "curve": curve_name, "backend": "plonk",
            "nbConstraints": s.nb_gates, "nbWires": s.nb_wires,
        })
    return rows


FIELDS = ["circuit", "curve", "backend", "nbConstraints", "nbWires"]
LOCKED_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "latest_stats.csv")


def to_csv(rows: list[dict]) -> str:
    buf = _io.StringIO()
    w = csv.DictWriter(buf, fieldnames=FIELDS)
    w.writeheader()
    for r in rows:
        w.writerow(r)
    return buf.getvalue()


def from_csv(text: str) -> list[dict]:
    rows = []
    for r in csv.DictReader(text.splitlines()):
        r["nbConstraints"] = int(r["nbConstraints"])
        r["nbWires"] = int(r["nbWires"])
        rows.append(r)
    return rows


def diff(locked: list[dict], current: list[dict]) -> list[str]:
    """Human-readable mismatches (empty = no regression)."""
    def key(r):
        return (r["circuit"], r["curve"], r["backend"])

    locked_map = {key(r): r for r in locked}
    problems = []
    for r in current:
        k = key(r)
        if k not in locked_map:
            problems.append(f"new entry (lock it): {k} -> {r['nbConstraints']}")
            continue
        ref = locked_map[k]
        if (ref["nbConstraints"] != r["nbConstraints"]
                or ref["nbWires"] != r["nbWires"]):
            problems.append(
                f"{k}: constraints {ref['nbConstraints']}→{r['nbConstraints']}, "
                f"wires {ref['nbWires']}→{r['nbWires']}"
            )
    return problems
