"""Circuit test harness: the CheckCircuit pyramid.

Role parity: reference test/assert_checkcircuit.go:17-173 — for each
requested backend it (a) runs the big-int engine on valid AND invalid
assignments, (b) compiles, (c) checks solver success/failure, (d) optionally
runs full Setup/Prove/Verify (the `prover_checks` tier), (e) optionally
round-trips serialization (`release_checks` tier). Plus the fuzz tier
(assert_fuzz.go): random/edge witnesses cross-checked engine vs solver.

Copied from gnark_icicle_tpu/testing.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_host_engine.py holds it to the original.
One difference: the prover tier's ``engine`` defaults to "device" (the first
CUDA card, raising without one, as every entry point of the port does), where
the original defaults to "host"; CPU callers pass ``engine="host"``.
"""

from __future__ import annotations

import random

from .frontend import compile_circuit, is_solved
from .frontend.engine import check_solved, EngineUnsatisfiedError
from .constraint import solve, UnsatisfiedConstraintError
from .constraint.scs import solve_scs, SparseUnsatisfiedError


class CheckFailure(AssertionError):
    pass


def check_circuit(circuit_cls, valid=(), invalid=(), curve=None,
                  backends=("groth16", "plonk"), prover_checks=False,
                  serialization_checks=False, rng=None,
                  engine: str = "device"):
    """Run the assertion pyramid over assignments (dicts of input values).

    curve: a curves.* curve object (bn254.BN254 by default).
    engine: prover engine for the prover_checks tier — "device" (default:
    the first CUDA card) or "host" (pure big-int, no device).
    """
    if curve is None:
        from .curves import bn254

        curve = bn254.BN254
    q = curve.fr.modulus
    rng = rng or random.Random(0)

    # tier 1: engine
    for w in valid:
        try:
            check_solved(circuit_cls(**w), q)
        except EngineUnsatisfiedError as e:
            raise CheckFailure(f"engine rejects valid witness {w}: {e}") from e
    for w in invalid:
        if is_solved(circuit_cls(**w), q):
            raise CheckFailure(f"engine accepts invalid witness {w}")

    for backend in backends:
        builder = "r1cs" if backend == "groth16" else "scs"
        cs = compile_circuit(q, circuit_cls, builder=builder)

        # tier 2: solver agreement
        for w in valid:
            pub, sec = circuit_cls(**w).witness_values(q)
            if builder == "r1cs":
                solve(cs, pub, sec)
            else:
                solve_scs(cs, pub, sec)
        for w in invalid:
            pub, sec = circuit_cls(**w).witness_values(q)
            try:
                if builder == "r1cs":
                    solve(cs, pub, sec)
                else:
                    solve_scs(cs, pub, sec)
            except (UnsatisfiedConstraintError, SparseUnsatisfiedError,
                    ValueError, ZeroDivisionError):
                continue
            raise CheckFailure(
                f"{backend} solver accepts invalid witness {w}"
            )

        # tier 3: full prove/verify over EVERY valid assignment, plus a
        # tampered-public rejection per proof (≙ assert_checkcircuit.go:
        # 103-173 — the reference proves each valid witness and asserts
        # the invalid ones do not verify)
        if prover_checks and valid:
            if backend == "groth16":
                from .backend import groth16 as b
            else:
                from .backend import plonk as b
            pk, vk = b.setup(cs, curve, rng=rng, engine=engine)
            for w in valid:
                pub, sec = circuit_cls(**w).witness_values(q)
                proof = b.prove(cs, pk, pub, sec, curve, rng=rng,
                                engine=engine)
                b.verify(proof, vk, pub, curve)
                if pub:  # tampered public input must not verify
                    bad = list(pub)
                    bad[0] = (int(bad[0]) + 1) % q
                    if b.is_valid(proof, vk, bad, curve):
                        raise CheckFailure(
                            f"{backend} verifier accepts tampered "
                            f"public input for witness {w}"
                        )
                if serialization_checks:
                    if backend == "groth16":
                        from .io import proof_to_bytes, proof_from_bytes, \
                            vk_to_bytes, vk_from_bytes

                        p2, _ = proof_from_bytes(
                            curve, proof_to_bytes(curve, proof))
                        vk2, _ = vk_from_bytes(
                            curve, vk_to_bytes(curve, vk))
                    else:
                        from .io.plonk_serialize import (
                            plonk_proof_from_bytes, plonk_proof_to_bytes,
                            plonk_vk_from_bytes, plonk_vk_to_bytes,
                        )

                        p2, _ = plonk_proof_from_bytes(
                            curve, plonk_proof_to_bytes(curve, proof))
                        vk2, _ = plonk_vk_from_bytes(
                            curve, plonk_vk_to_bytes(curve, vk))
                    b.verify(p2, vk2, pub, curve)


def fuzz_circuit(circuit_cls, input_names, curve=None, iterations=16,
                 rng=None):
    """Random/edge-value witnesses: engine and solver must agree
    (≙ test/assert_fuzz.go feeding zero/one/minus-one/random)."""
    if curve is None:
        from .curves import bn254

        curve = bn254.BN254
    q = curve.fr.modulus
    rng = rng or random.Random(0)
    cs = compile_circuit(q, circuit_cls)
    specials = [0, 1, 2, q - 1]
    disagreements = []
    for _ in range(iterations):
        w = {k: rng.choice(specials + [rng.randrange(q)])
             for k in input_names}
        circ = circuit_cls(**w)
        pub, sec = circ.witness_values(q)
        eng = is_solved(circ, q)
        try:
            solve(cs, pub, sec)
            slv = True
        except (UnsatisfiedConstraintError, ValueError, ZeroDivisionError):
            slv = False
        if eng != slv:
            disagreements.append((w, eng, slv))
    if disagreements:
        raise CheckFailure(f"engine/solver disagreements: {disagreements}")
