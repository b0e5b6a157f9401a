"""Sumcheck protocol: in-circuit verifier + host prover.

Role parity: reference std/sumcheck (sumcheck.go — LazyClaims interface,
Verify driving one partial-sum polynomial per variable through a named-
challenge Fiat-Shamir transcript, g_j(0) recovered from the previous round's
running sum so the proof ships only g_j(1..deg)). The prover here runs over
the SAME code path with the test engine as its api (a host big-int
computation), so transcripts match the in-circuit verifier by construction.

Claims interfaces mirror the reference:
  verifier: claims_num / vars_num / degree(j) / combined_sum(api, coeff) /
            verify_final_eval(api, r, coeff, purported, final_proof)
  prover:   additionally combine(coeff) -> first partial-sum poly evals,
            next(r_j) -> next poly evals, prove_final_eval(r)

Copied from gnark_icicle_tpu/std/sumcheck.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .fiat_shamir import CircuitTranscript
from .polynomial import Polynomial


@dataclass
class SumcheckProof:
    # per variable: [g_j(1), ..., g_j(deg_j)] (g_j(0) is implied)
    partial_sum_polys: list = field(default_factory=list)
    final_eval_proof: object = None


def challenge_names(prefix: str, claims_num: int, vars_num: int) -> list:
    names = []
    if claims_num >= 2:
        names.append(prefix + "comb")
    for i in range(vars_num):
        names.append(prefix + f"pSP.{i}")
    return names


def _next(transcript: CircuitTranscript, name: str, bindings):
    transcript.bind(name, bindings)
    return transcript.compute_challenge(name)


def verify(api, claims, proof: SumcheckProof,
           transcript: CircuitTranscript, prefix: str = "") -> None:
    """≙ sumcheck.Verify (sumcheck.go:60-106)."""
    names = challenge_names(prefix, claims.claims_num(), claims.vars_num())
    ni = 0
    comb = None
    if claims.claims_num() >= 2:
        comb = _next(transcript, names[ni], [])
        ni += 1
    poly = Polynomial(api)
    gjr = claims.combined_sum(api, comb)
    r = []
    for j in range(claims.vars_num()):
        psp = proof.partial_sum_polys[j]
        if len(psp) != claims.degree(j):
            raise ValueError("malformed sumcheck proof")
        # g_j(0) = gjr − g_j(1)  (the round consistency condition)
        gj = [api.sub(gjr, psp[0])] + list(psp)
        rj = _next(transcript, names[ni], psp)
        ni += 1
        r.append(rj)
        gjr = poly.interpolate_lde(rj, gj)
    claims.verify_final_eval(api, r, comb, gjr, proof.final_eval_proof)


def prove(api, claims, transcript: CircuitTranscript,
          prefix: str = "") -> SumcheckProof:
    """Host-side prover (≙ gnark-crypto sumcheck.Prove); run with the test
    engine as `api` so the transcript bytes match the verifier's."""
    names = challenge_names(prefix, claims.claims_num(), claims.vars_num())
    ni = 0
    comb = None
    if claims.claims_num() >= 2:
        comb = _next(transcript, names[ni], [])
        ni += 1
    proof = SumcheckProof()
    psp = claims.combine(comb)
    for j in range(claims.vars_num()):
        proof.partial_sum_polys.append(psp)
        rj = _next(transcript, names[ni], psp)
        ni += 1
        psp = claims.next(rj)  # folds r_j in; returns None after the last
    proof.final_eval_proof = claims.prove_final_eval()
    return proof
