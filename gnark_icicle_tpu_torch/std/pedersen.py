"""In-circuit Pedersen vector-commitment verifier.

Role parity: reference std/commitments/pedersen/verifier.go —
``Verifier.AssertCommitment`` (the pairing check
e(C, −σG₂)·e(π, G₂) == 1 against the commitment verifying key) and
``Verifier.FoldCommitments`` (identity for one commitment; the reference
panics on more — verifier.go:47-56 "folding not implemented yet", and its
recursion verifier errors on multiple commitment keys, verifier.go:660-668
— mirrored here as a loud NotImplementedError).

Generic over the pairing layer: works with the NATIVE 2-chain pairing
gadget (std/pairing_bls12_377.BLS12377Pairing — G2 constants as E2 pairs)
and the emulated family (std/pairing_bn254.BN254Pairing etc.), because all
expose ``assert_pairing_equal(pairs, host_gt_target)``.

Used by std/recursion/{groth16,native_groth16}.py to recurse over
BSB22-commitment-carrying Groth16 proofs.

Copied from gnark_icicle_tpu/std/pedersen.py:1, so that the port imports
nothing of the JAX package; tests/test_torch_copies.py holds the 2-chain
that uses it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CommitmentVk:
    """Gadget-side Pedersen verifying key — circuit constants built from a
    host backend.pedersen.PedersenVerifyingKey (≙ pedersen.VerifyingKey:
    G, GSigmaNeg)."""

    g: object            # G2 gadget constant
    g_sigma_neg: object  # −σ·G₂ gadget constant


def fold_commitments(commitments: list):
    """≙ Verifier.FoldCommitments: one commitment needs no folding; the
    reference's multi-commitment fold is unimplemented upstream too."""
    if len(commitments) == 0:
        raise ValueError("number of commitments must be at least 1")
    if len(commitments) == 1:
        return commitments[0]
    raise NotImplementedError(
        "folding multiple commitments is not implemented (parity: the "
        "reference panics here, std/commitments/pedersen/verifier.go:55)"
    )


def assert_commitment(pairing, gt_one, commitment, knowledge_proof,
                      vk: CommitmentVk) -> None:
    """≙ Verifier.AssertCommitment: constrain
    e(C, −σG₂) · e(π, G₂) == 1.

    commitment / knowledge_proof: gadget G1 points as (x, y) pairs;
    gt_one: the HOST target-group identity (curves.tower.Fp12.one) the
    pairing gadget compares against. Subgroup membership of C and π is the
    caller's choice (the recursion verifier checks both)."""
    pairing.assert_pairing_equal(
        [
            (commitment, vk.g_sigma_neg),
            (knowledge_proof, vk.g),
        ],
        gt_one,
    )
