"""Pedersen vector commitments with a pairing-based proof of knowledge.

Role parity: gnark-crypto's ``pedersen`` package as driven by Groth16 BSB22
commitments (reference: backend/groth16/bn254/setup.go:294-305 pedersen.Setup
per commitment sharing one G2 point; prove.go:121-141 Commit/ProveKnowledge +
folded PoK; verify.go:108-115 pedersen.BatchVerifyMultiVk).

Scheme: proving key holds a G1 basis (here the committed wires' K points,
[(βA+αB+C)/γ]₁) and the σ-scaled basis; commitment C = Σ vᵢ·basisᵢ, proof of
knowledge π = Σ vᵢ·(σ·basisᵢ) = σ·C. Verification is the pairing check
e(C, −σ·G₂)·e(π, G₂) == 1. Batch verification folds n commitments (distinct
σᵢ, shared G₂) with challenge powers into one (n+1)-pairing product.

Copied from gnark_icicle_tpu/backend/pedersen.py:1, so that the port
imports nothing of the JAX package; tests/test_torch_copies.py holds it to
the original. Its MSMs run on the host (``curves/ec.py`` ``msm``), as in the
original: the Groth16 prover makes the commitment and proof of knowledge on
the device instead (``backend/groth16/prove.py`` ``_pedersen_msms``), and
``commit`` and ``prove_knowledge`` are the plain versions the tests hold it
to; ``fold_proofs`` (a few points) stays the prover's.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PedersenProvingKey:
    basis: list            # G1 affine points
    basis_exp_sigma: list  # σ·basis (G1 affine)


@dataclass
class PedersenVerifyingKey:
    g: tuple            # G2 point shared across commitments (setup.go:293)
    g_sigma_neg: tuple  # −σ·g (G2)


def commit(curve, pk: PedersenProvingKey, values: list):
    """C = Σ vᵢ·basisᵢ (≙ pedersen ProvingKey.Commit)."""
    return curve.g1.msm(values, pk.basis)


def prove_knowledge(curve, pk: PedersenProvingKey, values: list):
    """π = Σ vᵢ·(σ·basisᵢ) (≙ pedersen ProvingKey.ProveKnowledge)."""
    return curve.g1.msm(values, pk.basis_exp_sigma)


def fold_proofs(curve, poks: list, challenge: int):
    """Σ challengeⁱ·πᵢ (≙ proof.CommitmentPok.Fold, prove.go:139-141)."""
    q = curve.fr.modulus
    scalars = []
    acc = 1
    for _ in poks:
        scalars.append(acc)
        acc = acc * challenge % q
    return curve.g1.msm(scalars, poks)


def batch_verify_multi_vk(curve, vks: list, commitments: list, pok,
                          challenge: int) -> bool:
    """Π e(challengeⁱ·Cᵢ, −σᵢG₂) · e(π_folded, G₂) == 1
    (≙ pedersen.BatchVerifyMultiVk, verify.go:108-115)."""
    q = curve.fr.modulus
    g1 = curve.g1
    p_list, q_list = [], []
    acc = 1
    for vk, c in zip(vks, commitments):
        if c is not None:
            p_list.append(g1.scalar_mul(c, acc))
            q_list.append(vk.g_sigma_neg)
        acc = acc * challenge % q
    if pok is not None:
        p_list.append(pok)
        q_list.append(vks[0].g)
    if not p_list:
        return True
    if hasattr(curve, "gt_one"):  # curves without the 12-degree tower
        gt_one = curve.gt_one()
    else:
        from ..curves.tower import Fp12

        gt_one = Fp12.one(curve.tower)
    return curve.miller_and_final_exp(p_list, q_list) == gt_one
