"""Groth16 Verify: 3-pairing product check (host).

Copied from gnark_icicle_tpu/backend/groth16/verify.py (:1-121): that module
cannot be imported without JAX, because its package ``__init__`` imports the
JAX prover. The body runs on the host over the port's key and proof classes
and the curve's own pairing (the port's ``curves/pairing.py`` for its
curves). The BSB22 commitment branch (:57-98) raises NotImplementedError:
its pedersen and hash_to_field modules are not ported yet.
"""

from __future__ import annotations

from .keys import VerifyingKey, Proof


class VerificationError(Exception):
    pass


def verify(proof: Proof, vk: VerifyingKey, public_values, curve,
           commitment_hash="sha256") -> None:
    """Raises VerificationError if the proof does not verify.

    public_values: the nb_public−1 public wire values (ONE implicit).
    commitment_hash: "sha256" (gnark-parity RFC 9380 path) or
    ("mimc", outer_modulus) for recursion-friendly proofs produced with
    the same prove() option (≙ backend.WithVerifierHashToFieldFunction).
    """
    q = curve.fr.modulus
    g1, g2 = curve.g1, curve.g2

    if len(public_values) != vk.nb_public - 1:
        raise VerificationError(
            f"expected {vk.nb_public - 1} public inputs, got {len(public_values)}"
        )
    proof_points = [
        ("Ar", proof.ar, g1), ("Krs", proof.krs, g1), ("Bs", proof.bs, g2),
    ]
    proof_points += [
        (f"Commitment[{i}]", cm, g1) for i, cm in enumerate(proof.commitments)
    ]
    if proof.commitment_pok is not None:
        proof_points.append(("CommitmentPok", proof.commitment_pok, g1))
    for name, pt, grp in proof_points:
        if pt is None:
            continue  # infinity is in the subgroup
        if not grp.is_on_curve(pt):
            raise VerificationError(f"proof point {name} not on curve")
        if not grp.in_subgroup(pt):  # ≙ verify.go:67 subgroup checks
            raise VerificationError(f"proof point {name} not in subgroup")

    xs = [1] + [int(v) % q for v in public_values]

    # BSB22 (≙ verify.go:82-115 solveCommitmentWire +
    # pedersen.BatchVerifyMultiVk) is not ported yet.
    if vk.commitment_keys:
        raise NotImplementedError("BSB22 commitments are not ported yet")
    elif proof.commitments:
        raise VerificationError("proof carries unexpected commitments")

    # kSum = Σ x_i · K_i + Σ commitments (small host MSM, ≙ verify.go:117-129)
    k_sum = g1.msm(xs, vk.g1_k)
    for cm in proof.commitments:
        k_sum = g1.add(k_sum, cm)

    # e(Ar,Bs) · e(−kSum,γ) · e(−Krs,δ) == e(α,β)
    lhs = curve.miller_and_final_exp(
        [proof.ar, g1.neg(k_sum), g1.neg(proof.krs)],
        [proof.bs, vk.g2_gamma, vk.g2_delta],
    )
    if lhs != vk.e_alpha_beta(curve):
        raise VerificationError("pairing product mismatch")


def is_valid(proof: Proof, vk: VerifyingKey, public_values, curve) -> bool:
    try:
        verify(proof, vk, public_values, curve)
        return True
    except VerificationError:
        return False
