"""Groth16 Verify: 3-pairing product check (host).

Copied from gnark_icicle_tpu/backend/groth16/verify.py (:1-121): that module
cannot be imported without JAX, because its package ``__init__`` imports the
JAX prover. The body runs on the host over the port's key and proof classes
and the curve's own pairing (the port's ``curves/pairing.py`` for its
curves), its BSB22 commitment branch (:57-98) over the port's copies of
``pedersen`` and ``hash_to_field``.
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

    # BSB22: re-derive each commitment wire value from the proof's
    # commitment point + the committed public values, then check the folded
    # Pedersen proof of knowledge (≙ verify.go:82-115 solveCommitmentWire +
    # pedersen.BatchVerifyMultiVk).
    if vk.commitment_keys:
        from .. import pedersen
        from ..hash_to_field import (
            COMMITMENT_DST, G16_FOLD_DST, hash_to_fr, mimc_commitment_hash,
            serialize_commitment,
        )
        from ...io.serialize import g1_to_bytes

        if len(proof.commitments) != len(vk.commitment_keys):
            raise VerificationError("wrong number of commitments in proof")
        fr_bytes = (q.bit_length() + 7) // 8
        for i, committed_idx in enumerate(vk.public_and_commitment_committed):
            if (isinstance(commitment_hash, tuple)
                    and commitment_hash[0] == "mimc"):
                xs.append(mimc_commitment_hash(
                    commitment_hash[1], q, curve.fp.modulus,
                    proof.commitments[i], [xs[j] for j in committed_idx]))
                continue
            if (isinstance(commitment_hash, tuple)
                    and commitment_hash[0] == "evm"):
                from ..hash_to_field import evm_commitment_hash

                xs.append(evm_commitment_hash(
                    commitment_hash[1], q, proof.commitments[i],
                    [xs[j] for j in committed_idx]))
                continue
            msg = serialize_commitment(
                g1_to_bytes(curve, proof.commitments[i], compressed=False),
                [xs[j] for j in committed_idx],
                fr_bytes,
            )
            xs.append(hash_to_fr(msg, COMMITMENT_DST, q)[0])
        challenge_msg = b"".join(
            int(v).to_bytes(fr_bytes, "big")
            for v in xs[vk.nb_public:]
        )
        challenge = hash_to_fr(challenge_msg, G16_FOLD_DST, q)[0]
        if not pedersen.batch_verify_multi_vk(
            curve, vk.commitment_keys, proof.commitments,
            proof.commitment_pok, challenge,
        ):
            raise VerificationError("commitment proof of knowledge invalid")
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
