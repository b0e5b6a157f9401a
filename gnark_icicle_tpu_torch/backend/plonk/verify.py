"""PLONK Verify: transcript replay + linearization-constant check + folded
KZG batch verification (gnark proof shape), on the host.

Copied from gnark_icicle_tpu/backend/plonk/verify.py (:22-191; reference
backend/plonk/bn254/verify.go:48-314). Steps: subgroup-validate every proof
point, replay the Fiat-Shamir transcript, compute PI(ζ), check the claimed
linearized-poly opening, rebuild the linearized-polynomial digest from the
vk/proof commitments, fold the batch opening with the KZG γ challenge and
check both openings — two pairing checks on the host oracle path. The BSB22
branch (:94-110) runs over the port's copy of ``hash_to_field``.
"""

from __future__ import annotations

from ...io.serialize import g1_to_bytes
from ..hash_to_field import hash_to_fr, mimc_commitment_hash
from ..kzg import KZG, SRS
from ..transcript import make_transcript, kzg_fold_challenge
from .keys import VerifyingKey, Proof
from .prove import CHALLENGES, bind_public_data


class PlonkVerificationError(Exception):
    pass


def verify(proof: Proof, vk: VerifyingKey, public_values, curve,
           fs_hash: str = "sha256",
           commitment_hash: str | tuple = "sha256") -> None:
    """commitment_hash must match the prover's mode: "sha256" (RFC 9380,
    DST "BSB22-Plonk") or ("mimc", outer_modulus) for recursion-friendly
    proofs (see plonk.prove)."""
    q = curve.fr.modulus
    if len(public_values) != vk.nb_public:
        raise PlonkVerificationError(
            f"expected {vk.nb_public} public inputs, got {len(public_values)}"
        )
    nb_commitments = len(vk.commitment_constraint_indexes)
    if len(proof.bsb22_commitments) != nb_commitments:
        raise PlonkVerificationError("wrong number of BSB22 commitments")
    if len(proof.batch_claimed) != 6 + nb_commitments:
        raise PlonkVerificationError("wrong number of claimed values")

    # on-curve + subgroup validation of every attacker-supplied point
    # (≙ verify.go:66-89 IsInSubGroup over LRO/Z/H/Bsb22/opening proofs)
    pts = [("a", proof.lro[0]), ("b", proof.lro[1]), ("c", proof.lro[2]),
           ("z", proof.z_com)]
    pts += [(f"h{i}", cm) for i, cm in enumerate(proof.h_coms)]
    pts += [(f"bsb22_{i}", cm)
            for i, cm in enumerate(proof.bsb22_commitments)]
    pts += [("batch_h", proof.batch_h),
            ("z_shifted_h", proof.z_shifted_h)]
    g1 = curve.g1
    for name, pt in pts:
        if pt is None:
            continue  # infinity is in the subgroup
        if not g1.is_on_curve(pt) or not g1.in_subgroup(pt):
            raise PlonkVerificationError(
                f"proof point {name} not in G1 subgroup")

    n = 1 << vk.log_n
    omega = vk.omega
    k1, k2 = vk.k1, vk.k2

    # ---- replay the transcript (≙ verify.go:93-126) -----------------------
    ts = make_transcript(q, list(CHALLENGES), fs_hash)
    bind_public_data(ts, curve, vk, public_values)
    for cm in proof.lro:
        ts.bind_point(b"gamma", curve, cm)
    gamma = ts.challenge(b"gamma")
    beta = ts.challenge(b"beta")
    for cm in proof.bsb22_commitments:
        ts.bind_point(b"alpha", curve, cm)
    ts.bind_point(b"alpha", curve, proof.z_com)
    alpha = ts.challenge(b"alpha")
    for cm in proof.h_coms:
        ts.bind_point(b"zeta", curve, cm)
    zeta = ts.challenge(b"zeta")

    zh_zeta = (pow(zeta, n, q) - 1) % q
    if zh_zeta == 0:
        raise PlonkVerificationError("zeta landed in the domain")

    # PI(ζ) = Σ pub_j · L_j(ζ),  L_j(ζ) = ω^j (ζⁿ−1) / (n (ζ−ω^j))
    def lagrange_at(j: int) -> int:
        wj = pow(omega, j, q)
        return wj * zh_zeta % q * pow(n * (zeta - wj) % q, -1, q) % q

    pi = 0
    for j, pv in enumerate(public_values):
        pi = (pi + pv * lagrange_at(j)) % q
    # BSB22: re-derive each commitment's Qk injection from its commitment
    # point and add it like a public input (≙ verify.go:173-195 with DST
    # "BSB22-Plonk"; our commitment indexes are absolute gate rows)
    if nb_commitments:
        for i, ci in enumerate(vk.commitment_constraint_indexes):
            if (isinstance(commitment_hash, tuple)
                    and commitment_hash[0] == "mimc"):
                val = mimc_commitment_hash(
                    commitment_hash[1], q, curve.fp.modulus,
                    proof.bsb22_commitments[i], [])
            else:
                val = hash_to_fr(
                    g1_to_bytes(curve, proof.bsb22_commitments[i],
                                compressed=False),
                    b"BSB22-Plonk", q,
                )[0]
            pi = (pi + val * lagrange_at(ci)) % q

    l_z = proof.batch_claimed[1]
    r_z = proof.batch_claimed[2]
    o_z = proof.batch_claimed[3]
    s1_z = proof.batch_claimed[4]
    s2_z = proof.batch_claimed[5]
    qcp_z = proof.batch_claimed[6:]
    zu = proof.z_shifted_claimed

    l1_zeta = zh_zeta * pow(n * (zeta - 1) % q, -1, q) % q
    alpha2_l1 = alpha * alpha % q * l1_zeta % q

    # constLin = −[PI − α²L₁(ζ) + α(l+βs1+γ)(r+βs2+γ)(o+γ)·Z(ωζ)]
    # (≙ verify.go:219-227)
    cprod = (l_z + beta * s1_z + gamma) % q * (
        (r_z + beta * s2_z + gamma) % q) % q
    const_lin = cprod * ((o_z + gamma) % q) % q * alpha % q * zu % q
    const_lin = (const_lin - alpha2_l1 + pi) % q
    const_lin = (-const_lin) % q
    if proof.batch_claimed[0] != const_lin:
        raise PlonkVerificationError("algebraic relation does not hold")

    # ---- linearized polynomial digest (≙ verify.go:229-283) ---------------
    s1_coef = cprod * beta % q * zu % q * alpha % q
    idp = (l_z + beta * zeta + gamma) % q
    idp = idp * ((r_z + beta * k1 % q * zeta + gamma) % q) % q
    idp = idp * ((o_z + beta * k2 % q * zeta + gamma) % q) % q
    z_coef = (alpha2_l1 - alpha * idp) % q
    rl = l_z * r_z % q
    zeta_n2 = pow(zeta, n + 2, q)
    neg_zh = (-zh_zeta) % q

    points = list(proof.bsb22_commitments) + [
        vk.commitments["ql"], vk.commitments["qr"], vk.commitments["qm"],
        vk.commitments["qo"], vk.commitments["qk"],
        vk.commitments["s3"], proof.z_com,
        proof.h_coms[0], proof.h_coms[1], proof.h_coms[2],
    ]
    scalars = list(qcp_z) + [
        l_z, r_z, rl, o_z, 1,
        s1_coef, z_coef,
        neg_zh, neg_zh * zeta_n2 % q, neg_zh * zeta_n2 % q * zeta_n2 % q,
    ]
    lin_digest = None
    for pt, s in zip(points, scalars):
        lin_digest = g1.add(lin_digest, g1.scalar_mul(pt, s))

    # ---- fold + batch verify (≙ verify.go:285-313) ------------------------
    digests = [lin_digest, proof.lro[0], proof.lro[1], proof.lro[2],
               vk.commitments["s1"], vk.commitments["s2"]]
    for i in range(nb_commitments):
        digests.append(vk.commitments[f"qcp{i}"])
    gamma_kzg = kzg_fold_challenge(fs_hash, curve, q, zeta, digests,
                                   proof.batch_claimed, zu)
    folded_digest = None
    folded_value = 0
    gi = 1
    for d, v in zip(digests, proof.batch_claimed):
        folded_digest = g1.add(folded_digest, g1.scalar_mul(d, gi))
        folded_value = (folded_value + gi * v) % q
        gi = gi * gamma_kzg % q

    srs = SRS(g1_powers=[curve.g1.generator], g2_gen=vk.g2_gen,
              g2_tau=vk.g2_tau)
    kzg = KZG(curve, srs)
    if not kzg.verify(folded_digest, zeta, folded_value, proof.batch_h):
        raise PlonkVerificationError("batched KZG opening at zeta fails")
    if not kzg.verify(proof.z_com, zeta * omega % q, zu,
                      proof.z_shifted_h):
        raise PlonkVerificationError("KZG opening of Z at omega*zeta fails")


def is_valid(proof: Proof, vk: VerifyingKey, public_values, curve,
             fs_hash: str = "sha256",
             commitment_hash: str | tuple = "sha256") -> bool:
    try:
        verify(proof, vk, public_values, curve, fs_hash=fs_hash,
               commitment_hash=commitment_hash)
        return True
    except PlonkVerificationError:
        return False
