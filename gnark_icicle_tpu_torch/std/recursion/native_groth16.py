"""In-circuit Groth16 verifier over NATIVE BLS12-377 — 2-chain recursion.

Role parity: reference std/recursion/groth16/verifier.go instantiated with
sw_bls12377 (the native path: a BW6-761 outer circuit verifies a BLS12-377
inner proof with every base-field operation native, ≙
std/algebra/native/doc.go). This is the CHEAP recursion path — one native
constraint per field mul, vs hundreds on the emulated (BN254-in-BN254)
path in std/recursion/groth16.py.

Inner public inputs are outer-circuit variables. They are bit-decomposed
to ⌈log₂ r⌉ bits for the kSum scalar mul, which constrains them to
[0, 2^253); values in [r, 2^253) alias their mod-r reduction (the pairing
equation only sees the scalar mod r) — outer circuits that need canonical
inner publics should range-check them against r (std/rangecheck), matching
the reference's emulated-scalar semantics.

Subgroup membership of the proof points is enforced UNCONDITIONALLY via
the φ/ψ-eigenvalue fast checks (G1: P == −[x₀²]φ(P); G2: ψ(Q) == [x₀]Q;
≙ sw_bls12377/pairing2.go AssertIsOnG1/AssertIsOnG2) — ~2×/4× cheaper
than the full-order [r]P == O ladders they replaced; both accept/reject
behaviors are host-validated against non-subgroup curve points
(tests/test_native_recursion.py).

Copied from gnark_icicle_tpu/std/recursion/native_groth16.py:1, so that the
port imports nothing of the JAX package; tests/test_torch_copies.py holds
it to the original, a committed inner proof's outer circuit included. The
BSB22 branch uses the port's copies of the Pedersen gadget (std/pedersen.py)
and the MiMC gadget (std/hash/mimc.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...curves import bls12_377 as b377
from ..pairing_bls12_377 import BLS12377Pairing
from ..pedersen import CommitmentVk, assert_commitment, fold_commitments


@dataclass
class NativeVerifierProof:
    """Gadget-side Groth16 proof (≙ recursion/groth16.Proof incl. its
    pedersen.Commitment / KnowledgeProof fields).

    ar/krs: (x, y) native-variable pairs; bs: (x, y) pair of E2 pairs;
    commitments: list of (x, y) G1 pairs (BSB22 proofs);
    commitment_pok: (x, y) folded Pedersen knowledge proof."""

    ar: tuple
    krs: tuple
    bs: tuple
    commitments: tuple = ()
    commitment_pok: tuple | None = None


class NativeGroth16Verifier:
    """≙ recursion/groth16.Verifier[sw_bls12377] with circuit-constant vk.

    BSB22-commitment proofs ARE supported (one commitment, matching the
    reference — verifier.go:660-668 errors on multiple): the inner proof
    must be produced with ``groth16.prove(..., commitment_hash=("mimc",
    outer_modulus))`` so the commitment wire's hash-to-field is the
    outer-native MiMC this verifier replays (≙ recursion.NewShort via
    WithProverHashToFieldFunction)."""

    def __init__(self, api, vk, curve=None):
        """vk: host backend.groth16 VerifyingKey over BLS12-377."""
        if len(vk.commitment_keys) > 1:
            raise NotImplementedError(
                "multiple commitments are not supported (parity: "
                "std/recursion/groth16/verifier.go:666)"
            )
        self.api = api
        self.vk = vk
        self.pairing = BLS12377Pairing(api)
        host_curve = curve if curve is not None else b377.BLS12_377
        self._host_curve = host_curve
        self._e_alpha_beta = vk.e_alpha_beta(host_curve)
        e2 = self.pairing.e2
        self._cm_vks = [
            CommitmentVk(
                g=(e2.constant(k.g[0].c0, k.g[0].c1),
                   e2.constant(k.g[1].c0, k.g[1].c1)),
                g_sigma_neg=(
                    e2.constant(k.g_sigma_neg[0].c0, k.g_sigma_neg[0].c1),
                    e2.constant(k.g_sigma_neg[1].c0, k.g_sigma_neg[1].c1)),
            )
            for k in vk.commitment_keys
        ]
        self._gamma = (e2.constant(vk.g2_gamma[0].c0, vk.g2_gamma[0].c1),
                       e2.constant(vk.g2_gamma[1].c0, vk.g2_gamma[1].c1))
        self._delta = (e2.constant(vk.g2_delta[0].c0, vk.g2_delta[0].c1),
                       e2.constant(vk.g2_delta[1].c0, vk.g2_delta[1].c1))

    # -- witness constructors ------------------------------------------------
    def proof_witness(self, proof) -> NativeVerifierProof:
        """Bind a host Proof's points as gadget values (engine path; a
        compiled outer circuit passes Secret variables instead)."""
        fp = self.pairing.fp
        e2 = self.pairing.e2

        def g1(pt):
            return (fp.constant(pt[0]), fp.constant(pt[1]))

        def g2(pt):
            return (e2.constant(pt[0].c0, pt[0].c1),
                    e2.constant(pt[1].c0, pt[1].c1))

        return NativeVerifierProof(
            ar=g1(proof.ar), krs=g1(proof.krs), bs=g2(proof.bs),
            commitments=tuple(g1(cm) for cm in proof.commitments),
            commitment_pok=(g1(proof.commitment_pok)
                            if proof.commitment_pok is not None else None),
        )

    # -- membership checks ---------------------------------------------------
    def _assert_g1_member(self, xy):
        """On-curve + subgroup via the φ-eigenvalue fast check."""
        self.pairing.assert_g1_member(xy)

    def _assert_g2_member(self, q_pt):
        """On-twist + subgroup via the ψ-Frobenius fast check."""
        self.pairing.assert_g2_member(q_pt)

    # -- the verification relation ------------------------------------------
    # -- BSB22 commitment wire re-derivation ---------------------------------
    def _assert_bits_canonical(self, bits, modulus: int):
        """Kill the +q decomposition alias of a full-width api.to_binary:
        constrain Σ bitsᵢ·2^i ≤ q−1 over the little-endian bits (the
        constant-bound comparator — scanning from the MSB, an 'equal so
        far' flag collapses on the first 0-bit of the value; a 1-bit where
        the bound has 0 under an intact flag is a violation)."""
        api = self.api
        c = modulus - 1
        eq = 1
        for i in range(len(bits) - 1, -1, -1):
            if (c >> i) & 1:
                eq = api.mul(eq, bits[i])
            else:
                api.assert_is_equal(api.mul(eq, bits[i]), 0)

    def _commitment_aux_values(self, commitments, xs_vars):
        """Re-derive each commitment wire value in-circuit
        (≙ verifier.go:643-656 solveCommitmentWire: hash the commitment
        point and the committed public wires with the recursion hash, here
        the outer-native MiMC of backend.hash_to_field.
        mimc_commitment_hash — absorbed values and truncation mirrored
        exactly). Returns (value_var, low_bits) per commitment; xs_vars
        is extended in place so nested commitments can absorb earlier
        commitment wires."""
        from ...backend.hash_to_field import MIMC_COMMITMENT_TAG
        from ..hash.mimc import MiMC

        api = self.api
        outer_q = api.q
        out = []
        out_bits = min(b377.R.bit_length(), outer_q.bit_length()) - 1
        for i, committed_idx in enumerate(
                self.vk.public_and_commitment_committed):
            m = MiMC(api, outer_q)
            m.write(int.from_bytes(MIMC_COMMITMENT_TAG, "big") % outer_q)
            m.write(commitments[i][0])
            m.write(commitments[i][1])
            for j in committed_idx:
                m.write(xs_vars[j])
            d = m.sum()
            bits = api.to_binary(d, outer_q.bit_length())
            self._assert_bits_canonical(bits, outer_q)
            lo = bits[:out_bits]
            val = api.from_binary(lo)
            xs_vars.append(val)
            out.append((val, lo))
        return out

    def assert_proof(self, proof: NativeVerifierProof, public_inputs,
                     check_membership: bool = True) -> None:
        """Constrain the proof valid for the given public inputs
        (≙ Verifier.AssertProof): membership checks, commitment-wire
        re-derivation + Pedersen PoK check for BSB22 proofs,
        kSum = K₀ + Σ pubᵢ·Kᵢ (+ Σ auxᵢ·Kᵢ + Σ Cᵢ),
        then e(Ar, Bs)·e(−kSum, γ)·e(−Krs, δ) == e(α, β)."""
        vk = self.vk
        if len(public_inputs) != vk.nb_public - 1:
            raise ValueError(
                f"expected {vk.nb_public - 1} public inputs, "
                f"got {len(public_inputs)}"
            )
        cms = list(proof.commitments or ())
        if len(cms) != len(vk.commitment_keys):
            raise ValueError(
                f"expected {len(vk.commitment_keys)} commitments, "
                f"got {len(cms)}"
            )
        api = self.api
        fp = self.pairing.fp
        g1 = self.pairing.g1

        if check_membership:
            self._assert_g1_member(proof.ar)
            self._assert_g1_member(proof.krs)
            self._assert_g2_member(proof.bs)
            for cm in cms:
                self._assert_g1_member(cm)
            if proof.commitment_pok is not None:
                self._assert_g1_member(proof.commitment_pok)

        aux = []
        if cms:
            xs_vars = [1] + list(public_inputs)
            aux = self._commitment_aux_values(cms, xs_vars)
            # single-commitment fold (≙ FoldCommitments) + PoK pairing
            # check e(C, −σG₂)·e(π, G₂) == 1 (≙ AssertCommitment)
            folded = fold_commitments(cms)
            from ...curves.tower import Fp12

            assert_commitment(
                self.pairing, Fp12.one(self._host_curve.tower),
                folded, proof.commitment_pok, self._cm_vks[0],
            )

        n_bits = b377.R.bit_length()
        k_sum = g1.from_affine(
            (fp.constant(vk.g1_k[0][0]), fp.constant(vk.g1_k[0][1]))
        )
        for pub, k_pt in zip(public_inputs, vk.g1_k[1:]):
            base = g1.from_affine(
                (fp.constant(k_pt[0]), fp.constant(k_pt[1]))
            )
            term = g1.scalar_mul_bits(base, api.to_binary(pub, n_bits))
            k_sum = g1.add(k_sum, term)
        for i, (_, lo_bits) in enumerate(aux):
            k_pt = vk.g1_k[vk.nb_public + i]
            base = g1.from_affine(
                (fp.constant(k_pt[0]), fp.constant(k_pt[1]))
            )
            k_sum = g1.add(k_sum, g1.scalar_mul_bits(base, lo_bits))
        for cm in cms:  # ≙ verifier.go:676-678 kSum += proof.Commitments
            k_sum = g1.add(k_sum, g1.from_affine(cm))

        # normalize once for the Miller loop (kSum is never the identity
        # for a well-formed vk and in-range publics; identity makes the
        # division unsatisfiable = rejection)
        k_aff = g1.to_affine(fp.div, k_sum)

        self.pairing.assert_pairing_equal(
            [
                (proof.ar, proof.bs),
                ((k_aff[0], fp.neg(k_aff[1])), self._gamma),
                ((proof.krs[0], fp.neg(proof.krs[1])), self._delta),
            ],
            self._e_alpha_beta,
        )
