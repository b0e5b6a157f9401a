"""In-circuit Groth16 verifier over emulated curves (BN254, BLS12-381,
BW6-761).

Role parity: reference std/recursion/groth16 (verifier.go — Verifier.
AssertProof: in-circuit subgroup checks, kSum linear combination of the
vk's K points by the public inputs, and the 3-pairing product against the
precomputed e(α, β)), instantiated for the emulated curve family
(sw_bn254, sw_bls12381, sw_bw6761 — the last wraps a 2-chain outer
proof into a third curve). The verifying key is circuit-constant (the
reference's "fixed" vk placement).

Public inputs: for same-curve recursion (BN254-in-BN254) the inner and
outer scalar fields coincide, so publics are NATIVE outer variables and
are bound with fr.from_native. For cross-curve recursion (a BLS12-381
proof inside a BN254 circuit) the inner Fr is emulated — pass emulated
``Element`` scalars (or host ints, bound as constants on the engine path).

Engine-level today, like the pairing gadgets this builds on; compiling to
a constraint system rides the deferred-mulcheck emulated path (ROADMAP).
The NATIVE (cheap) 2-chain verifier lives in native_groth16.py.

Copied from gnark_icicle_tpu/std/recursion/groth16.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_recursion.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...curves import bn254
from ..emulated import Element
from ..sw_emulated import (
    AffinePoint, BLS12381G1, BN254G1, BW6761G1, BW6761G2, EmulatedCurve,
)
from ..pairing_bn254 import BN254Pairing


@dataclass
class VerifierProof:
    """Gadget-side Groth16 proof (≙ recursion/groth16.Proof incl. its
    pedersen.Commitment / KnowledgeProof fields)."""

    ar: AffinePoint        # G1
    krs: AffinePoint       # G1
    bs: object             # G2: (x, y) E2 pair, or an AffinePoint when
                           # the inner curve's G2 lives over Fp (BW6-761)
    commitments: tuple = ()             # BSB22 G1 commitments
    commitment_pok: AffinePoint | None = None


class Groth16Verifier:
    """≙ recursion/groth16.Verifier with a circuit-constant vk.

    curve_id selects the emulated instantiation: "bn254" (default,
    same-curve recursion), "bls12-381" (cross-curve), or "bw6-761"
    (wrapping a 2-chain outer proof into a third curve — the final stage
    of BLS12-377 → BW6-761 → wrap)."""

    def __init__(self, api, native_modulus: int, vk, curve=None,
                 curve_id: str = "bn254"):
        """vk: host backend.groth16 VerifyingKey over the inner curve;
        curve: host curve object used once to precompute e(α, β).

        BSB22-commitment proofs are supported for ONE commitment
        (≙ verifier.go:660-668); the inner proof must use
        ``commitment_hash=("mimc", native_modulus)`` so this verifier can
        replay the commitment-wire hash natively."""
        if len(vk.commitment_keys) > 1:
            raise NotImplementedError(
                "multiple commitments are not supported (parity: "
                "std/recursion/groth16/verifier.go:666)"
            )
        self.api = api
        self._native_modulus = native_modulus
        self.vk = vk
        self.curve_id = curve_id
        self._g2_fp2 = True  # G2 over Fp2 (12-degree curves)
        if curve_id == "bn254":
            self.curve = EmulatedCurve(api, BN254G1, native_modulus)
            self.pairing = BN254Pairing(api, native_modulus)
            host = curve if curve is not None else bn254.BN254
            self._r = bn254.R
            self._g2_b = bn254.G2_B
            self._g1_cofactor_one = True
        elif curve_id == "bls12-381":
            from ...curves import bls12_381 as b381
            from ..pairing_bls12_381 import BLS12381Pairing

            self.curve = EmulatedCurve(api, BLS12381G1, native_modulus)
            self.pairing = BLS12381Pairing(api, native_modulus)
            host = curve if curve is not None else b381.BLS12_381
            self._r = b381.R
            self._g2_b = b381.G2_B
            # BLS12-381 G1 has cofactor ≈ 2^32: on-curve is NOT membership
            self._g1_cofactor_one = False
        elif curve_id == "bw6-761":
            from ...curves import bw6_761 as bw6
            from ..pairing_bw6_761 import BW6761Pairing

            self.curve = EmulatedCurve(api, BW6761G1, native_modulus)
            self._g2_curve = EmulatedCurve(api, BW6761G2, native_modulus)
            self.pairing = BW6761Pairing(api, native_modulus)
            host = curve if curve is not None else bw6.BW6_761
            self._r = bw6.R
            self._g2_fp2 = False  # sextic twist over Fp (k = 6)
            # BW6-761 G1 cofactor is ~384 bits: ladder required
            self._g1_cofactor_one = False
        else:
            raise ValueError(f"unsupported recursion curve {curve_id!r}")
        self._host = host
        self._e_alpha_beta = vk.e_alpha_beta(host)
        if self._g2_fp2:
            e2 = self.pairing.e2
            self._gamma = (e2.constant(vk.g2_gamma[0].c0, vk.g2_gamma[0].c1),
                           e2.constant(vk.g2_gamma[1].c0, vk.g2_gamma[1].c1))
            self._delta = (e2.constant(vk.g2_delta[0].c0, vk.g2_delta[0].c1),
                           e2.constant(vk.g2_delta[1].c0, vk.g2_delta[1].c1))
            self._twist_b = e2.constant(self._g2_b.c0, self._g2_b.c1)

            def g2c(pt):
                return (e2.constant(pt[0].c0, pt[0].c1),
                        e2.constant(pt[1].c0, pt[1].c1))
        else:
            self._gamma = self._g2_curve.constant_point(vk.g2_gamma)
            self._delta = self._g2_curve.constant_point(vk.g2_delta)

            def g2c(pt):
                ap = self._g2_curve.constant_point(pt)
                return (ap.x, ap.y)  # pairing-call shape

        from ..pedersen import CommitmentVk

        self._cm_vks = [
            CommitmentVk(g=g2c(k.g), g_sigma_neg=g2c(k.g_sigma_neg))
            for k in vk.commitment_keys
        ]

    # -- witness constructors ------------------------------------------------
    def proof_witness(self, proof) -> VerifierProof:
        """Bind a host Proof's point values as gadget witnesses (engine
        path; a compiled outer circuit allocates the limbs as Secret)."""
        fp = self.curve.fp
        e2 = self.pairing.e2 if self._g2_fp2 else None

        def g1(pt):
            return AffinePoint(fp.constant(pt[0]), fp.constant(pt[1]))

        def g2(pt):
            if not self._g2_fp2:
                return AffinePoint(self._g2_curve.fp.constant(pt[0]),
                                   self._g2_curve.fp.constant(pt[1]))
            return (e2.constant(pt[0].c0, pt[0].c1),
                    e2.constant(pt[1].c0, pt[1].c1))

        return VerifierProof(
            ar=g1(proof.ar), krs=g1(proof.krs), bs=g2(proof.bs),
            commitments=tuple(g1(cm) for cm in proof.commitments),
            commitment_pok=(g1(proof.commitment_pok)
                            if proof.commitment_pok is not None else None),
        )

    # -- checks --------------------------------------------------------------
    def _assert_g1_member(self, p: AffinePoint):
        """On-curve, plus the full-order ladder [r−1]·P == −P when the
        cofactor exceeds 1 (≙ AssertIsOnG1). Incomplete formulas with a
        fixed scalar: partial sums [m]P, m < r−1, never hit O or a
        ±-collision with P for an order-r point; a non-member can at worst
        make the ladder unsatisfiable — the desired outcome."""
        c = self.curve
        c.assert_on_curve(p)
        if self._g1_cofactor_one:
            return
        acc = p
        for bit in bin(self._r - 1)[3:]:
            acc = c.double(acc)
            if bit == "1":
                acc = c.add(acc, p)
        c.assert_is_equal(acc, c.neg(p))

    def _assert_g2_member_fp(self, q_pt: AffinePoint):
        """BW6-761: G2 lives on the Fp twist — on-curve + the same
        [r−1]·Q == −Q ladder through the emulated G2 curve ops."""
        g2c = self._g2_curve
        g2c.assert_on_curve(q_pt)
        acc = q_pt
        for bit in bin(self._r - 1)[3:]:
            acc = g2c.double(acc)
            if bit == "1":
                acc = g2c.add(acc, q_pt)
        g2c.assert_is_equal(acc, g2c.neg(q_pt))

    def _assert_g2_member(self, q_pt):
        """On-curve (y² = x³ + b₂) and subgroup membership of a G2 witness
        (≙ verifier.go's AssertIsOnG2). Subgroup via the full-order ladder
        [r−1]·Q == −Q: E'(F_{p²}) has order r·h₂ with r ∤ h₂, so the
        r-torsion IS G2. The incomplete twist formulas never degenerate for
        an order-r point under the fixed scalar r−1 (partial sums [m]Q,
        m < r−1, never hit O or a ±-collision with Q); a non-member can at
        worst make the ladder unsatisfiable, which is the desired outcome."""
        e2 = self.pairing.e2
        x, y = q_pt
        lhs = e2.square(y)
        rhs = e2.add(e2.mul(e2.square(x), x), self._twist_b)
        e2.assert_equal(lhs, rhs)

        acc = q_pt
        for bit in bin(self._r - 1)[3:]:
            acc, _ = self.pairing._twist_double(acc)
            if bit == "1":
                acc, _ = self.pairing._twist_add(acc, q_pt)
        e2.assert_equal(acc[0], x)
        e2.assert_equal(acc[1], e2.neg(y))

    def _bind_public(self, pub) -> Element:
        if isinstance(pub, Element):
            return pub  # cross-curve: caller-allocated emulated scalar
        if isinstance(pub, int):
            return self.curve.fr.constant(pub)
        return self.curve.fr.from_native(pub)  # same-curve native variable

    # -- BSB22 commitment wire re-derivation ---------------------------------
    def _gt_one(self):
        """Host GT identity in the type assert_pairing_equal compares."""
        if self.curve_id == "bw6-761":
            from ...curves.bw6_761 import Fp6D

            return Fp6D.one()
        from ...curves.tower import Fp12

        return Fp12.one(self._host.tower)

    def _assert_bits_canonical(self, bits, modulus: int):
        """Kill the +q alias of a full-width api.to_binary: constrain
        Σ bitsᵢ·2^i ≤ q−1 (constant-bound MSB-scan comparator)."""
        api = self.api
        c = modulus - 1
        eq = 1
        for i in range(len(bits) - 1, -1, -1):
            if (c >> i) & 1:
                eq = api.mul(eq, bits[i])
            else:
                api.assert_is_equal(api.mul(eq, bits[i]), 0)

    def _absorb_value(self, m, raw, field):
        """Absorb a committed value/coordinate exactly as the host
        mimc_commitment_hash does: directly when the source field fits the
        outer-native one, else as canonical little-endian 64-bit limbs of
        the emulated element."""
        if field.p <= self._native_modulus and not isinstance(
                raw, Element):
            m.write(raw)
            return
        owner = (self.curve.fr if field.p == self._r
                 else self.curve.fp)
        assert owner.w == 64, "absorb convention requires w=64 limb presets"
        if isinstance(raw, Element):
            el = raw
        elif isinstance(raw, int):
            el = owner.constant(raw)
        else:  # native var into the (larger) emulated field
            el = owner.from_native(raw)
        el = owner.reduce(el)
        owner.assert_canonical(el)
        for limb in el.limbs:
            m.write(limb)

    def _commitment_aux_values(self, cms, public_inputs):
        """≙ verifier.go:643-656 solveCommitmentWire — replay
        backend.hash_to_field.mimc_commitment_hash over the outer-native
        field; returns the truncated digest per commitment as (Element
        scalar, native value var)."""
        from ...backend.hash_to_field import MIMC_COMMITMENT_TAG
        from ..hash.mimc import MiMC

        api = self.api
        nq = self._native_modulus
        out = []
        out_bits = min(self._r.bit_length(), nq.bit_length()) - 1
        xs_raw = [1] + list(public_inputs)
        for i, committed_idx in enumerate(
                self.vk.public_and_commitment_committed):
            m = MiMC(api, nq)
            m.write(int.from_bytes(MIMC_COMMITMENT_TAG, "big") % nq)
            # commitment coordinates: emulated Fp elements -> limbs
            self._absorb_value(m, cms[i].x, self.curve.fp)
            self._absorb_value(m, cms[i].y, self.curve.fp)
            for j in committed_idx:
                self._absorb_value(m, xs_raw[j], self.curve.fr)
            d = m.sum()
            bits = api.to_binary(d, nq.bit_length())
            self._assert_bits_canonical(bits, nq)
            lo = bits[:out_bits]
            val = api.from_binary(lo)
            xs_raw.append(val)
            scalar = self.curve.fr.from_native(val, n_bits=out_bits)
            out.append((scalar, val))
        return out, out_bits

    def assert_proof(self, proof: VerifierProof, public_inputs) -> None:
        """Constrain the proof valid for the given public inputs
        (≙ Verifier.AssertProof, verifier.go): on-curve/subgroup checks,
        kSum = K₀ + Σ pubᵢ·Kᵢ₊₁, then
        e(Ar, Bs)·e(−kSum, γ)·e(−Krs, δ) == e(α, β)."""
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
        c = self.curve
        self._assert_g1_member(proof.ar)
        self._assert_g1_member(proof.krs)
        if self._g2_fp2:
            self._assert_g2_member(proof.bs)
        else:
            self._assert_g2_member_fp(proof.bs)
        for cm in cms:
            self._assert_g1_member(cm)
        if proof.commitment_pok is not None:
            self._assert_g1_member(proof.commitment_pok)

        def pt(p):
            return (p.x, p.y)

        def g2v(v):
            return pt(v) if not self._g2_fp2 else v

        aux = []
        out_bits = self._r.bit_length()
        if cms:
            aux, out_bits = self._commitment_aux_values(cms, public_inputs)
            from ..pedersen import assert_commitment, fold_commitments

            folded = fold_commitments(cms)
            assert_commitment(
                self.pairing, self._gt_one(),
                pt(folded), pt(proof.commitment_pok), self._cm_vks[0],
            )

        k_sum = c.constant_point(vk.g1_k[0])
        n_bits = self._r.bit_length()
        for pub, k_pt in zip(public_inputs, vk.g1_k[1:]):
            s = self._bind_public(pub)
            term = c.scalar_mul(c.constant_point(k_pt), s, n_bits)
            k_sum = c.add_unified(k_sum, term)
        for i, (scalar, _) in enumerate(aux):
            k_pt = vk.g1_k[vk.nb_public + i]
            term = c.scalar_mul(c.constant_point(k_pt), scalar, out_bits)
            k_sum = c.add_unified(k_sum, term)
        for cm in cms:  # ≙ verifier.go:676-678 kSum += proof.Commitments
            k_sum = c.add_unified(k_sum, cm)

        self.pairing.assert_pairing_equal(
            [
                (pt(proof.ar), g2v(proof.bs)),
                (pt(c.neg(k_sum)), g2v(self._gamma)),
                (pt(c.neg(proof.krs)), g2v(self._delta)),
            ],
            self._e_alpha_beta,
        )
