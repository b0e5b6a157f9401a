"""In-circuit PLONK verifier over emulated curves (BN254, BLS12-381).

Role parity: reference std/recursion/plonk (verifier.go — AssertProof:
in-circuit transcript replay, linearization-constant check, folded KZG
batch opening). The inner proof must be produced with fs_hash="mimc"
(≙ recursion.NewShort: the inner prover swaps to a hash the outer circuit
can afford). For SAME-curve recursion (BN254-in-BN254) the inner Fr is
the outer native field, so challenges replay natively and only points and
the pairing are emulated. For CROSS-curve recursion (a BLS12-381 proof
inside a BN254 circuit) every scalar — transcript, Lagrange evaluations,
linearization algebra — runs through the emulated inner Fr
(EmulatedNamedTranscript / EmulatedMiMC), still bit-identical to the host
prover's transcript. The verifying key is circuit-constant (the
reference's "fixed" vk placement).

Mirrors the gnark proof shape (backend/plonk/verify.py): checks the
claimed linearized-poly opening against −constLin, rebuilds the
linearized-polynomial digest as an emulated MSM, folds the batch opening
with the KZG γ challenge, then folds BOTH openings (batch at ζ, Z at ωζ)
with a transcript-derived u into ONE two-pair pairing check —
e(F₁ + u·F₂, G₂) · e(−(W₁ + u·W₂), τG₂) == 1 with
Fᵢ = Cᵢ − vᵢ·G + zᵢ·Wᵢ (≙ kzg.FoldProof/BatchVerifyMultiPoints).

BSB22-commitment proofs are supported (≙ verifier.go Bsb22Commitments):
the commitment points bind into the transcript before Z, their Qk
injection re-derives in-circuit from a native MiMC replay of the
commitment-point hash (the inner proof must come from
``plonk.prove(..., commitment_hash=("mimc", outer_modulus))``), and the
qcp columns join the linearization digest and the KZG batch fold.

Engine-level today like the other pairing-based gadgets (ROADMAP:
range-table emulated mul for compilation).

Copied from gnark_icicle_tpu/std/recursion/plonk.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_recursion.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...backend.transcript import point_limbs
from ...curves import bn254
from ..emulated import Element
from ..fiat_shamir import EmulatedNamedTranscript, NamedTranscript
from ..sw_emulated import AffinePoint, BLS12381G1, BN254G1, EmulatedCurve
from ..pairing_bn254 import BN254Pairing

_CHALLENGES = ["gamma", "beta", "alpha", "zeta"]


@dataclass
class PlonkVerifierProof:
    """Gadget-side PLONK proof (≙ recursion/plonk.Proof). Points are
    emulated G1 witnesses; evaluations are inner-Fr scalars (native vars
    for same-curve recursion, emulated Elements cross-curve)."""

    lro: list                    # 3 AffinePoints
    z_com: AffinePoint
    h_coms: list                 # 3 AffinePoints
    batch_claimed: list          # scalars [lin, l, r, o, s1, s2, qcp...]
    batch_h: AffinePoint         # W₁: batched opening at ζ
    z_shifted_claimed: object    # scalar Z(ωζ)
    z_shifted_h: AffinePoint     # W₂: Z opening at ωζ
    bsb22_commitments: tuple = ()  # BSB22 G1 commitments (AffinePoints)


class _NativeScalars:
    """Inner-Fr algebra when inner Fr == the outer native field."""

    def __init__(self, api, q: int):
        self.api = api
        self.q = q

    def constant(self, v: int):
        return v % self.q

    def add(self, *vs):
        return self.api.add(*vs) if len(vs) > 1 else vs[0]

    def sub(self, a, b):
        return self.api.sub(a, b)

    def mul(self, *vs):
        acc = vs[0]
        for v in vs[1:]:
            acc = self.api.mul(acc, v)
        return acc

    def inverse(self, a):
        return self.api.inverse(a)

    def assert_zero(self, a):
        self.api.assert_is_equal(a, 0)

    def pow_int(self, a, e: int):
        acc = None
        for b in bin(e)[2:]:
            if acc is not None:
                acc = self.api.mul(acc, acc)
            if acc is None:
                acc = a
            elif b == "1":
                acc = self.api.mul(acc, a)
        return acc

    def to_curve_scalar(self, curve, v):
        return curve.fr.from_native(v)


class _EmulatedScalars:
    """Inner-Fr algebra through an EmulatedField (cross-curve)."""

    def __init__(self, fr):
        self.fr = fr
        self.q = fr.p

    def constant(self, v: int):
        return self.fr.constant(v)

    def add(self, *vs):
        acc = vs[0]
        for v in vs[1:]:
            acc = self.fr.add(acc, v)
        return acc

    def sub(self, a, b):
        return self.fr.sub(a, b)

    def mul(self, *vs):
        acc = vs[0]
        for v in vs[1:]:
            acc = self.fr.mul(acc, v)
        return acc

    def inverse(self, a):
        return self.fr.inverse(a)

    def assert_zero(self, a):
        self.fr.assert_equal(a, self.fr.constant(0))

    def pow_int(self, a, e: int):
        acc = a
        for b in bin(e)[3:]:
            acc = self.fr.mul(acc, acc)
            if b == "1":
                acc = self.fr.mul(acc, a)
        return acc

    def to_curve_scalar(self, curve, v):
        return v  # already an Element of curve.fr's field


class PlonkVerifier:
    """≙ recursion/plonk.Verifier with a circuit-constant vk; the inner
    proof must come from plonk.prove(..., fs_hash="mimc"). curve_id
    selects same-curve ("bn254") or cross-curve ("bls12-381")."""

    def __init__(self, api, native_modulus: int, vk,
                 curve_id: str = "bn254"):
        self.api = api
        self.q = native_modulus
        self.vk = vk
        self.curve_id = curve_id
        if curve_id == "bn254":
            self.curve = EmulatedCurve(api, BN254G1, native_modulus)
            self.pairing = BN254Pairing(api, native_modulus)
            self._r = bn254.R
            self.s = _NativeScalars(api, native_modulus)
            self._mk_ts = lambda names: NamedTranscript(
                api, native_modulus, names)
        elif curve_id == "bls12-381":
            from ...curves import bls12_381 as b381
            from ..pairing_bls12_381 import BLS12381Pairing

            self.curve = EmulatedCurve(api, BLS12381G1, native_modulus)
            self.pairing = BLS12381Pairing(api, native_modulus)
            self._r = b381.R
            self.s = _EmulatedScalars(self.curve.fr)
            self._mk_ts = lambda names: EmulatedNamedTranscript(
                self.curve.fr, names)
        else:
            raise ValueError(f"unsupported recursion curve {curve_id!r}")
        e2 = self.pairing.e2
        self._g2_gen = (e2.constant(vk.g2_gen[0].c0, vk.g2_gen[0].c1),
                        e2.constant(vk.g2_gen[1].c0, vk.g2_gen[1].c1))
        self._g2_tau = (e2.constant(vk.g2_tau[0].c0, vk.g2_tau[0].c1),
                        e2.constant(vk.g2_tau[1].c0, vk.g2_tau[1].c1))

    # -- witness constructors ------------------------------------------------
    def proof_witness(self, proof) -> PlonkVerifierProof:
        """Bind a host Proof's values as gadget witnesses (engine path)."""
        fp = self.curve.fp

        def g1(pt):
            return AffinePoint(fp.constant(pt[0]), fp.constant(pt[1]))

        return PlonkVerifierProof(
            lro=[g1(c) for c in proof.lro],
            z_com=g1(proof.z_com),
            h_coms=[g1(c) for c in proof.h_coms],
            batch_claimed=[self.s.constant(int(v))
                           for v in proof.batch_claimed],
            batch_h=g1(proof.batch_h),
            z_shifted_claimed=self.s.constant(int(proof.z_shifted_claimed)),
            z_shifted_h=g1(proof.z_shifted_h),
            bsb22_commitments=tuple(
                g1(cm) for cm in (proof.bsb22_commitments or ())),
        )

    # -- helpers -------------------------------------------------------------
    def _absorb_point(self, ts, name: str, p: AffinePoint):
        """Absorb the CANONICAL coordinate limbs — exactly what the host
        MiMCTranscript absorbs (backend/transcript.point_limbs). The
        canonical-form assertion pins the unique encoding so a witness
        cannot grind the challenge through a +p alias."""
        fp = self.curve.fp
        x = fp.reduce(p.x)
        y = fp.reduce(p.y)
        fp.assert_canonical(x)
        fp.assert_canonical(y)
        ts.bind(name, x.limbs)
        ts.bind(name, y.limbs)

    def _bind_const_point(self, ts, name: str, host_pt):
        """vk commitments are circuit constants; bind their host limbs."""
        ts.bind(name, point_limbs(None, host_pt, n_limbs=self.curve.fp.k))

    # -- BSB22 commitment wire re-derivation ---------------------------------
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

    def _commitment_values(self, cms):
        """Replay backend.hash_to_field.mimc_commitment_hash over the
        outer-native field for each BSB22 commitment point — PLONK absorbs
        ONLY the point (the sha path hashes g1_to_bytes alone; ≙
        verify.go:173-195 solveCommitmentWire with the recursion hash).
        Returns the truncated digests as native value vars + the bit width."""
        from ...backend.hash_to_field import MIMC_COMMITMENT_TAG
        from ..hash.mimc import MiMC

        api = self.api
        nq = self.q
        fp = self.curve.fp
        assert fp.w == 64, "absorb convention requires w=64 limb presets"
        out_bits = min(self._r.bit_length(), nq.bit_length()) - 1
        vals = []
        for cm in cms:
            m = MiMC(api, nq)
            m.write(int.from_bytes(MIMC_COMMITMENT_TAG, "big") % nq)
            for coord in (cm.x, cm.y):
                el = fp.reduce(coord)
                fp.assert_canonical(el)
                for limb in el.limbs:
                    m.write(limb)
            d = m.sum()
            bits = api.to_binary(d, nq.bit_length())
            self._assert_bits_canonical(bits, nq)
            vals.append(api.from_binary(bits[:out_bits]))
        return vals, out_bits

    def _to_inner_scalar(self, val, out_bits: int):
        """A native value var as an inner-Fr scalar for the s algebra."""
        if isinstance(self.s, _NativeScalars):
            return val  # same-curve: inner Fr IS the native field
        return self.curve.fr.from_native(val, n_bits=out_bits)

    # -- the verifier --------------------------------------------------------
    def assert_proof(self, proof: PlonkVerifierProof, public_inputs) -> None:
        """Constrain the proof valid for the given public inputs
        (≙ backend/plonk/verify.py replayed in-circuit). public_inputs:
        native variables (same-curve) or emulated Elements / host ints
        (cross-curve)."""
        vk = self.vk
        c = self.curve
        s = self.s
        n = 1 << vk.log_n
        omega, k1, k2 = vk.omega, vk.k1, vk.k2
        n_bits = self._r.bit_length()
        public_inputs = [
            pv if not isinstance(pv, int) or self.curve_id == "bn254"
            else s.constant(pv)
            for pv in public_inputs
        ]

        cc_idx = list(vk.commitment_constraint_indexes or ())
        cms = list(proof.bsb22_commitments or ())
        if len(cms) != len(cc_idx):
            raise ValueError(
                f"expected {len(cc_idx)} BSB22 commitments, got {len(cms)}")
        if len(proof.batch_claimed) != 6 + len(cc_idx):
            raise ValueError("wrong number of claimed values")

        for pt in (*proof.lro, proof.z_com, *proof.h_coms,
                   proof.batch_h, proof.z_shifted_h, *cms):
            c.assert_on_curve(pt)  # G1 binding for the pairing inputs

        # ---- transcript replay (≙ MiMCTranscript, host-bit-identical) -----
        ts = self._mk_ts(_CHALLENGES)
        for nm in ("s1", "s2", "s3", "ql", "qr", "qm", "qo", "qk"):
            self._bind_const_point(ts, "gamma", vk.commitments[nm])
        for i in range(len(cms)):  # ≙ bindPublicData's Qcp binds
            self._bind_const_point(ts, "gamma", vk.commitments[f"qcp{i}"])
        ts.bind("gamma", list(public_inputs))
        for cm in proof.lro:
            self._absorb_point(ts, "gamma", cm)
        gamma = ts.compute_challenge("gamma")
        beta = ts.compute_challenge("beta")
        for cm in cms:  # bsb22 commitments bind before Z (host order)
            self._absorb_point(ts, "alpha", cm)
        self._absorb_point(ts, "alpha", proof.z_com)
        alpha = ts.compute_challenge("alpha")
        for cm in proof.h_coms:
            self._absorb_point(ts, "zeta", cm)
        zeta = ts.compute_challenge("zeta")

        lin_z, l_z, r_z, o_z, s1_z, s2_z = proof.batch_claimed[:6]
        qcp_z = list(proof.batch_claimed[6:])
        zu = proof.z_shifted_claimed

        # ---- linearization constant at ζ (inner-Fr algebra) ---------------
        one = s.constant(1)
        zeta_n = s.pow_int(zeta, n)
        zh_zeta = s.sub(zeta_n, one)

        def lagrange_at(j: int):
            wj = s.constant(pow(omega, j, s.q))
            den = s.mul(s.sub(zeta, wj), s.constant(n))
            return s.mul(s.mul(wj, zh_zeta), s.inverse(den))

        pi = s.constant(0)
        for j, pv in enumerate(public_inputs):
            pi = s.add(pi, s.mul(pv, lagrange_at(j)))
        if cms:
            # commitment Qk injections: PI += hash(C_i)·L_{ci}(ζ), the
            # hash replayed in-circuit (the inner proof must come from
            # plonk.prove(..., commitment_hash=("mimc", outer_modulus)))
            c_vals, out_bits = self._commitment_values(cms)
            for ci, cv in zip(cc_idx, c_vals):
                pi = s.add(pi, s.mul(self._to_inner_scalar(cv, out_bits),
                                     lagrange_at(ci)))
        l1_den = s.mul(s.sub(zeta, one), s.constant(n))
        l1_zeta = s.mul(zh_zeta, s.inverse(l1_den))
        alpha2_l1 = s.mul(s.mul(alpha, alpha), l1_zeta)

        cprod = s.mul(
            s.add(l_z, s.mul(beta, s1_z), gamma),
            s.add(r_z, s.mul(beta, s2_z), gamma),
        )
        const_lin = s.mul(s.mul(cprod, s.add(o_z, gamma)),
                          s.mul(alpha, zu))
        const_lin = s.add(s.sub(const_lin, alpha2_l1), pi)
        s.assert_zero(s.add(lin_z, const_lin))

        # ---- linearized polynomial digest (emulated MSM) ------------------
        s1_coef = s.mul(s.mul(cprod, beta), s.mul(alpha, zu))
        bz = s.mul(beta, zeta)
        idp = s.add(l_z, bz, gamma)
        idp = s.mul(idp, s.add(r_z, s.mul(bz, s.constant(k1)), gamma))
        idp = s.mul(idp, s.add(o_z, s.mul(bz, s.constant(k2)), gamma))
        z_coef = s.sub(alpha2_l1, s.mul(alpha, idp))
        rl = s.mul(l_z, r_z)
        zeta_n2 = s.pow_int(zeta, n + 2)
        neg_zh = s.sub(s.constant(0), zh_zeta)
        h1_coef = neg_zh
        h2_coef = s.mul(neg_zh, zeta_n2)
        h3_coef = s.mul(h2_coef, zeta_n2)

        def smul(pt, scalar):
            return c.scalar_mul(pt, s.to_curve_scalar(c, scalar), n_bits)

        lin_digest = c.constant_point(vk.commitments["qk"])  # scalar 1
        for nm, sc in (("ql", l_z), ("qr", r_z), ("qm", rl), ("qo", o_z)):
            host_pt = vk.commitments[nm]
            if host_pt is None:
                continue  # zero selector column: s·O = O
            lin_digest = c.add_unified(
                lin_digest, smul(c.constant_point(host_pt), sc))
        lin_digest = c.add_unified(
            lin_digest, smul(c.constant_point(vk.commitments["s3"]), s1_coef))
        lin_digest = c.add_unified(lin_digest, smul(proof.z_com, z_coef))
        for h_pt, sc in zip(proof.h_coms, (h1_coef, h2_coef, h3_coef)):
            lin_digest = c.add_unified(lin_digest, smul(h_pt, sc))
        for cm, qz in zip(cms, qcp_z):  # BSB22 columns: qcp_z(ζ)·C_i
            lin_digest = c.add_unified(lin_digest, smul(cm, qz))

        # ---- fold the batch opening with the KZG γ challenge --------------
        # (≙ kzg.FoldProof's deriveGamma: point, digests, claimed values,
        # then the shifted opening's claimed value)
        fts = self._mk_ts(["gamma"])
        fts.bind("gamma", [zeta])
        self._absorb_point(fts, "gamma", lin_digest)
        for cm in proof.lro:
            self._absorb_point(fts, "gamma", cm)
        for nm in ("s1", "s2"):
            self._bind_const_point(fts, "gamma", vk.commitments[nm])
        for i in range(len(cms)):
            self._bind_const_point(fts, "gamma", vk.commitments[f"qcp{i}"])
        fts.bind("gamma", list(proof.batch_claimed))
        fts.bind("gamma", [zu])
        gamma_kzg = fts.compute_challenge("gamma")

        digests = [lin_digest, *proof.lro,
                   c.constant_point(vk.commitments["s1"]),
                   c.constant_point(vk.commitments["s2"])]
        for i in range(len(cms)):
            digests.append(c.constant_point(vk.commitments[f"qcp{i}"]))
        fold_c = None
        fold_v = s.constant(0)
        gi = None  # None encodes γ⁰ = 1 (skip the first scalar mul)
        for d, v in zip(digests, proof.batch_claimed):
            term = d if gi is None else smul(d, gi)
            fold_c = term if fold_c is None else c.add_unified(fold_c, term)
            fold_v = s.add(fold_v, v if gi is None else s.mul(gi, v))
            gi = gamma_kzg if gi is None else s.mul(gi, gamma_kzg)

        # ---- fold both openings with u into one pairing check -------------
        uts = self._mk_ts(["u"])
        uts.bind("u", [gamma_kzg])
        self._absorb_point(uts, "u", proof.batch_h)
        self._absorb_point(uts, "u", proof.z_shifted_h)
        u = uts.compute_challenge("u")

        def opening_f(com, z_scalar, val_scalar, w_pt):
            """F = C − val·G + z·W for one KZG claim."""
            vg = c.scalar_mul_base(s.to_curve_scalar(c, val_scalar), n_bits)
            zw = c.scalar_mul(w_pt, s.to_curve_scalar(c, z_scalar), n_bits)
            return c.add_unified(c.add_unified(com, c.neg(vg)), zw)

        f1 = opening_f(fold_c, zeta, fold_v, proof.batch_h)
        zw_scalar = s.mul(zeta, s.constant(omega))
        f2 = opening_f(proof.z_com, zw_scalar, proof.z_shifted_claimed,
                       proof.z_shifted_h)
        u_em = s.to_curve_scalar(c, u)
        f_all = c.add_unified(f1, c.scalar_mul(f2, u_em, n_bits))
        w_all = c.add_unified(
            proof.batch_h,
            c.scalar_mul(proof.z_shifted_h, u_em, n_bits),
        )
        self.pairing.assert_pairing_check([
            ((f_all.x, f_all.y), self._g2_gen),
            ((c.neg(w_all).x, c.neg(w_all).y), self._g2_tau),
        ])
