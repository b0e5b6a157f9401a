"""In-circuit PLONK verifier over NATIVE BLS12-377 — 2-chain recursion.

Role parity: reference std/recursion/plonk instantiated with sw_bls12377
(the native path: a BW6-761 outer circuit verifies a BLS12-377 PLONK
proof with every CURVE operation native — one constraint per base-field
mul — while the inner-Fr scalar layer runs through a cheap 4-limb
emulated field, since BLS12-377's 253-bit Fr is smaller than the 377-bit
circuit field). The inner proof must come from
``plonk.prove(..., fs_hash="mimc")``; the transcript replays through
EmulatedNamedTranscript/EmulatedMiMC over the inner Fr, bit-identical to
the host MiMCTranscript.

Same proof shape and verification schedule as the emulated PlonkVerifier
(std/recursion/plonk.py, ≙ backend/plonk/verify.py): linearization
constant against −constLin, linearized-polynomial digest as a (native!)
MSM over transcript-derived scalars, KZG γ fold, u fold of both openings
into one 2-pair pairing check via the native BLS12-377 pairing gadget.

Point absorption: the host binds each affine coordinate as 6 little-endian
64-bit limbs (backend/transcript.point_limbs sized to BLS12-377's fp);
here coordinates are single native variables, decomposed to the same
limbs in-circuit and embedded into the emulated transcript field
(from_native with n_bits=64).

Copied from gnark_icicle_tpu/std/recursion/native_plonk.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_recursion.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...backend.transcript import point_limbs
from ...curves import bls12_377 as b377
from ..emulated import BLS12377_FR, Element, EmulatedField
from ..fiat_shamir import EmulatedNamedTranscript
from ..algebra_native import Fp1Ops, NativeField, SWProjective
from ..pairing_bls12_377 import BLS12377Pairing
from .plonk import _EmulatedScalars

_CHALLENGES = ["gamma", "beta", "alpha", "zeta"]
_FS_LIMBS = 6  # ceil(377 / 64): host point_limbs width for BLS12-377


@dataclass
class NativePlonkProof:
    """Gadget-side PLONK proof: points are native (x, y) pairs,
    evaluations are emulated inner-Fr Elements."""

    lro: list
    z_com: tuple
    h_coms: list
    batch_claimed: list          # [lin, l, r, o, s1, s2, qcp...]
    batch_h: tuple
    z_shifted_claimed: object
    z_shifted_h: tuple
    bsb22_commitments: tuple = ()  # BSB22 G1 commitments ((x, y) pairs)


class NativePlonkVerifier:
    """≙ recursion/plonk.Verifier[sw_bls12377] with circuit-constant vk."""

    def __init__(self, api, vk):
        self.api = api
        self.vk = vk
        self.pairing = BLS12377Pairing(api)
        self.nf = self.pairing.fp          # NativeField over b377.P
        self.g1 = self.pairing.g1          # SWProjective (complete)
        self.fr = EmulatedField(api, BLS12377_FR, b377.P)
        self.s = _EmulatedScalars(self.fr)
        e2 = self.pairing.e2
        self._g2_gen = (e2.constant(vk.g2_gen[0].c0, vk.g2_gen[0].c1),
                        e2.constant(vk.g2_gen[1].c0, vk.g2_gen[1].c1))
        self._g2_tau = (e2.constant(vk.g2_tau[0].c0, vk.g2_tau[0].c1),
                        e2.constant(vk.g2_tau[1].c0, vk.g2_tau[1].c1))

    # -- witness constructors ------------------------------------------------
    def proof_witness(self, proof) -> NativePlonkProof:
        """Bind a host Proof's values (engine path; a compiled outer
        circuit allocates them as Secret variables)."""
        nf = self.nf

        def g1(pt):
            return (nf.constant(pt[0]), nf.constant(pt[1]))

        return NativePlonkProof(
            lro=[g1(c) for c in proof.lro],
            z_com=g1(proof.z_com),
            h_coms=[g1(c) for c in proof.h_coms],
            batch_claimed=[self.fr.constant(int(v))
                           for v in proof.batch_claimed],
            batch_h=g1(proof.batch_h),
            z_shifted_claimed=self.fr.constant(int(proof.z_shifted_claimed)),
            z_shifted_h=g1(proof.z_shifted_h),
            bsb22_commitments=tuple(
                g1(cm) for cm in (proof.bsb22_commitments or ())),
        )

    # -- BSB22 commitment wire re-derivation ---------------------------------
    def _assert_bits_canonical(self, bits, modulus: int):
        """Σ bitsᵢ·2^i ≤ q−1 (kills the +q alias of api.to_binary)."""
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
        outer-native field (= BW6-761 Fr = BLS12-377 Fp, so the point
        coordinates absorb DIRECTLY — the native 2-chain's whole point);
        PLONK absorbs only the point. The inner proof must come from
        plonk.prove(..., commitment_hash=("mimc", b377.P))."""
        from ...backend.hash_to_field import MIMC_COMMITMENT_TAG
        from ..hash.mimc import MiMC

        api = self.api
        nq = b377.P  # outer BW6-761 scalar field == inner base field
        out_bits = min(b377.R.bit_length(), nq.bit_length()) - 1
        vals = []
        for cm in cms:
            m = MiMC(api, nq)
            m.write(int.from_bytes(MIMC_COMMITMENT_TAG, "big") % nq)
            m.write(cm[0])
            m.write(cm[1])
            d = m.sum()
            bits = api.to_binary(d, nq.bit_length())
            self._assert_bits_canonical(bits, nq)
            vals.append(api.from_binary(bits[:out_bits]))
        return vals, out_bits

    # -- helpers -------------------------------------------------------------
    def _coord_limb_elements(self, v):
        """A native coordinate as the host's 6 transcript limbs, embedded
        into the emulated inner Fr (64-bit values — the decomposition is
        the range proof and pins the canonical encoding)."""
        api = self.api
        bits = api.to_binary(v, _FS_LIMBS * 64)
        out = []
        for i in range(_FS_LIMBS):
            limb = api.from_binary(bits[i * 64 : (i + 1) * 64])
            out.append(self.fr.from_native(limb, n_bits=64))
        return out

    def _absorb_point(self, ts, name: str, xy):
        ts.bind(name, self._coord_limb_elements(xy[0]))
        ts.bind(name, self._coord_limb_elements(xy[1]))

    def _bind_const_point(self, ts, name: str, host_pt):
        ts.bind(name, point_limbs(None, host_pt, n_limbs=_FS_LIMBS))

    def _smul(self, affine_or_proj, scalar: Element):
        """[s]·P over the native curve by the emulated scalar's bits."""
        P = (self.g1.from_affine(affine_or_proj)
             if len(affine_or_proj) == 2 else affine_or_proj)
        return self.g1.scalar_mul_bits(P, self.fr.bits(scalar))

    def _to_affine(self, P):
        return self.g1.to_affine(self.nf.div, P)

    # -- the verifier --------------------------------------------------------
    def assert_proof(self, proof: NativePlonkProof, public_inputs) -> None:
        """Constrain the proof valid for the given public inputs (ints or
        emulated inner-Fr Elements)."""
        vk = self.vk
        s = self.s
        g1 = self.g1
        nf = self.nf
        n = 1 << vk.log_n
        omega, k1, k2 = vk.omega, vk.k1, vk.k2
        public_inputs = [
            pv if isinstance(pv, Element) else s.constant(int(pv))
            for pv in public_inputs
        ]

        cc_idx = list(vk.commitment_constraint_indexes or ())
        cms = list(proof.bsb22_commitments or ())
        if len(cms) != len(cc_idx):
            raise ValueError(
                f"expected {len(cc_idx)} BSB22 commitments, got {len(cms)}")
        if len(proof.batch_claimed) != 6 + len(cc_idx):
            raise ValueError("wrong number of claimed values")

        # on-curve + subgroup membership of every attacker-supplied point
        # (φ-eigenvalue fast check; BLS12-377's G1 cofactor is ≈2^125, so
        # on-curve alone would admit small-order components)
        for pt in (*proof.lro, proof.z_com, *proof.h_coms,
                   proof.batch_h, proof.z_shifted_h, *cms):
            self.pairing.assert_g1_member(pt)

        # ---- transcript replay (≙ MiMCTranscript, host-bit-identical) -----
        ts = EmulatedNamedTranscript(self.fr, _CHALLENGES)
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

        # ---- linearization constant at ζ (emulated inner-Fr algebra) ------
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
            # commitment Qk injections: PI += hash(C_i)·L_{ci}(ζ)
            c_vals, out_bits = self._commitment_values(cms)
            for ci, cv in zip(cc_idx, c_vals):
                pi = s.add(pi, s.mul(
                    self.fr.from_native(cv, n_bits=out_bits),
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

        # ---- linearized polynomial digest (NATIVE MSM) --------------------
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

        def const_pt(host_pt):
            return g1.from_affine((nf.constant(host_pt[0]),
                                   nf.constant(host_pt[1])))

        lin_digest = const_pt(vk.commitments["qk"])  # scalar 1
        for nm, sc in (("ql", l_z), ("qr", r_z), ("qm", rl), ("qo", o_z)):
            host_pt = vk.commitments[nm]
            if host_pt is None:
                continue  # zero selector column: s·O = O
            lin_digest = g1.add(
                lin_digest, self._smul(const_pt(vk.commitments[nm]), sc))
        lin_digest = g1.add(
            lin_digest, self._smul(const_pt(vk.commitments["s3"]), s1_coef))
        lin_digest = g1.add(lin_digest, self._smul(proof.z_com, z_coef))
        for h_pt, sc in zip(proof.h_coms, (h1_coef, h2_coef, h3_coef)):
            lin_digest = g1.add(lin_digest, self._smul(h_pt, sc))
        for cm, qz in zip(cms, qcp_z):  # BSB22 columns: qcp_z(ζ)·C_i
            lin_digest = g1.add(lin_digest, self._smul(cm, qz))
        lin_aff = self._to_affine(lin_digest)

        # ---- fold the batch opening with the KZG γ challenge --------------
        fts = EmulatedNamedTranscript(self.fr, ["gamma"])
        fts.bind("gamma", [zeta])
        self._absorb_point(fts, "gamma", lin_aff)
        for cm in proof.lro:
            self._absorb_point(fts, "gamma", cm)
        for nm in ("s1", "s2"):
            self._bind_const_point(fts, "gamma", vk.commitments[nm])
        for i in range(len(cms)):
            self._bind_const_point(fts, "gamma", vk.commitments[f"qcp{i}"])
        fts.bind("gamma", list(proof.batch_claimed))
        fts.bind("gamma", [zu])
        gamma_kzg = fts.compute_challenge("gamma")

        digests = [g1.from_affine(lin_aff),
                   *(g1.from_affine(p) for p in proof.lro),
                   const_pt(vk.commitments["s1"]),
                   const_pt(vk.commitments["s2"])]
        for i in range(len(cms)):
            digests.append(const_pt(vk.commitments[f"qcp{i}"]))
        fold_c = None
        fold_v = s.constant(0)
        gi = None  # γ⁰ = 1
        for d, v in zip(digests, proof.batch_claimed):
            term = d if gi is None else self._smul(d, gi)
            fold_c = term if fold_c is None else g1.add(fold_c, term)
            fold_v = s.add(fold_v, v if gi is None else s.mul(gi, v))
            gi = gamma_kzg if gi is None else s.mul(gi, gamma_kzg)

        # ---- fold both openings with u into one pairing check -------------
        uts = EmulatedNamedTranscript(self.fr, ["u"])
        uts.bind("u", [gamma_kzg])
        self._absorb_point(uts, "u", proof.batch_h)
        self._absorb_point(uts, "u", proof.z_shifted_h)
        u = uts.compute_challenge("u")

        gen = g1.from_affine((nf.constant(b377.G1_GEN[0]),
                              nf.constant(b377.G1_GEN[1])))

        def opening_f(com_proj, z_scalar, val_scalar, w_aff):
            """F = C − val·G + z·W for one KZG claim (projective)."""
            vg = self._smul(gen, val_scalar)
            zw = self._smul(w_aff, z_scalar)
            return g1.add(g1.add(com_proj, g1.neg(vg)), zw)

        f1 = opening_f(fold_c, zeta, fold_v, proof.batch_h)
        zw_scalar = s.mul(zeta, s.constant(omega))
        f2 = opening_f(g1.from_affine(proof.z_com), zw_scalar,
                       proof.z_shifted_claimed, proof.z_shifted_h)
        f_all = g1.add(f1, self._smul(self._to_affine(f2), u))
        w_all = g1.add(g1.from_affine(proof.batch_h),
                       self._smul(proof.z_shifted_h, u))
        f_aff = self._to_affine(f_all)
        w_aff = self._to_affine(w_all)
        self.pairing.assert_pairing_check([
            (f_aff, self._g2_gen),
            ((w_aff[0], nf.neg(w_aff[1])), self._g2_tau),
        ])
