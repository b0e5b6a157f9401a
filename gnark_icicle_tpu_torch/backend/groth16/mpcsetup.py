"""Groth16 trusted-setup MPC ceremony (phase 1 powers-of-tau, phase 2
circuit-specific).

Role parity: reference backend/groth16/bn254/mpcsetup/ — InitPhase1/
Contribute/Verify (phase1.go:52-135), InitPhase2 (phase2.go:53), and the
G1 point-FFT used to specialize the SRS to a circuit (lagrange.go:145
difFFTG1). Structure follows BGM17 ("MMORPG"): each phase-1 contributor
multiplies the tau/alpha/beta power ladders by fresh randomness and proves
continuity with pairing checks; phase 2 does the same for delta. The
final key matches what a single honest dealer with the combined randomness
would produce — test-asserted by verifying proofs made with the MPC key.

Contribution binding: each contribution carries BGM17 public keys
(SG = s·G₁, SXG = s·x·G₁, XR = x·R with R = HashToG2(SG ‖ SXG ‖
transcript-hash, dst)) exactly like the reference (utils.go newPublicKey/
genR, phase1.go:97-99); verification recomputes R from the PREVIOUS
accumulator's hash so a contribution cannot be replayed against another
transcript, then checks the knowledge pairing e(SG, XR) == e(SXG, R) and
the accumulator-continuity ratios (phase1.go:135-196).

Copied from gnark_icicle_tpu/backend/groth16/mpcsetup.py:1, so that the
port imports nothing of the JAX package. It is host code and launches no
kernel: ``finalize`` returns the port's ProvingKey and VerifyingKey, whose
device staging the port's ``prove`` caches as for a key from ``setup``.
tests/test_torch_mpcsetup.py holds the accumulators and keys to the
original's.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass, field

from .keys import ProvingKey, VerifyingKey
from .setup import qap_evaluations  # noqa: F401 (phase-2 math reference)


def _same_ratio(curve, a1, b1, a2, b2) -> bool:
    """e(a1, a2) == e(b1, b2) (≙ mpcsetup utils.go:105 sameRatio)."""
    from ...curves.tower import Fp12

    return curve.miller_and_final_exp(
        [a1, b1], [curve.g2.neg(a2), b2]
    ) == Fp12.one(curve.tower)


@dataclass
class ContributionPublicKey:
    """≙ mpcsetup.PublicKey (utils.go:31-35): the BGM17 knowledge proof."""

    sg: tuple    # s·G₁
    sxg: tuple   # s·x·G₁
    xr: tuple    # x·R (G₂)


def _new_public_key(curve, x: int, challenge: bytes, dst: int,
                    rng=None) -> ContributionPublicKey:
    """≙ newPublicKey (utils.go:37-58)."""
    q = curve.fr.modulus
    s = _rand(q, rng)
    sg = curve.g1.scalar_mul(curve.g1.generator, s)
    sxg = curve.g1.scalar_mul(sg, x)
    r_pt = _gen_r(curve, sg, sxg, challenge, dst)
    return ContributionPublicKey(
        sg=sg, sxg=sxg, xr=curve.g2.scalar_mul(r_pt, x)
    )


def _gen_r(curve, sg, sxg, challenge: bytes, dst: int):
    """R = HashToG2(sG₁ ‖ sxG₁ ‖ challenge, dst) (≙ genR, utils.go:159)."""
    from ...curves.hash_to_g2 import hash_to_g2
    from ...io.serialize import g1_to_bytes

    msg = (g1_to_bytes(curve, sg, compressed=False)
           + g1_to_bytes(curve, sxg, compressed=False) + challenge)
    return hash_to_g2(curve, msg, bytes([dst]))


def _verify_pk(curve, pk: ContributionPublicKey, challenge: bytes,
               dst: int) -> tuple:
    """Check the knowledge pairing; returns R for continuity checks."""
    r_pt = _gen_r(curve, pk.sg, pk.sxg, challenge, dst)
    if not _same_ratio(curve, pk.sg, pk.sxg, pk.xr, r_pt):
        raise ValueError(f"contribution public key invalid (dst {dst})")
    return r_pt


def _rand(q, rng=None):
    return (rng.randrange(q - 1) + 1) if rng else (secrets.randbelow(q - 1) + 1)


@dataclass
class Phase1:
    """Powers-of-tau accumulator (≙ mpcsetup.Phase1).

    tau_g1[i] = [τ^i]₁ (i < 2n−1), tau_g2[i] = [τ^i]₂ (i < n),
    alpha_tau_g1[i] = [ατ^i]₁, beta_tau_g1[i] = [βτ^i]₁ (i < n), beta_g2.
    """

    curve: object
    n: int
    tau_g1: list
    tau_g2: list
    alpha_tau_g1: list
    beta_tau_g1: list
    beta_g2: tuple
    contributions: list = field(default_factory=list)

    @classmethod
    def init(cls, curve, n: int) -> "Phase1":
        g1, g2 = curve.g1.generator, curve.g2.generator
        return cls(
            curve=curve, n=n,
            tau_g1=[g1] * (2 * n - 1),
            tau_g2=[g2] * n,
            alpha_tau_g1=[g1] * n,
            beta_tau_g1=[g1] * n,
            beta_g2=g2,
        )

    def state_hash(self) -> bytes:
        """sha256 of the serialized accumulator (≙ phase1.hash())."""
        from ...io.serialize import g1_to_bytes, g2_to_bytes

        c = self.curve
        h = hashlib.sha256()
        for pt in self.tau_g1 + self.alpha_tau_g1 + self.beta_tau_g1:
            h.update(g1_to_bytes(c, pt, compressed=True))
        for pt in self.tau_g2 + [self.beta_g2]:
            h.update(g2_to_bytes(c, pt, compressed=True))
        return h.digest()

    def contribute(self, rng=None) -> None:
        """Multiply in fresh (Δτ, Δα, Δβ) with transcript-bound knowledge
        proofs (≙ Phase1.Contribute, phase1.go:89-122)."""
        c = self.curve
        q = c.fr.modulus
        dt, da, db = _rand(q, rng), _rand(q, rng), _rand(q, rng)
        challenge = self.state_hash()  # previous accumulator binds the pks
        witness = {
            "challenge": challenge,
            "prev": {
                "tau_g1_1": self.tau_g1[1],
                "alpha_0": self.alpha_tau_g1[0],
                "beta_0": self.beta_tau_g1[0],
                "tau_g2_1": self.tau_g2[1],
                "beta_g2": self.beta_g2,
            },
            "pk_tau": _new_public_key(c, dt, challenge, 1, rng),
            "pk_alpha": _new_public_key(c, da, challenge, 2, rng),
            "pk_beta": _new_public_key(c, db, challenge, 3, rng),
        }
        pw = 1
        powers = []
        for _ in range(2 * self.n - 1):
            powers.append(pw)
            pw = pw * dt % q
        self.tau_g1 = [c.g1.scalar_mul(p, powers[i])
                       for i, p in enumerate(self.tau_g1)]
        self.tau_g2 = [c.g2.scalar_mul(p, powers[i])
                       for i, p in enumerate(self.tau_g2)]
        self.alpha_tau_g1 = [
            c.g1.scalar_mul(p, da * powers[i] % q)
            for i, p in enumerate(self.alpha_tau_g1)
        ]
        self.beta_tau_g1 = [
            c.g1.scalar_mul(p, db * powers[i] % q)
            for i, p in enumerate(self.beta_tau_g1)
        ]
        self.beta_g2 = c.g2.scalar_mul(self.beta_g2, db)
        witness["post_hash"] = self.state_hash()
        self.contributions.append(witness)

    def verify(self) -> None:
        """Pairing consistency of the final accumulator + continuity chain
        (≙ VerifyPhase1, phase1.go:95-196).

        Every ladder is checked over its FULL length via random linear
        combinations (≙ linearCombinationG1/G2 + sameRatio in the
        reference's verifyPhase1): for random rᵢ,
        e(Σ rᵢ·P[i+1], g₂) == e(Σ rᵢ·P[i], [τ]₂) holds for all random
        choices only if P[i+1] = τ·P[i] for every i — so a malicious
        contributor cannot hide arbitrary points anywhere in tau_g1,
        alpha_tau_g1, beta_tau_g1, or tau_g2 (the G2 ladder is anchored
        the same way through [τ]₁)."""
        c = self.curve
        e = c.miller_and_final_exp
        g1, g2 = c.g1.generator, c.g2.generator

        def lin_comb(group, pts, coeffs):
            acc = None
            for p, r in zip(pts, coeffs):
                acc = group.add(acc, group.scalar_mul(p, r))
            return acc

        def ladder_ok_g1(pts) -> bool:
            # P[i+1] = τ·P[i] for all i, batched into one sameRatio
            rs = [secrets.randbits(127) + 1 for _ in range(len(pts) - 1)]
            base = lin_comb(c.g1, pts[:-1], rs)
            shift = lin_comb(c.g1, pts[1:], rs)
            return _same_ratio(c, shift, base, g2, self.tau_g2[1])

        if not ladder_ok_g1(self.tau_g1):
            raise ValueError("tau ladder inconsistent")
        if not ladder_ok_g1(self.alpha_tau_g1):
            raise ValueError("alpha ladder inconsistent")
        if not ladder_ok_g1(self.beta_tau_g1):
            raise ValueError("beta ladder inconsistent")
        # G2 ladder: e([τ]₁, Σ rᵢ·τ₂[i]) == e(g₁, Σ rᵢ·τ₂[i+1])
        rs = [secrets.randbits(127) + 1 for _ in range(len(self.tau_g2) - 1)]
        base2 = lin_comb(c.g2, self.tau_g2[:-1], rs)
        shift2 = lin_comb(c.g2, self.tau_g2[1:], rs)
        if not _same_ratio(c, self.tau_g1[1], g1, base2, shift2):
            raise ValueError("tau G2 ladder inconsistent")
        # beta_g2 matches beta_tau_g1[0]
        if e([self.beta_tau_g1[0]], [g2]) != e([g1], [self.beta_g2]):
            raise ValueError("beta_g2 mismatch")
        # transcript-bound knowledge-proof chain (≙ verifyPhase1,
        # phase1.go:135-196): each contribution's public keys must verify
        # against the PREVIOUS accumulator hash, and the accumulated
        # tau/alpha/beta must be exactly the previous values scaled by the
        # proven exponents. The chain's first challenge is recomputed from
        # the deterministic initial state and its last post-hash from the
        # final accumulator, pinning both ends.
        expected = Phase1.init(c, self.n).state_hash()
        n_contrib = len(self.contributions)
        for ci, w in enumerate(self.contributions):
            if w["challenge"] != expected:
                raise ValueError(f"contribution {ci}: broken transcript chain")
            ch = w["challenge"]
            r_tau = _verify_pk(c, w["pk_tau"], ch, 1)
            r_alpha = _verify_pk(c, w["pk_alpha"], ch, 2)
            r_beta = _verify_pk(c, w["pk_beta"], ch, 3)
            post = (self.contributions[ci + 1]["prev"]
                    if ci + 1 < n_contrib else {
                        "tau_g1_1": self.tau_g1[1],
                        "alpha_0": self.alpha_tau_g1[0],
                        "beta_0": self.beta_tau_g1[0],
                        "tau_g2_1": self.tau_g2[1],
                        "beta_g2": self.beta_g2,
                    })
            prev = w["prev"]
            checks = [
                (post["tau_g1_1"], prev["tau_g1_1"], r_tau,
                 w["pk_tau"].xr, "tau update"),
                (post["alpha_0"], prev["alpha_0"], r_alpha,
                 w["pk_alpha"].xr, "alpha update"),
                (post["beta_0"], prev["beta_0"], r_beta,
                 w["pk_beta"].xr, "beta update"),
                (w["pk_tau"].sg, w["pk_tau"].sxg,
                 post["tau_g2_1"], prev["tau_g2_1"], "tau2 update"),
                (w["pk_beta"].sg, w["pk_beta"].sxg,
                 post["beta_g2"], prev["beta_g2"], "beta2 update"),
            ]
            for a1, b1, a2, b2, what in checks:
                if not _same_ratio(c, a1, b1, a2, b2):
                    raise ValueError(f"contribution {ci}: {what} not based "
                                     "on previous state")
            expected = w["post_hash"]
        if n_contrib and expected != self.state_hash():
            raise ValueError("final accumulator does not match the "
                             "transcript chain")


def _ifft_g1(curve, points, omega_inv: int, n: int):
    """Inverse FFT over G1 points: evaluations [f(ωⁱ)]₁ → [coeff]₁
    (≙ difFFTG1, mpcsetup/lagrange.go:145 — butterflies with point adds and
    twiddle scalar-muls)."""
    g1 = curve.g1
    q = curve.fr.modulus
    # bit-reverse copy
    pts = list(points)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            pts[i], pts[j] = pts[j], pts[i]
    m = 2
    while m <= n:
        wm = pow(omega_inv, n // m, q)
        for k in range(0, n, m):
            w = 1
            for l in range(m // 2):
                u = pts[k + l]
                t = g1.scalar_mul(pts[k + l + m // 2], w)
                pts[k + l] = g1.add(u, t)
                pts[k + l + m // 2] = g1.add(u, g1.neg(t))
                w = w * wm % q
        m <<= 1
    n_inv = pow(n, -1, q)
    return [g1.scalar_mul(p, n_inv) for p in pts]


@dataclass
class Phase2:
    """Circuit-specific phase: delta contributions over Z and K
    (≙ mpcsetup.Phase2)."""

    curve: object
    pk: ProvingKey
    vk: VerifyingKey
    delta_g1: tuple
    delta_g2: tuple
    contributions: list = field(default_factory=list)

    @classmethod
    def init(cls, phase1: Phase1, cs) -> "Phase2":
        """Specialize the powers-of-tau to a compiled R1CS with δ = 1.

        Lagrange-basis points [L_j(τ)]₁ come from the point-IFFT of the tau
        ladder; per-wire A/B/C points accumulate over constraint terms in
        the exponent (≙ setupABC in the exponent)."""
        c = phase1.curve
        q = c.fr.modulus
        n = phase1.n
        assert cs.nb_constraints <= n
        log_n = (n - 1).bit_length()
        assert 1 << log_n == n, "phase1 size must be a power of two"
        omega = c.fr.root_of_unity(log_n)
        omega_inv = pow(omega, -1, q)
        g1, g2 = c.g1, c.g2

        lag_tau = _ifft_g1(c, phase1.tau_g1[:n], omega_inv, n)
        lag_alpha = _ifft_g1(c, phase1.alpha_tau_g1[:n], omega_inv, n)
        lag_beta = _ifft_g1(c, phase1.beta_tau_g1[:n], omega_inv, n)
        # wait — the Lagrange basis is the FORWARD evaluation relationship:
        # [L_j(τ)]₁ = IFFT over the evaluation points of the monomial ladder
        # (L_j(τ) = Σ_i ifft-matrix · τ^i, linear in the exponent).

        nw = cs.nb_wires
        A = [None] * nw
        B1 = [None] * nw
        B2 = [None] * nw
        bAaBC = [None] * nw  # [βA_k + αB_k + C_k]₁ accumulated directly
        tau2 = phase1.tau_g2[:n]
        lag_tau2 = None  # G2 Lagrange only needed for B2

        # G2 Lagrange via point-IFFT in G2
        def ifft_g2(points):
            tmp_curve = c
            g = tmp_curve.g2
            pts = list(points)
            j = 0
            for i in range(1, n):
                bit = n >> 1
                while j & bit:
                    j ^= bit
                    bit >>= 1
                j |= bit
                if i < j:
                    pts[i], pts[j] = pts[j], pts[i]
            m = 2
            while m <= n:
                wm = pow(omega_inv, n // m, q)
                for k in range(0, n, m):
                    w = 1
                    for l in range(m // 2):
                        u = pts[k + l]
                        t = g.scalar_mul(pts[k + l + m // 2], w)
                        pts[k + l] = g.add(u, t)
                        pts[k + l + m // 2] = g.add(u, g.neg(t))
                        w = w * wm % q
                m <<= 1
            n_inv = pow(n, -1, q)
            return [g.scalar_mul(p, n_inv) for p in pts]

        lag_tau2 = ifft_g2(tau2)

        coeffs = cs.coeffs
        tc, tw = cs.term_coeff, cs.term_wire
        for j in range(cs.nb_constraints):
            (ls, le), (rs, re), (os_, oe) = cs.constraint_slots(j)
            for t in range(ls, le):
                k = tw[t]
                s = coeffs[tc[t]]
                A[k] = g1.add(A[k], g1.scalar_mul(lag_tau[j], s))
                bAaBC[k] = g1.add(bAaBC[k], g1.scalar_mul(lag_beta[j], s))
            for t in range(rs, re):
                k = tw[t]
                s = coeffs[tc[t]]
                B1[k] = g1.add(B1[k], g1.scalar_mul(lag_tau[j], s))
                B2[k] = g2.add(B2[k], g2.scalar_mul(lag_tau2[j], s))
                bAaBC[k] = g1.add(bAaBC[k], g1.scalar_mul(lag_alpha[j], s))
            for t in range(os_, oe):
                k = tw[t]
                s = coeffs[tc[t]]
                bAaBC[k] = g1.add(bAaBC[k], g1.scalar_mul(lag_tau[j], s))

        # Z points: [τ^i (τⁿ−1)]₁ from the extended ladder, bit-reversed to
        # the prover's layout (setup.py _bit_reverse_list)
        from .setup import _bit_reverse_list

        z_pts = []
        for i in range(n - 1):
            z_pts.append(
                g1.add(phase1.tau_g1[i + n], g1.neg(phase1.tau_g1[i]))
            )

        # vk pieces that need γ stay at γ=1 (the standard MPC choice)
        alpha_g1 = phase1.alpha_tau_g1[0]
        beta_g1 = phase1.beta_tau_g1[0]
        beta_g2 = phase1.beta_g2
        pk = ProvingKey(
            g1_alpha=alpha_g1, g1_beta=beta_g1,
            g1_delta=g1.generator,
            g2_beta=beta_g2, g2_delta=g2.generator,
            g1_a=A, g1_b=B1, g2_b=B2,
            g1_k=[bAaBC[k] for k in range(cs.nb_public, nw)],
            g1_z=_bit_reverse_list(z_pts, n),
            domain_log_n=log_n,
        )
        vk = VerifyingKey(
            g1_alpha=alpha_g1, g2_beta=beta_g2,
            g2_gamma=g2.generator,  # γ = 1
            g2_delta=g2.generator,
            g1_k=[bAaBC[k] for k in range(cs.nb_public)],
            nb_public=cs.nb_public,
        )
        return cls(curve=c, pk=pk, vk=vk,
                   delta_g1=g1.generator, delta_g2=g2.generator)

    def state_hash(self) -> bytes:
        """sha256 over the δ-bearing state (≙ phase2.hash())."""
        from ...io.serialize import g1_to_bytes, g2_to_bytes

        c = self.curve
        h = hashlib.sha256()
        h.update(g1_to_bytes(c, self.delta_g1, compressed=True))
        h.update(g2_to_bytes(c, self.delta_g2, compressed=True))
        for pt in self.pk.g1_z + self.pk.g1_k:
            h.update(g1_to_bytes(c, pt, compressed=True))
        return h.digest()

    def contribute(self, rng=None) -> None:
        """Multiply δ in (≙ Phase2.Contribute): scales δ up, Z and K down;
        records a transcript-bound knowledge proof for Δδ."""
        c = self.curve
        q = c.fr.modulus
        g1, g2 = c.g1, c.g2
        dd = _rand(q, rng)
        dd_inv = pow(dd, -1, q)
        challenge = self.state_hash()
        witness = {
            "challenge": challenge,
            "prev_delta_g1": self.delta_g1,
            "prev_delta_g2": self.delta_g2,
            "pk_delta": _new_public_key(c, dd, challenge, 1, rng),
        }
        self.delta_g1 = g1.scalar_mul(self.delta_g1, dd)
        self.delta_g2 = g2.scalar_mul(self.delta_g2, dd)
        self.pk.g1_delta = self.delta_g1
        self.pk.g2_delta = self.delta_g2
        self.vk.g2_delta = self.delta_g2
        self.pk.g1_z = [g1.scalar_mul(p, dd_inv) for p in self.pk.g1_z]
        self.pk.g1_k = [g1.scalar_mul(p, dd_inv) for p in self.pk.g1_k]
        witness["post_hash"] = self.state_hash()
        self.contributions.append(witness)
        self.pk._device = {}  # invalidate any device staging

    def verify(self) -> None:
        c = self.curve
        e = c.miller_and_final_exp
        g1, g2 = c.g1.generator, c.g2.generator
        if e([self.delta_g1], [g2]) != e([g1], [self.delta_g2]):
            raise ValueError("delta G1/G2 mismatch")
        n_contrib = len(self.contributions)
        for ci, w in enumerate(self.contributions):
            r_pt = _verify_pk(c, w["pk_delta"], w["challenge"], 1)
            post = (self.contributions[ci + 1]["prev_delta_g1"]
                    if ci + 1 < n_contrib else self.delta_g1)
            # e(δ_post, R) == e(δ_prev, x·R)  ⟺  δ_post = x·δ_prev
            if not _same_ratio(c, post, w["prev_delta_g1"], r_pt,
                               w["pk_delta"].xr):
                raise ValueError(
                    f"contribution {ci}: delta not based on previous state"
                )
        if n_contrib and self.contributions[-1]["post_hash"] \
                != self.state_hash():
            raise ValueError("final delta state does not match transcript")

    def finalize(self):
        """(pk, vk) ready for proving."""
        return self.pk, self.vk
