"""KZG polynomial commitments over the port's G1 MSM.

Port of gnark_icicle_tpu/backend/kzg.py: ``SRS`` (:20, with
``device_points`` :29), ``unsafe_srs`` (:38; its device branch :54-62 runs
the powers on the fixed-base ladder, ``ops/fixed_base.py``, the K6 role),
``KZG.commit`` (:91), ``commit_mont`` (:98) and ``open`` (:154), each commit
one G1 MSM (``ops/msm.py``: the bucket accumulation, reduction and Horner
kernels). ``verify`` (:169) and ``batch_verify_same_point`` (:183) are host
pairings, copied. ``commit_batch``/``commit_mont_batch`` (:111, :127) are one
``msm_batch`` over the shared SRS table (``_commit_scal_batch`` :141).

Every device entry runs on ``device`` (None: the first CUDA card, raising
without one; ``"cpu"`` runs the plain versions). Verify-only callers never
build a device context, as in the reference (:83-88).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field

import torch

from ..device import DeviceCtx
from ..ops.cuda import resolve_device
from ..ops.field_t import TField
from ..ops.fixed_base import batch_scalar_mul_host
from ..ops.msm import pick_window


def port_point(pt):
    """A G2 point whose coordinates are any Fp2 (c0, c1; another package's
    too) as the port's Fp2 of the curve with that modulus; G1 points,
    BW6-761's G2 over Fp and infinity as they are."""
    if pt is None or not hasattr(pt[0], "c0"):
        return pt
    from ..curves import CURVES
    from ..curves.tower import Fp2

    tp = next(c.tower for c in CURVES.values()
              if getattr(c, "tower", None) is not None and c.tower.p == pt[0].tp.p)
    return tuple(Fp2(tp, v.c0, v.c1) for v in pt)


@dataclass
class SRS:
    """Powers of tau: [τ^i]₁ for i ≤ n, plus [1]₂, [τ]₂."""

    g1_powers: list  # host affine points
    g2_gen: tuple
    g2_tau: tuple
    _device: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_reference(cls, obj):
        """An SRS from any object with the same public fields (the JAX
        package's), G2 coordinates as the port's Fp2."""
        return cls(g1_powers=list(obj.g1_powers), g2_gen=port_point(obj.g2_gen),
                   g2_tau=port_point(obj.g2_tau))

    def device_points(self, ctx: DeviceCtx, n: int):
        """Upload-once staging of the first n G1 powers on ctx.device."""
        key = (ctx.device, n)
        if key not in self._device:
            self._device[key] = ctx.g1_points(self.g1_powers[:n])
        return self._device[key]


def unsafe_srs(curve, size: int, tau: int | None = None, rng=None,
               device=None) -> SRS:
    """Insecure SRS for tests/benchmarks (≙ test/unsafekzg, kzgsrs.go:64).

    τ is drawn from rng first, as in the reference, so one rng gives one
    SRS. 256 powers or more run on the fixed-base ladder of ``device``
    (None: the first CUDA card, raising without one), fewer as host scalar
    multiplications."""
    q = curve.fr.modulus
    ctx = DeviceCtx(curve, resolve_device(device))
    if tau is None:
        tau = (rng.randrange if rng else (lambda m: secrets.randbelow(m - 1) + 1))(q)
    g1 = curve.g1
    scalars = []
    acc = 1
    for _ in range(size):
        scalars.append(acc)
        acc = acc * tau % q
    if size >= 256:  # device fixed-base batch
        powers = batch_scalar_mul_host(ctx.g1, g1, g1.generator, scalars,
                                       q.bit_length(), ctx.device)
    else:
        powers = [g1.scalar_mul(g1.generator, s) for s in scalars]
    return SRS(
        g1_powers=powers,
        g2_gen=curve.g2.generator,
        g2_tau=curve.g2.scalar_mul(curve.g2.generator, tau),
    )


class KZG:
    """Commit/open/verify bound to one curve + SRS, commits on ``device``."""

    def __init__(self, curve, srs: SRS, device=None):
        self.curve = curve
        self.srs = srs
        self.device = device
        self._ctx = None
        self.q = curve.fr.modulus

    @property
    def ctx(self) -> DeviceCtx:
        """Lazy device context: verify-only callers (host pairing) never
        touch the device."""
        if self._ctx is None:
            self._ctx = DeviceCtx(self.curve, self.device)
        return self._ctx

    # -- commit (device MSM) -------------------------------------------------
    def commit(self, coeffs: list) -> tuple:
        """[p(τ)]₁ for coefficient list (host ints, low-to-high degree)."""
        n = len(coeffs)
        if n == 0:
            return None
        return self._commit_scal(self.ctx.fr_plain(coeffs), n)

    def commit_mont(self, coeffs_mont) -> tuple:
        """[p(τ)]₁ for a device Montgomery-form (Wr, n) coefficient tensor —
        PLONK's quotient and linearization commit without a host round trip."""
        n = coeffs_mont.shape[1]
        return self._commit_scal(TField(self.ctx.fr).from_mont(coeffs_mont.contiguous()), n)

    def _commit_scal(self, scal, n):
        assert n <= len(self.srs.g1_powers), "SRS too small"
        table, inf = self.srs.device_points(self.ctx, n)
        res = self.ctx.msm_g1.msm(table, inf, scal, pick_window(n))
        return self.ctx.g1_to_host(res)

    # -- batched commits (one msm_batch for M polynomials) -------------------
    def commit_batch(self, coeffs_list) -> list:
        """[p_m(τ)]₁ for M equal-length coefficient lists through one
        ``msm_batch`` over the shared SRS table (PLONK's a/b/c group)."""
        ns = {len(c) for c in coeffs_list}
        assert len(ns) == 1, "commit_batch needs equal-length polynomials"
        n = ns.pop()
        if n == 0:
            return [None] * len(coeffs_list)
        return self._commit_scal_batch(
            torch.stack([self.ctx.fr_plain(c) for c in coeffs_list]), n)

    def commit_mont_batch(self, mont_list) -> list:
        """Batched ``commit_mont``: M device Montgomery (Wr, n) tensors of
        one width (PLONK's three quotient shards)."""
        n = mont_list[0].shape[1]
        assert all(m.shape[1] == n for m in mont_list), "commit_mont_batch needs one width"
        tf = TField(self.ctx.fr)
        return self._commit_scal_batch(
            torch.stack([tf.from_mont(m.contiguous()) for m in mont_list]), n)

    def _commit_scal_batch(self, scal, n):
        assert n <= len(self.srs.g1_powers), "SRS too small"
        table, inf = self.srs.device_points(self.ctx, n)
        M = scal.shape[0]
        res = self.ctx.msm_g1.msm_batch(table, inf.expand(M, n), scal, pick_window(n))
        return [self.ctx.g1_to_host(res[..., m:m + 1]) for m in range(M)]

    # -- open ------------------------------------------------------------------
    def open(self, coeffs: list, z: int):
        """(value p(z), proof [q(τ)]₁) with q = (p − p(z))/(X − z): the
        reference's synthetic division on the host, then a commit."""
        q = self.q
        z %= q
        # synthetic division, highest degree first
        quot = [0] * (len(coeffs) - 1)
        acc = 0
        for i in range(len(coeffs) - 1, 0, -1):
            acc = (acc * z + coeffs[i]) % q
            quot[i - 1] = acc
        value = (acc * z + coeffs[0]) % q
        proof = self.commit(quot) if quot else None
        return value, proof

    # -- verify (host pairing; copied from kzg.py:169-198) -----------------------
    def verify(self, commitment, z: int, value: int, proof) -> bool:
        """e(C − [v]₁ + z·π, [1]₂) · e(−π, [τ]₂) == 1."""
        g1 = self.curve.g1
        q = self.q
        # C − v·G1 + z·π
        acc = commitment
        acc = g1.add(acc, g1.scalar_mul(g1.generator, (-value) % q))
        if proof is not None:
            acc = g1.add(acc, g1.scalar_mul(proof, z % q))
        pairs = [(acc, self.srs.g2_gen)]
        if proof is not None:
            pairs.append((g1.neg(proof), self.srs.g2_tau))
        return self.curve.pairing(pairs)

    def batch_verify_same_point(self, commitments, z, values, proofs,
                                gamma: int) -> bool:
        """Fold commitments/openings at the same z with powers of gamma
        (≙ kzg.BatchVerifySinglePoint)."""
        g1 = self.curve.g1
        q = self.q
        acc_c = None
        acc_v = 0
        acc_p = None
        g = 1
        for cm, v, pf in zip(commitments, values, proofs):
            acc_c = g1.add(acc_c, g1.scalar_mul(cm, g))
            acc_v = (acc_v + g * v) % q
            acc_p = g1.add(acc_p, g1.scalar_mul(pf, g))
            g = g * gamma % q
        return self.verify(acc_c, z, acc_v, acc_p)
