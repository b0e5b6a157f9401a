"""Groth16 Prove: witness solve (host), computeH and the MSMs (device),
blinding and assembly (host).

Port of gnark_icicle_tpu/backend/groth16/prove.py (``prove`` :187, the
device phase :371-555, ``_compute_h`` :31-90) with ``_assemble_proof``
(:558-589) copied. Flow:

  solve (host, native)  →  computeH (3 INTT → 3 coset NTT → coset INTT of
  (a·b−c)·den, the pointwise on its first pass → from Montgomery; h stays on
  the device, bit-reversed)  →
  MSMs A, B1, K, Z over G1 and B2 over G2  →  r, s blinding (host).

Each phase's wall time is logged (the port's ``logger``) after the device
has finished it. Not ported yet: BSB22 commitments, checkpoints, a
device mesh and the host engine; asking for one raises NotImplementedError.
"""

from __future__ import annotations

import secrets
import time

import numpy as np

from ...constraint.solver import solve, solved_u32
from ...device import DeviceCtx
from ...logger import logger
from ...ops.field_t import TField
from ...ops.msm import pick_window
from .keys import Proof, ProvingKey


def _compute_h(ctx: DeviceCtx, a, b, c, log_n: int):
    """(a·b−c)/Z as plain-form (Wr, n) scalars in bit-reversed order.

    a, b, c: (N, Wr) uint32 plain-form limbs, N ≤ n. On the coset g·<ω>,
    Z(g·ωⁱ) = gⁿ−1 is constant, so one product by a scalar replaces the
    reference's ``den`` vector."""
    q = ctx.curve.fr.modulus
    n = 1 << log_n
    tf = TField(ctx.fr)
    dom = ctx.domain(log_n, coset=True)

    def pad_mont(v):
        v = np.pad(v, [(0, n - v.shape[0]), (0, 0)])
        return tf.to_mont(ctx.fr_scalars(v))

    ea, eb, ec = pad_mont(a), pad_mont(b), pad_mont(c)
    g = ctx.curve.fr.multiplicative_generator
    den = ctx.fr.const(pow((pow(g, n, q) - 1) % q, -1, q), ctx.device)

    def to_coset(e):
        return dom.coset_ntt_rev_in(dom.intt_nat_to_rev(e))

    ca, cb, cc = to_coset(ea), to_coset(eb), to_coset(ec)
    # (a·b − c)·den on the first pass of the coset INTT; Montgomery,
    # bit-reversed
    h_rev = dom.coset_intt_nat_to_rev_pointwise(ca, cb, cc, den)
    return tf.from_mont(h_rev)                   # plain = MSM scalar format


def prove(cs, pk: ProvingKey, public_values, secret_values, curve,
          rng=None, checkpoint_dir: str | None = None,
          engine: str = "device", mesh=None,
          commitment_hash="sha256", device=None) -> Proof:
    """Generate a Groth16 proof (≙ groth16.Prove, accelerated path).

    The arguments are the reference's (``commitment_hash`` is read only by
    the commitment path, not ported yet); ``device`` is the torch device of
    the run (default: the first CUDA card; raises without one). rng supplies the
    blinding r, s exactly as in the reference, so one rng gives one proof.
    """
    if checkpoint_dir is not None:
        raise NotImplementedError("prove checkpoints are not ported yet")
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet")
    if engine != "device":
        raise NotImplementedError(
            "only engine='device' is ported; the host engine is "
            "gnark_icicle_tpu's")
    if cs.commitments:
        raise NotImplementedError("BSB22 commitments are not ported yet")
    log = logger()
    t_start = time.perf_counter()
    q = curve.fr.modulus
    ctx = DeviceCtx(curve, device)
    rand = rng.randrange if rng is not None else (
        lambda m: secrets.randbelow(m - 1) + 1
    )

    res = solve(cs, public_values, secret_values)
    t_solved = time.perf_counter()
    log.info("groth16 prove: solve took=%.3fs", t_solved - t_start)

    log_n = pk.domain_log_n
    W = ctx.fr.n32
    h = _compute_h(ctx, solved_u32(res, "a", W), solved_u32(res, "b", W),
                   solved_u32(res, "c", W), log_n)
    ctx.sync()
    t_h = time.perf_counter()
    log.info("groth16 prove: computeH took=%.3fs", t_h - t_solved)

    dev = pk.device_arrays(ctx)
    t_pk = time.perf_counter()
    log.info("groth16 prove: pk staging took=%.3fs", t_pk - t_h)
    wires = ctx.fr_scalars(solved_u32(res, "wires", W))
    priv = wires[:, cs.nb_public:].contiguous()

    def msm(kern, pts, scal):
        table, inf = pts
        return kern.msm(table, inf, scal, pick_window(scal.shape[1]))

    ar_dev = msm(ctx.msm_g1, dev["a"], wires)
    bs1_dev = msm(ctx.msm_g1, dev["b1"], wires)
    bs2_dev = msm(ctx.msm_g2, dev["b2"], wires)
    krs_parts = []
    if priv.shape[1] > 0:
        krs_parts.append(msm(ctx.msm_g1, dev["k"], priv))
    krs_parts.append(msm(ctx.msm_g1, dev["z"], h))
    ar_msm, bs1_msm = ctx.g1_to_host(ar_dev), ctx.g1_to_host(bs1_dev)
    bs2_msm = ctx.g2_to_host(bs2_dev)
    krs_msm = [ctx.g1_to_host(p) for p in krs_parts]
    log.info("groth16 prove: msms took=%.3fs", time.perf_counter() - t_pk)

    return _assemble_proof(
        cs, pk, curve, q, rand, ar_msm, bs1_msm, bs2_msm, krs_msm,
        [], None, logger, t_start, str(ctx.device),
    )


def _assemble_proof(cs, pk, curve, q, rand, ar_msm, bs1_msm, bs2_msm,
                    krs_msm, commitment_pts, commitment_pok, logger,
                    t_start, backend_name):
    """Blinding + final point assembly on the host (toxic randomness r, s
    never leaves the host). Copied from
    gnark_icicle_tpu/backend/groth16/prove.py:558."""
    import time

    g1, g2 = curve.g1, curve.g2
    r = rand(q)
    s = rand(q)

    # Ar = α + Σw·A + r·δ
    ar = g1.add(g1.add(pk.g1_alpha, ar_msm), g1.scalar_mul(pk.g1_delta, r))
    # Bs (G2) = β + Σw·B + s·δ
    bs = g2.add(g2.add(pk.g2_beta, bs2_msm), g2.scalar_mul(pk.g2_delta, s))
    # Bs1 (G1 shadow of Bs) for Krs
    bs1 = g1.add(g1.add(pk.g1_beta, bs1_msm), g1.scalar_mul(pk.g1_delta, s))
    # Krs = Σ_priv w·K + h·Z + s·Ar + r·Bs1 − r·s·δ
    krs = None
    for p in krs_msm:
        krs = g1.add(krs, p)
    krs = g1.add(krs, g1.scalar_mul(ar, s))
    krs = g1.add(krs, g1.scalar_mul(bs1, r))
    krs = g1.add(krs, g1.scalar_mul(pk.g1_delta, (-r * s) % q))

    logger().info(
        "groth16 prove: curve=%s constraints=%d took=%.3fs (acceleration=%s)",
        curve.name, cs.nb_constraints, time.perf_counter() - t_start,
        backend_name,
    )
    return Proof(ar=ar, krs=krs, bs=bs, commitments=commitment_pts,
                 commitment_pok=commitment_pok)
