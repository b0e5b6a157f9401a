"""PLONK Setup: trace construction (host), the permutation, and the trace
polynomials' INTTs and KZG commitments (device).

Port of gnark_icicle_tpu/backend/plonk/setup.py (``setup`` :59, its device
branch :121-128) with ``build_permutation`` (:24) and ``_next_pow2_log``
(:20) copied. The rng is drawn as in the reference (τ of the unsafe SRS
first, ``kzg.unsafe_srs``), so one rng gives the reference's keys. The SRS
powers run on the fixed-base ladder, each column's INTT on the NTT stage
kernel and each commitment on the G1 MSM of ``device`` (None: the first
CUDA card; raises without one). A circuit's BSB22 commitments add one Qcp
column each (:89-95), committed as the others are. ``engine="host"`` is the
reference's host branch (:112-120, ``host_engine.py``): the SRS, the INTTs
and the commitments in host big-int arithmetic, with no device.
"""

from __future__ import annotations

import time

import numpy as np

from ...device import DeviceCtx
from ...logger import logger
from ...ops.field_t import TField
from ..kzg import KZG, SRS, unsafe_srs
from .host_engine import HostKZG, intt_host
from .keys import ProvingKey, VerifyingKey


def _next_pow2_log(n: int) -> int:
    # copied from gnark_icicle_tpu/backend/plonk/setup.py:20
    return max((n - 1).bit_length(), 1)


def build_permutation(cs, n: int):
    """σ over 3n slot positions (≙ buildPermutation, setup.go:271).
    Copied from gnark_icicle_tpu/backend/plonk/setup.py:24.

    Positions j / n+j / 2n+j hold gate j's a/b/c wires; padding gates
    (j ≥ nb_gates) reference a dummy wire each so σ fixes them.
    """
    m = cs.nb_gates
    nw = cs.nb_wires
    # wire id per position; padding positions get unique pseudo-wires
    pos_wire = np.full(3 * n, -1, dtype=np.int64)
    pos_wire[:m] = cs.xa
    pos_wire[n : n + m] = cs.xb
    pos_wire[2 * n : 2 * n + m] = cs.xc
    nxt = nw
    for i in range(3 * n):
        if pos_wire[i] < 0:
            pos_wire[i] = nxt
            nxt += 1

    # cycle per wire: σ(p) = next position with the same wire
    first = {}
    last = {}
    sigma = np.arange(3 * n, dtype=np.int64)
    for p in range(3 * n):
        w = int(pos_wire[p])
        if w in last:
            sigma[last[w]] = p
        else:
            first[w] = p
        last[w] = p
    for w, f in first.items():
        sigma[last[w]] = f  # close the cycle
    return sigma


def setup(cs, curve, srs: SRS | None = None, rng=None,
          k1: int | None = None, k2: int | None = None,
          engine: str = "device", device=None):
    """(ProvingKey, VerifyingKey). srs defaults to an unsafe test SRS
    (≙ plonk.Setup(ccs, srs, srsLagrange) with test/unsafekzg). The log
    line ``plonk setup:`` gives the SRS, host and commit seconds.
    engine: "device" (the kernels on ``device``) or "host" (no device;
    ``device`` is not read). The keys are the same under one rng."""
    if engine not in ("device", "host"):
        raise ValueError(f"engine must be 'device' or 'host', not {engine!r}")
    # resolves the device before any work
    ctx = DeviceCtx(curve, device) if engine == "device" else None
    t0 = time.perf_counter()
    q = curve.fr.modulus
    assert cs.q == q
    log_n = max(_next_pow2_log(max(cs.nb_gates, 2)), 3)  # quotient shards need n >= 8
    n = 1 << log_n
    if srs is None:
        srs = (unsafe_srs(curve, n + 5, rng=rng, device=ctx.device) if ctx is not None
               else unsafe_srs(curve, n + 5, rng=rng, engine="host"))
    t_srs = time.perf_counter()
    # coset shifts: gnark uses 5 (the fr generator) per vanilla-PLONK; any
    # pair with H, k1H, k2H pairwise disjoint works
    g = curve.fr.multiplicative_generator
    k1 = k1 if k1 is not None else g
    k2 = k2 if k2 is not None else g * g % q

    omega = curve.fr.root_of_unity(log_n)
    sigma = build_permutation(cs, n)

    # selector columns, padded to n (public gates keep their committed
    # coefficients; runtime Qk adds public inputs on top — prove.py)
    def pad(col):
        return [c % q for c in col] + [0] * (n - len(col))

    cols = {
        "ql": pad(cs.ql), "qr": pad(cs.qr), "qm": pad(cs.qm),
        "qo": pad(cs.qo), "qk": pad(cs.qc),
    }
    # BSB22 Qcp columns: 1 at each COMMITTED row (≙ setup.go:193-201)
    for i, cinfo in enumerate(cs.commitments):
        col = [0] * n
        for gi in cinfo.committed:
            col[gi] = 1
        cols[f"qcp{i}"] = col

    # σ columns as field elements: position p -> coset tag · ω^(p mod n)
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % q
    tags = (1, k1, k2)

    def pos_value(p: int) -> int:
        return tags[p // n] * omega_pows[p % n] % q

    for col_idx, name in enumerate(("s1", "s2", "s3")):
        cols[name] = [
            pos_value(int(sigma[col_idx * n + j])) for j in range(n)
        ]
    t_host = time.perf_counter()

    # Lagrange -> coefficients (INTT on the card), then KZG commitments
    trace_coeffs = {}
    commitments = {}
    if ctx is None:
        kzg = HostKZG(curve, srs)

        def intt(evals):
            return intt_host(evals, log_n, curve.fr)
    else:
        dom = ctx.domain(log_n)
        tf = TField(ctx.fr)
        kzg = KZG(curve, srs, ctx.device)

        def intt(evals):
            return ctx.fr.decode_plain(tf.from_mont(dom.intt(ctx.fr_mont(evals))))
    for name, evals in cols.items():
        coeffs = intt(evals)
        trace_coeffs[name] = coeffs
        commitments[name] = kzg.commit(coeffs)
    if ctx is not None:
        ctx.sync()
    logger().info("plonk setup: srs took=%.3fs, host took=%.3fs, commits took=%.3fs",
                  t_srs - t0, t_host - t_srs, time.perf_counter() - t_host)

    pk = ProvingKey(
        trace_coeffs=trace_coeffs, log_n=log_n, k1=k1, k2=k2, srs=srs,
        sigma=sigma,
    )
    vk = VerifyingKey(
        commitments=commitments, log_n=log_n, k1=k1, k2=k2,
        nb_public=cs.nb_public, g2_gen=srs.g2_gen, g2_tau=srs.g2_tau,
        omega=omega,
        commitment_constraint_indexes=[
            c.commitment_index for c in cs.commitments
        ],  # ≙ vk.CommitmentConstraintIndexes (setup.go:93)
    )
    pk.vk = vk  # ≙ pk.Vk — prove's bindPublicData needs the commitments
    return pk, vk
