"""Groth16 Setup: toxic waste, QAP evaluation (host) and the key's batch
scalar multiplications (device).

Port of gnark_icicle_tpu/backend/groth16/setup.py (``qap_evaluations`` :25,
``setup`` :75, ``dummy_setup`` :231; its ``_batch_inv`` :62 is the one in ``ops/ec.py``). The host
algebra is copied unchanged, as is the order in which the rng is drawn, so
that the same rng gives the same keys as the reference. The batch scalar multiplications run on the
fixed-base ladder (``ops/fixed_base.py``); all the G1 products of the proving
key (A, B, K, Z and the BSB22 Pedersen bases, :99-113 and :173-226) share
one ladder run. ``curve`` is one of the port's curves (BN254,
BLS12-381, BLS12-377, BW6-761); the scalar bits, the ladders and the key's
points follow it, and BW6-761's G2 points keep their Fp coordinates.
``engine="host"`` runs every scalar multiplication on the host (the
reference's :154-168) and touches no device; it is the one engine of
BLS24-315, whose G2 over Fp4 no kernel covers.
"""

from __future__ import annotations

import secrets
import time

from ...curves.tower import Fp2
from ...device import DeviceCtx
from ...logger import logger
from ...ops.ec import _batch_inv
from ...ops.fixed_base import batch_scalar_mul_host
from ...ops.ntt import bitrev_indices
from ..pedersen import PedersenProvingKey, PedersenVerifyingKey
from .keys import ProvingKey, VerifyingKey


def _next_pow2_log(n: int) -> int:
    # copied from gnark_icicle_tpu/backend/groth16/setup.py:20
    return max((n - 1).bit_length(), 1)


def qap_evaluations(cs, tau: int, n: int, omega: int):
    """Per-wire QAP polynomial evaluations A_k(τ), B_k(τ), C_k(τ).

    Copied from gnark_icicle_tpu/backend/groth16/setup.py:25. Lagrange
    kernel L_j(τ) = (τⁿ−1)·ω^j / (n·(τ−ω^j)); then one sweep over the
    constraint terms accumulating coeff·L_j into the term's wire slot.
    """
    q = cs.q
    z_tau = (pow(tau, n, q) - 1) % q
    omega_pows = [1] * n
    for j in range(1, n):
        omega_pows[j] = omega_pows[j - 1] * omega % q
    dens = [n * (tau - w) % q for w in omega_pows]
    if any(d == 0 for d in dens):
        raise ValueError("tau collides with the domain; resample")
    inv_dens = _batch_inv(dens, q)
    lag = [z_tau * omega_pows[j] % q * inv_dens[j] % q for j in range(n)]

    nw = cs.nb_wires
    A = [0] * nw
    B = [0] * nw
    C = [0] * nw
    coeffs = cs.coeffs
    tc, tw = cs.term_coeff, cs.term_wire
    for j in range(cs.nb_constraints):
        lj = lag[j]
        (ls, le), (rs, re), (os_, oe) = cs.constraint_slots(j)
        for t in range(ls, le):
            A[tw[t]] = (A[tw[t]] + coeffs[tc[t]] * lj) % q
        for t in range(rs, re):
            B[tw[t]] = (B[tw[t]] + coeffs[tc[t]] * lj) % q
        for t in range(os_, oe):
            C[tw[t]] = (C[tw[t]] + coeffs[tc[t]] * lj) % q
    return A, B, C, z_tau


def _bit_reverse_list(points, n: int):
    """Copied from gnark_icicle_tpu/backend/groth16/setup.py:262: place the
    length n-1 list at the prefix of the size-n bit-reversal, out[j] =
    points[rev(j)], None in the missing top slot."""
    rev = bitrev_indices(n)
    return [points[int(rev[j])] if int(rev[j]) < len(points) else None
            for j in range(n)]


def setup(cs, curve, rng=None, engine: str = "auto", device=None):
    """(ProvingKey, VerifyingKey) for a compiled R1CS (≙ groth16.Setup).

    Batches of 256 or more scalars run on the fixed-base ladder of
    ``device`` (default: the first CUDA card; raises without one), smaller
    ones as host scalar multiplications, as in the reference. ``engine``:
    "auto" or "device" as just said; "host" makes every batch host scalar
    multiplications and builds no device context (``device`` is not read).
    The keys are the same under one rng."""
    if engine not in ("auto", "device", "host"):
        raise ValueError(f"engine must be 'auto', 'device' or 'host', not {engine!r}")
    q = curve.fr.modulus
    assert q == cs.q, "constraint system field != curve scalar field"
    rand = rng.randrange if rng is not None else (
        lambda n: secrets.randbelow(n - 1) + 1
    )
    # resolves the device before any work
    ctx = DeviceCtx(curve, device) if engine != "host" else None
    t0 = time.perf_counter()

    log_n = _next_pow2_log(max(cs.nb_constraints, 2))
    n = 1 << log_n
    omega = curve.fr.root_of_unity(log_n)

    tau = rand(q)
    alpha = rand(q)
    beta = rand(q)
    gamma = rand(q)
    delta = rand(q)

    A, B, C, z_tau = qap_evaluations(cs, tau, n, omega)
    inv_gamma = pow(gamma, -1, q)
    inv_delta = pow(delta, -1, q)
    # K-scalar partitioning (≙ setup.go:143-196): public wires AND
    # commitment wires go to vk.K (γ-scaled — the verifier injects their
    # values), committed private wires become the per-commitment Pedersen
    # bases (also γ-scaled), everything else is pk.K (δ-scaled).
    nb_pub = cs.nb_public
    commitment_wires = [c.commitment_index for c in cs.commitments]
    private_committed = [list(c.private_committed) for c in cs.commitments]
    committed_set = set(commitment_wires)
    for pc in private_committed:
        committed_set.update(pc)

    def k_scalar(k, inv):
        return (beta * A[k] + alpha * B[k] + C[k]) * inv % q

    vk_k_scalars = [k_scalar(k, inv_gamma) for k in range(nb_pub)]
    vk_k_scalars += [k_scalar(w, inv_gamma) for w in commitment_wires]
    ck_k_scalars = [[k_scalar(w, inv_gamma) for w in pc] for pc in private_committed]
    pk_k_scalars = [k_scalar(k, inv_delta) for k in range(nb_pub, cs.nb_wires)
                    if k not in committed_set]
    # the Pedersen keys' randomness, drawn as the reference draws it
    # (setup.py:150-163): the shared G2 point's scalar, then one σ a commitment
    c_g2_scalar = rand(q) if cs.commitments else None
    sigmas = [rand(q) for _ in cs.commitments]
    ck_sigma_scalars = [[s * sigma % q for s in sc] for sc, sigma in zip(ck_k_scalars, sigmas)]
    # Z points: τ^i·Z(τ)/δ for i < n-1 — stored bit-reversed
    zd = z_tau * inv_delta % q
    z_scalars = [0] * (n - 1)
    acc = zd
    for i in range(n - 1):
        z_scalars[i] = acc
        acc = acc * tau % q
    t_host = time.perf_counter()

    g1, g2 = curve.g1, curve.g2
    G1, G2 = g1.generator, g2.generator
    bits = q.bit_length()

    split: dict = {}   # the device batches' parts (batch_scalar_mul_host)

    def batch(group: str, scalars):
        grp = getattr(curve, group)
        if ctx is None or len(scalars) < 256:
            return [grp.scalar_mul(grp.generator, s) for s in scalars]
        return batch_scalar_mul_host(getattr(ctx, group), grp, grp.generator, scalars, bits,
                                     ctx.device, times=split)

    # one G1 batch: A, B, K, Z and the Pedersen bases (plain and σ-scaled)
    parts = [A, B, pk_k_scalars, z_scalars] + ck_k_scalars + ck_sigma_scalars
    g1_all = batch("g1", [s for part in parts for s in part])
    cut = [0]
    for part in parts:
        cut.append(cut[-1] + len(part))
    g1_parts = [g1_all[cut[i]:cut[i + 1]] for i in range(len(parts))]
    g1_a, g1_b, g1_k, g1_z = g1_parts[:4]
    nc = len(cs.commitments)
    ck_pks = [PedersenProvingKey(basis=g1_parts[4 + i], basis_exp_sigma=g1_parts[4 + nc + i])
              for i in range(nc)]
    ck_vks = []
    if cs.commitments:
        c_g2 = g2.scalar_mul(G2, c_g2_scalar)   # ≙ curve.RandomOnG2 (setup.go:293)
        ck_vks = [PedersenVerifyingKey(g=c_g2, g_sigma_neg=g2.scalar_mul(c_g2, (q - sigma) % q))
                  for sigma in sigmas]
    # verifier-side committed-wire indices into the extended public witness
    # (≙ GetPublicAndCommitmentCommitted, constraint/commitment.go:53-74)
    cw_pos = {w: i for i, w in enumerate(commitment_wires)}
    pub_and_com_committed = [
        [w if w < nb_pub else nb_pub + cw_pos[w] for w in c.public_and_commitment_committed]
        for c in cs.commitments
    ]
    g2_b = batch("g2", B)
    t_keys = time.perf_counter()

    pk = ProvingKey(
        g1_alpha=g1.scalar_mul(G1, alpha),
        g1_beta=g1.scalar_mul(G1, beta),
        g1_delta=g1.scalar_mul(G1, delta),
        g2_beta=g2.scalar_mul(G2, beta),
        g2_delta=g2.scalar_mul(G2, delta),
        g1_a=g1_a,
        g1_b=g1_b,
        g2_b=[_fp2_point(curve, p) for p in g2_b] if ctx is not None else g2_b,
        g1_k=g1_k,
        g1_z=_bit_reverse_list(g1_z, n),
        domain_log_n=log_n,
        commitment_keys=ck_pks,
    )
    vk = VerifyingKey(
        g1_alpha=pk.g1_alpha,
        g2_beta=pk.g2_beta,
        g2_gamma=g2.scalar_mul(G2, gamma),
        g2_delta=pk.g2_delta,
        g1_k=batch("g1", vk_k_scalars),
        nb_public=nb_pub,
        commitment_keys=ck_vks,
        public_and_commitment_committed=pub_and_com_committed,
    )
    parts = {"host algebra": t_host - t0, "points": time.perf_counter() - t_host, **split,
             "keys": time.perf_counter() - t_keys}
    logger().info("groth16 setup: %s", ", ".join(f"{k} took={v:.3f}s" for k, v in parts.items()))
    return pk, vk


def dummy_setup(cs, curve) -> ProvingKey:
    """A proving key without a ceremony, for prove latency (≙
    groth16.DummySetup, setup.go:494): every point is 42·G, so its proofs do
    not verify. Copied from gnark_icicle_tpu/backend/groth16/setup.py:231; it
    runs on the host and needs no device."""
    log_n = _next_pow2_log(max(cs.nb_constraints, 2))
    n = 1 << log_n
    g1, g2 = curve.g1, curve.g2
    p1 = g1.scalar_mul(g1.generator, 42)
    p2 = g2.scalar_mul(g2.generator, 42)
    nw = cs.nb_wires
    nb_committed = sum(1 + len(c.private_committed) for c in cs.commitments)
    return ProvingKey(
        g1_alpha=p1, g1_beta=p1, g1_delta=p1, g2_beta=p2, g2_delta=p2,
        g1_a=[p1] * nw, g1_b=[p1] * nw, g2_b=[p2] * nw,
        g1_k=[p1] * (nw - cs.nb_public - nb_committed),
        g1_z=[p1] * (n - 1) + [None],
        domain_log_n=log_n,
        commitment_keys=[
            PedersenProvingKey(basis=[p1] * len(c.private_committed),
                               basis_exp_sigma=[p1] * len(c.private_committed))
            for c in cs.commitments
        ],
    )


def _fp2_point(curve, p):
    """A ladder result ((x0, x1), (y0, y1)) as host Fp2 coordinates; a point
    of a G2 over Fp (BW6-761: int coordinates) as it is."""
    if p is None or hasattr(p[0], "c0") or isinstance(p[0], int):
        return p
    tp = curve.tower
    return (Fp2(tp, *p[0]), Fp2(tp, *p[1]))
