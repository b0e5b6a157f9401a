"""Device-free PLONK prover arithmetic (host NTT, quotient, KZG).

Role parity: the reference's pure-CPU PLONK prover (backend/plonk/bn254/
prove.go computeNumerator and gnark-crypto kzg.Commit) — selected with
``plonk.prove(..., engine="host")`` for small systems and
accelerator-less environments. Mirrors the device path's math
point-for-point (same transcripts, same proof bytes for the same
randomness).

Copied from gnark_icicle_tpu/backend/plonk/host_engine.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_host_engine.py holds it to the original.
"""

from __future__ import annotations

from ..groth16.host_compute import msm_host, ntt_host


def intt_host(evals: list, log_n: int, fr) -> list:
    q = fr.modulus
    n = 1 << log_n
    w_inv = pow(fr.root_of_unity(log_n), -1, q)
    n_inv = pow(n, -1, q)
    vals = [int(x) % q for x in evals] + [0] * (n - len(evals))
    return [x * n_inv % q for x in ntt_host(vals, q, w_inv)]


def coset_ntt_host(coeffs: list, log_m: int, fr, shift: int) -> list:
    """Evaluations of the polynomial on the coset shift·<η>, m = 2^log_m."""
    q = fr.modulus
    m = 1 << log_m
    eta = fr.root_of_unity(log_m)
    padded = [int(x) % q for x in coeffs] + [0] * (m - len(coeffs))
    assert len(padded) == m, "degree exceeds the evaluation domain"
    gi = 1
    scaled = []
    for x in padded:
        scaled.append(x * gi % q)
        gi = gi * shift % q
    return ntt_host(scaled, q, eta)


def coset_intt_host(evals: list, log_m: int, fr, shift: int) -> list:
    q = fr.modulus
    coeffs = intt_host(evals, log_m, fr)
    s_inv = pow(shift, -1, q)
    gi = 1
    out = []
    for x in coeffs:
        out.append(x * gi % q)
        gi = gi * s_inv % q
    return out


def quotient_host(ev: dict, n: int, beta, gamma, alpha, k1, k2, fr) -> list:
    """T coefficients from 4n-coset evaluations — the host port of
    _quotient_device's pointwise pass (≙ computeNumerator,
    prove.go:771-1034)."""
    q = fr.modulus
    g = fr.multiplicative_generator
    log4 = (4 * n).bit_length() - 1
    eta = fr.root_of_unity(log4)
    m = 4 * n

    xs = []
    x = g % q
    for _ in range(m):
        xs.append(x)
        x = x * eta % q
    gn = pow(g, n, q)
    etan = pow(eta, n, q)
    zh_inv_cycle = [pow((gn * pow(etan, t, q) - 1) % q, -1, q)
                    for t in range(4)]
    t_evals = []
    bk1, bk2 = beta * k1 % q, beta * k2 % q
    alpha2 = alpha * alpha % q
    n_qcp = 0
    while f"qcp{n_qcp}" in ev:
        n_qcp += 1
    for i in range(m):
        A, B, C = ev["a"][i], ev["b"][i], ev["c"][i]
        gate = (ev["ql"][i] * A + ev["qr"][i] * B
                + ev["qm"][i] * A % q * B + ev["qo"][i] * C
                + ev["qk"][i]) % q
        for j in range(n_qcp):
            gate = (gate + ev[f"qcp{j}"][i] * ev[f"pi2_{j}"][i]) % q
        xi = xs[i]
        lhs = (A + beta * xi + gamma) % q
        lhs = lhs * ((B + bk1 * xi + gamma) % q) % q
        lhs = lhs * ((C + bk2 * xi + gamma) % q) % q
        lhs = lhs * ev["z"][i] % q
        rhs = (A + beta * ev["s1"][i] + gamma) % q
        rhs = rhs * ((B + beta * ev["s2"][i] + gamma) % q) % q
        rhs = rhs * ((C + beta * ev["s3"][i] + gamma) % q) % q
        rhs = rhs * ev["zw"][i] % q
        perm = (rhs - lhs) % q
        # L1(x) = Z_H(x)/(n(x−1)); Z_H on the coset cycles with period 4
        zh = (gn * pow(etan, i % 4, q) - 1) % q
        l1 = zh * pow(n * (xi - 1) % q, -1, q) % q
        start = l1 * ((ev["z"][i] - 1) % q) % q
        num = (gate + alpha * perm + alpha2 * start) % q
        t_evals.append(num * zh_inv_cycle[i % 4] % q)
    return coset_intt_host(t_evals, log4, fr, g)


class HostKZG:
    """KZG commit/open over host point arithmetic (≙ gnark-crypto
    kzg.Commit without the accelerator; same SRS object as backend.KZG)."""

    def __init__(self, curve, srs):
        self.curve = curve
        self.srs = srs
        self.q = curve.fr.modulus

    def commit(self, coeffs: list):
        if not coeffs:
            return None
        assert len(coeffs) <= len(self.srs.g1_powers), "SRS too small"
        return msm_host(self.curve.g1, self.srs.g1_powers, coeffs)

    def open(self, coeffs: list, z: int):
        q = self.q
        z %= q
        quot = [0] * (len(coeffs) - 1)
        acc = 0
        for i in range(len(coeffs) - 1, 0, -1):
            acc = (acc * z + coeffs[i]) % q
            quot[i - 1] = acc
        value = (acc * z + coeffs[0]) % q
        proof = self.commit(quot) if quot else None
        return value, proof
