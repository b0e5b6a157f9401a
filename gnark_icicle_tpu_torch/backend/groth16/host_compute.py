"""Device-free Groth16 prover arithmetic (host NTT + host MSM).

Role parity: the reference's pure-CPU prover path (backend/groth16/bn254/
prove.go computeH + the gnark-crypto MultiExp it falls back to when no
accelerator is configured) — the TPU kernels replace this for production
sizes, but small systems (and accelerator-less environments) want a path
with zero compile/dispatch overhead. Selected with
``groth16.prove(..., engine="host")``; bit-compatible with the device
path (same proofs verify, same checkpoint formats not used).

Copied from gnark_icicle_tpu/backend/groth16/host_compute.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_host_engine.py holds it to the original.
"""

from __future__ import annotations


def _bitrev(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


def ntt_host(vals: list, q: int, root: int) -> list:
    """Iterative radix-2 Cooley-Tukey DIT: natural in, natural out."""
    n = len(vals)
    bits = n.bit_length() - 1
    a = [vals[_bitrev(i, bits)] for i in range(n)]
    length = 2
    while length <= n:
        w_step = pow(root, n // length, q)
        half = length // 2
        for start in range(0, n, length):
            w = 1
            for j in range(start, start + half):
                u = a[j]
                v = a[j + half] * w % q
                a[j] = (u + v) % q
                a[j + half] = (u - v) % q
                w = w * w_step % q
        length <<= 1
    return a


def compute_h_host(a: list, b: list, c: list, log_n: int, fr) -> list:
    """(A·B − C)/Z coefficients in NATURAL order (≙ computeH,
    prove.go:356-399, entirely in host big-int arithmetic)."""
    q = fr.modulus
    n = 1 << log_n
    w = fr.root_of_unity(log_n)
    w_inv = pow(w, -1, q)
    n_inv = pow(n, -1, q)

    def pad(v):
        return [int(x) % q for x in v] + [0] * (n - len(v))

    def intt(evals):
        return [x * n_inv % q for x in ntt_host(evals, q, w_inv)]

    ca, cb, cc = intt(pad(a)), intt(pad(b)), intt(pad(c))
    g = fr.multiplicative_generator

    def coset_eval(coeffs):
        gi = 1
        scaled = []
        for x in coeffs:
            scaled.append(x * gi % q)
            gi = gi * g % q
        return ntt_host(scaled, q, w)

    ea, eb, ec = coset_eval(ca), coset_eval(cb), coset_eval(cc)
    den = pow((pow(g, n, q) - 1) % q, -1, q)
    h_ev = [(x * y - z) * den % q for x, y, z in zip(ea, eb, ec)]
    hc = intt(h_ev)
    g_inv = pow(g, -1, q)
    gi = 1
    out = []
    for x in hc:
        out.append(x * gi % q)
        gi = gi * g_inv % q
    return out


def msm_host(group, points: list, scalars) -> tuple | None:
    """Σ sᵢ·Pᵢ by host scalar-mul (skips zero scalars and infinity points;
    returns None for the identity — matching the device path's g1_to_host
    infinity convention)."""
    acc = None
    for pt, s in zip(points, scalars):
        if pt is None:
            continue
        s = int(s) % group.order if hasattr(group, "order") else int(s)
        if s == 0:
            continue
        term = group.scalar_mul(pt, s)
        acc = term if acc is None else group.add(acc, term)
    return acc


def z_scalars_bitreversed(h: list, log_n: int, count: int) -> list:
    """Scalars aligned with pk.g1_z's BIT-REVERSED point order
    (keys.py:31-34): point i holds τ^rev(i), so it pairs with the natural
    coefficient h[rev(i)]."""
    return [h[_bitrev(i, log_n)] for i in range(count)]
