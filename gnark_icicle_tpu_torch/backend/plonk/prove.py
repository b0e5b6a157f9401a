"""PLONK Prove: trace solve → commitments → permutation Z → quotient →
linearized polynomial → batched KZG opening (gnark proof shape).

Port of gnark_icicle_tpu/backend/plonk/prove.py (``prove`` :253, its device
engine). Device work, on ``device`` (None: the first CUDA card; raises
without one): the Lagrange → coefficient INTTs, the 4n coset NTTs
(``Domain.coset_ntt_nat``), the quotient (``_quotient_tables`` :84, with its
batch inversion one ``fr_batch_inv`` launch, cached per (q, n, device);
``_quotient_device`` :122 as one ``plonk_quotient`` launch over all 4n rows
and one ``coset_intt_nat``), the linear combinations (``_linear_combo_dev``
:223) and every KZG commitment (a G1 MSM). Host work, copied from the
reference with their lines named: the witness solve, the permutation
product, Fiat-Shamir, blinding and the openings' synthetic division
(``_mul_zh`` :46, ``_add_poly`` :55, ``_eval_poly`` :62,
``bind_public_data`` :69, and the stages of ``prove`` :410-688).

The reference packs the 4n arrays as uint16 and cuts the quotient into row
chunks to fit v5e memory (:128-130, :178-181, :341-347); an H100 holds them,
so neither is ported. Each stage's wall time is logged (``plonk prove:
<stage> took=``) after the device has finished it. Not ported yet, and
raising NotImplementedError: ``checkpoint_dir``, BSB22 commitments, a
``commitment_hash`` other than "sha256", ``fs_hash="mimc"`` and
``engine="host"``; the port does not read ``GNARK_TPU_BATCH_MSM``.
"""

from __future__ import annotations

import secrets
import time

import torch

from ...constraint.scs import solve_scs
from ...device import DeviceCtx
from ...logger import logger
from ...ops.field_t import QUOTIENT_INPUTS, TField
from ...ops.ntt import _pow_table
from ..kzg import KZG
from ..transcript import kzg_fold_challenge, make_transcript
from .keys import Proof, ProvingKey

CHALLENGES = (b"gamma", b"beta", b"alpha", b"zeta")


def _mul_zh(coeffs: list, n: int, q: int) -> list:
    """coeffs(X)·(Xⁿ−1) (blinding factors ride the vanishing polynomial)."""
    out = [0] * (len(coeffs) + n)
    for i, c in enumerate(coeffs):
        out[i + n] = (out[i + n] + c) % q
        out[i] = (out[i] - c) % q
    return out


def _add_poly(a: list, b: list, q: int) -> list:
    out = list(a) + [0] * max(0, len(b) - len(a))
    for i, c in enumerate(b):
        out[i] = (out[i] + c) % q
    return out


def _eval_poly(coeffs: list, z: int, q: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % q
    return acc


def bind_public_data(ts, curve, vk, public_values):
    """≙ bindPublicData (verify.go:316-347): the first challenge absorbs
    the permutation + selector commitments and the public inputs, so the
    transcript binds the circuit/verifying key."""
    for name in ("s1", "s2", "s3", "ql", "qr", "qm", "qo", "qk"):
        ts.bind_point(b"gamma", curve, vk.commitments[name])
    for i in range(len(vk.commitment_constraint_indexes)):
        ts.bind_point(b"gamma", curve, vk.commitments[f"qcp{i}"])
    for v in public_values:
        ts.bind_fr(b"gamma", v)


_DOMAIN_TABLES: dict = {}


def _quotient_tables(ctx: DeviceCtx, n: int, g: int, eta: int, q: int):
    """Device tables for the 4n coset: x-values g·ηⁱ and L1(x) as (W, 4n),
    and the period-4 cycle of 1/Z_H(x) as (W, 4) (the reference tiles it to
    4n rows; the values are the same). L1(x) = Z_H(x) / (n (x − 1)) takes
    one batch inversion (``TField.mont_inv``: one ``fr_batch_inv`` launch on
    the card, where the reference's Fermat power took 379-554 products over
    the array), so a build launches 1 ``fr_batch_inv``, 1 ``fr_sub`` and
    2·log2(4n) + 3 ``fr_mont_mul``. Cached per (q, n, device): they do not
    depend on the proof."""
    key = (q, n, ctx.device)
    if key in _DOMAIN_TABLES:
        return _DOMAIN_TABLES[key]
    F, dev = ctx.fr, ctx.device
    tf = TField(F)
    m = 4 * n
    xs = tf.mont_mul(_pow_table(tf, F.const(eta, dev), m), F.const(g, dev))
    gn = pow(g, n, q)
    etan = pow(eta, n, q)
    zh_cycle = [(gn * pow(etan, t, q) - 1) % q for t in range(4)]
    zh_inv = F.encode([pow(v, -1, q) for v in zh_cycle], dev)
    zh_vals = F.encode(zh_cycle, dev).repeat(1, n)   # row i: zh_cycle[i % 4]
    dens = tf.mont_mul(tf.sub(xs, F.ones(m, dev)), F.const(n, dev))
    l1 = tf.mont_mul(zh_vals, tf.mont_inv(dens))
    _DOMAIN_TABLES[key] = (xs, l1, zh_inv)
    return _DOMAIN_TABLES[key]


def _quotient_device(ctx: DeviceCtx, dom4, ev: dict, n, beta, gamma, alpha,
                     k1, k2, g, eta, q):
    """T's coefficients (W, 4n), Montgomery: the pointwise quotient on the
    4n coset in one ``plonk_quotient`` launch (≙ computeNumerator's loop,
    prove.go:771-1034), then one coset INTT."""
    F = ctx.fr
    xs, l1, zh_inv = _quotient_tables(ctx, n, g, eta, q)
    # on the CPU: the kernel takes them by value (the plain version there too)
    consts = F.encode([beta % q, gamma % q, alpha % q, beta * k1 % q,
                       beta * k2 % q, alpha * alpha % q, 1], "cpu")
    t_evals = TField(F).plonk_quotient([ev[k] for k in QUOTIENT_INPUTS], xs, l1,
                                       zh_inv, consts)
    return dom4.coset_intt_nat(t_evals)


def _pad(x: torch.Tensor, length: int) -> torch.Tensor:
    """(W, m) -> (W, length) with zero columns (zero is its own Montgomery
    form)."""
    if x.shape[1] >= length:
        return x
    return torch.nn.functional.pad(x, (0, length - x.shape[1])).contiguous()


def _linear_combo_dev(ctx: DeviceCtx, terms, length: int, q: int):
    """Σ sᵢ·Pᵢ on the device in Montgomery form (≙ the linearized-poly and
    batch-fold loops, prove.go:1233-1319).

    terms: (poly, scalar) with poly either a host coefficient list or a
    device (W, m) Montgomery tensor. Returns the (W, length) accumulator."""
    F = ctx.fr
    tf = TField(F)
    acc = None
    for coeffs, s in terms:
        pm = _pad(ctx.fr_mont(coeffs) if isinstance(coeffs, list) else coeffs, length)
        s = s % q
        if s != 1:
            pm = tf.mont_mul(pm, F.const(s, ctx.device))
        acc = pm if acc is None else tf.add(acc, pm)
    return acc


def prove(cs, pk: ProvingKey, public_values, secret_values, curve, rng=None,
          checkpoint_dir: str | None = None, fs_hash: str = "sha256",
          engine: str = "device", commitment_hash="sha256", device=None) -> Proof:
    """PLONK prove (≙ the reference's device engine). rng supplies the
    blinding as in the reference, so one rng gives one proof; ``device`` is
    the torch device of the run."""
    if checkpoint_dir is not None:
        raise NotImplementedError("prove checkpoints are not ported yet")
    if engine != "device":
        raise NotImplementedError(
            "only engine='device' is ported; the host engine is "
            "gnark_icicle_tpu's")
    if cs.commitments:
        raise NotImplementedError("BSB22 commitments are not ported yet")
    if commitment_hash != "sha256":
        raise NotImplementedError("only the sha256 commitment hash is ported")
    q = curve.fr.modulus
    ts = make_transcript(q, list(CHALLENGES), fs_hash)
    ctx = DeviceCtx(curve, device)  # resolves the device before any work
    rand = rng.randrange if rng is not None else (
        lambda m: secrets.randbelow(m - 1) + 1
    )
    vk = pk.vk
    assert vk is not None, "ProvingKey.vk required (rebuild keys via setup)"
    log_n = pk.log_n
    n = 1 << log_n
    omega = curve.fr.root_of_unity(log_n)
    k1, k2 = pk.k1, pk.k2
    F = ctx.fr
    tf = TField(F)
    dom = ctx.domain(log_n)
    dom4 = ctx.domain(log_n + 2, coset=True)
    kzg = KZG(curve, pk.srs, ctx.device)

    def decode(x):
        return F.decode_plain(tf.from_mont(x))

    def evals_to_coeffs(evals):
        """Lagrange evals (host ints) -> coefficient host ints; both
        Montgomery conversions on the device."""
        return decode(dom.intt(ctx.fr_mont(evals)))

    def coset4_evals_dev(coeffs):
        """host coeffs -> device Montgomery evals on the 4n coset."""
        assert len(coeffs) <= 4 * n, "degree exceeds 4n"
        return dom4.coset_ntt_nat(_pad(ctx.fr_mont(coeffs), 4 * n))

    _t = {"last": time.perf_counter()}

    def _mark(stage):
        ctx.sync()
        now = time.perf_counter()
        logger().info("plonk prove: %s took=%.3fs", stage, now - _t["last"])
        _t["last"] = now

    # ---- stage 1: solve + wire polynomials (prove.py:410-456) --------------
    wires, av, bv, cv = solve_scs(cs, public_values, secret_values)
    _mark("solve")
    av += [0] * (n - len(av))
    bv += [0] * (n - len(bv))
    cv += [0] * (n - len(cv))

    bind_public_data(ts, curve, vk, public_values)

    def blind(coeffs, degree):
        bs = [rand(q) for _ in range(degree + 1)]
        return _add_poly(coeffs, _mul_zh(bs, n, q), q)

    a_coeffs = blind(evals_to_coeffs(av), 1)
    b_coeffs = blind(evals_to_coeffs(bv), 1)
    c_coeffs = blind(evals_to_coeffs(cv), 1)
    a_com = kzg.commit(a_coeffs)
    b_com = kzg.commit(b_coeffs)
    c_com = kzg.commit(c_coeffs)
    _mark("round1 wire commits")
    for cm in (a_com, b_com, c_com):
        ts.bind_point(b"gamma", curve, cm)
    gamma = ts.challenge(b"gamma")
    beta = ts.challenge(b"beta")

    # ---- stage 2: permutation product Z (prove.py:458-509) -----------------
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % q
    tags = (1, k1, k2)
    sigma = pk.sigma

    def sigma_val(col, j):
        p = int(sigma[col * n + j])
        return tags[p // n] * omega_pows[p % n] % q

    # Z via prefix products + ONE batched inversion (Montgomery's trick)
    zv = [1] * n
    dens = [0] * (n - 1)
    pnum = [0] * (n - 1)
    run = 1
    for j in range(n - 1):
        num = (av[j] + beta * omega_pows[j] + gamma) % q
        num = num * ((bv[j] + beta * k1 * omega_pows[j] + gamma) % q) % q
        num = num * ((cv[j] + beta * k2 * omega_pows[j] + gamma) % q) % q
        den = (av[j] + beta * sigma_val(0, j) + gamma) % q
        den = den * ((bv[j] + beta * sigma_val(1, j) + gamma) % q) % q
        den = den * ((cv[j] + beta * sigma_val(2, j) + gamma) % q) % q
        dens[j] = den
        run = run * num % q
        pnum[j] = run
    if n > 1:
        run = 1
        for j in range(n - 1):
            run = run * dens[j] % q
        inv = pow(run, -1, q)  # ∏ den_j ≠ 0 for a valid witness
        for j in range(n - 2, -1, -1):
            zv[j + 1] = pnum[j] * inv % q
            inv = inv * dens[j] % q

    z_coeffs = blind(evals_to_coeffs(zv), 2)
    z_com = kzg.commit(z_coeffs)
    _mark("round2 Z")
    ts.bind_point(b"alpha", curve, z_com)
    alpha = ts.challenge(b"alpha")

    # ---- stage 3: quotient on the 4n coset (prove.py:511-593) --------------
    # full Qk (committed coefficients + public inputs in the first slots)
    qk_full = list(cs.qc) + [0] * (n - cs.nb_gates)
    for j, pv in enumerate(public_values):
        qk_full[j] = (qk_full[j] + pv) % q
    qk_full_coeffs = evals_to_coeffs(qk_full)

    # z(ωX) coefficient scaling with a running power
    zw_coeffs = []
    wp = 1
    for c in z_coeffs:
        zw_coeffs.append(c * wp % q)
        wp = wp * omega % q

    shard = n + 2
    ev = {
        "a": coset4_evals_dev(a_coeffs),
        "b": coset4_evals_dev(b_coeffs),
        "c": coset4_evals_dev(c_coeffs),
        "z": coset4_evals_dev(z_coeffs),
        "zw": coset4_evals_dev(zw_coeffs),
        "qk": coset4_evals_dev(qk_full_coeffs),
    }
    for name in ("ql", "qr", "qm", "qo", "s1", "s2", "s3"):
        ev[name] = coset4_evals_dev(pk.trace_coeffs[name])
    t_mont = _quotient_device(
        ctx, dom4, ev, n, beta, gamma, alpha, k1, k2,
        curve.fr.multiplicative_generator,
        curve.fr.root_of_unity(log_n + 2), q,
    )
    ev.clear()  # free the 4n coset evals
    t_coeffs = decode(t_mont)
    # T has degree ≤ 3n+5; split into 3 shards of n+2
    t1 = t_coeffs[:shard]
    t2 = t_coeffs[shard : 2 * shard]
    t3 = t_coeffs[2 * shard : 3 * shard]
    for c in t_coeffs[3 * shard :]:
        assert c == 0, "quotient degree overflow — identity violated"
    h_coms = (
        kzg.commit_mont(t_mont[:, :shard]),
        kzg.commit_mont(t_mont[:, shard : 2 * shard]),
        kzg.commit_mont(t_mont[:, 2 * shard : 3 * shard]),
    )
    _mark("round3 quotient")
    for cm in h_coms:
        ts.bind_point(b"zeta", curve, cm)
    zeta = ts.challenge(b"zeta")

    # ---- stage 4: linearized polynomial + openings (prove.py:595-682) ------
    l_z = _eval_poly(a_coeffs, zeta, q)
    r_z = _eval_poly(b_coeffs, zeta, q)
    o_z = _eval_poly(c_coeffs, zeta, q)
    s1_z = _eval_poly(pk.trace_coeffs["s1"], zeta, q)
    s2_z = _eval_poly(pk.trace_coeffs["s2"], zeta, q)
    zeta_w = zeta * omega % q
    zu = _eval_poly(z_coeffs, zeta_w, q)
    _, z_shifted_h = kzg.open(z_coeffs, zeta_w)

    rl = l_z * r_z % q
    cprod = (l_z + beta * s1_z + gamma) % q * (
        (r_z + beta * s2_z + gamma) % q) % q
    s1_coef = cprod * beta % q * zu % q * alpha % q
    idp = (l_z + beta * zeta + gamma) % q
    idp = idp * ((r_z + beta * k1 % q * zeta + gamma) % q) % q
    idp = idp * ((o_z + beta * k2 % q * zeta + gamma) % q) % q
    zh_z = (pow(zeta, n, q) - 1) % q
    l1_z = zh_z * pow(n * (zeta - 1) % q, -1, q) % q
    z_coef = (alpha * alpha % q * l1_z - alpha * idp) % q
    zeta_n2 = pow(zeta, n + 2, q)

    lin_terms = [
        (pk.trace_coeffs["ql"], l_z),
        (pk.trace_coeffs["qr"], r_z),
        (pk.trace_coeffs["qm"], rl),
        (pk.trace_coeffs["qo"], o_z),
        (pk.trace_coeffs["qk"], 1),
        (pk.trace_coeffs["s3"], s1_coef),
        (z_coeffs, z_coef),
        (t1, (-zh_z) % q),
        (t2, (-zh_z) * zeta_n2 % q),
        (t3, (-zh_z) * zeta_n2 % q * zeta_n2 % q),
    ]
    L = n + 4  # covers blinded z (n+3) and the n+2 shards
    lin_m = _linear_combo_dev(ctx, lin_terms, L, q)
    lin = decode(lin_m)
    lin_com = kzg.commit_mont(lin_m)
    lin_z = _eval_poly(lin, zeta, q)

    polys = [lin, a_coeffs, b_coeffs, c_coeffs,
             pk.trace_coeffs["s1"], pk.trace_coeffs["s2"]]
    digests = [lin_com, a_com, b_com, c_com,
               vk.commitments["s1"], vk.commitments["s2"]]
    claimed = [lin_z, l_z, r_z, o_z, s1_z, s2_z]

    gamma_kzg = kzg_fold_challenge(fs_hash, curve, q, zeta, digests,
                                   claimed, zu)
    gi = 1
    fold_terms = []
    for idx, p in enumerate(polys):
        fold_terms.append((lin_m if idx == 0 else p, gi))
        gi = gi * gamma_kzg % q
    folded = decode(_linear_combo_dev(ctx, fold_terms, L, q))
    _, batch_h = kzg.open(folded, zeta)

    _mark("round4 linearization+openings")
    return Proof(
        lro=(a_com, b_com, c_com), z_com=z_com, h_coms=h_coms,
        batch_h=batch_h, batch_claimed=claimed,
        z_shifted_h=z_shifted_h, z_shifted_claimed=zu,
        bsb22_commitments=[],
    )
