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
so neither is ported. BSB22 commitments (the PI2 polynomial committed by
KZG in the placeholder hint's override :350-400, α binding them :506, the
Qk injection :516-, the Qcp terms in the quotient and the linearization),
``commitment_hash`` "sha256" or ("mimc", m), ``fs_hash="mimc"``,
checkpoints (stages solve, round1, round2, quotient) and the batched commits
(:441-446, :578-581, the keyword ``batch_msm``; the JAX package reads
``GNARK_TPU_BATCH_MSM``) are the reference's. Each stage's wall time is
logged (``plonk prove: <stage> took=``) after the device has finished it.
Not ported yet, and raising NotImplementedError: ``engine="host"``.
"""

from __future__ import annotations

import hashlib
import secrets
import time

import torch

from ...constraint import hints as hintlib
from ...constraint.scs import solve_scs
from ...device import DeviceCtx
from ...io.serialize import g1_to_bytes
from ...logger import logger
from ...ops.field_t import QUOTIENT_INPUTS, TField
from ...ops.ntt import _pow_table
from ..groth16.prove import _Checkpoint
from ..hash_to_field import hash_to_fr, mimc_commitment_hash
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


def _binding(cs, pk, q, fs_hash, commitment_hash, public_values, secret_values) -> bytes:
    """The checkpoint's task binding, the reference's bytes (prove.py:286-299;
    a value wider than 32 bytes, BW6-761's r, takes its Fr width)."""
    nb = max(32, (q.bit_length() + 7) // 8)
    return hashlib.sha256(
        b"plonkck" + cs.nb_gates.to_bytes(8, "big")
        + pk.log_n.to_bytes(2, "big")
        + fs_hash.encode() + repr(commitment_hash).encode()
        + b"".join(int(v).to_bytes(nb, "big") for v in public_values)
        + b"|sec|"
        + b"".join(int(v % q).to_bytes(nb, "big") for v in secret_values)
    ).digest()


def prove(cs, pk: ProvingKey, public_values, secret_values, curve, rng=None,
          checkpoint_dir: str | None = None, fs_hash: str = "sha256",
          engine: str = "device", commitment_hash="sha256", device=None,
          batch_msm: bool = False) -> Proof:
    """PLONK prove (≙ the reference's device engine). rng supplies the
    blinding as in the reference, so one rng gives one proof; ``device`` is
    the torch device of the run.

    checkpoint_dir: persist the stages solve, round1, round2 and quotient
    there, so that a preempted run resumes from the last one done.
    fs_hash: the Fiat-Shamir hash, "sha256" (gnark's bytes) or "mimc".
    commitment_hash: the BSB22 commitment hash, "sha256" (RFC 9380, DST
    "BSB22-Plonk") or ("mimc", outer_modulus).
    batch_msm: commit round 1's a, b, c and round 3's three quotient shards
    each as one ``msm_batch`` (the JAX package's ``GNARK_TPU_BATCH_MSM=1``);
    the proof is the same."""
    if engine != "device":
        raise NotImplementedError(
            "only engine='device' is ported; the host engine is "
            "gnark_icicle_tpu's")
    q = curve.fr.modulus
    ctx = DeviceCtx(curve, device)  # resolves the device before any work
    rand = rng.randrange if rng is not None else (
        lambda m: secrets.randbelow(m - 1) + 1
    )
    vk = pk.vk
    assert vk is not None, "ProvingKey.vk required (rebuild keys via setup)"
    ck = None
    if checkpoint_dir is not None:
        ck = _Checkpoint(checkpoint_dir, _binding(cs, pk, q, fs_hash, commitment_hash,
                                                  public_values, secret_values))
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

    # ---- stage 1: solve + wire polynomials (prove.py:350-456) --------------
    # BSB22: the placeholder hint becomes a KZG commitment to the PI2 column
    # polynomial (≙ the instance's bsb22Hint, prove.go:291-320)
    commitment_info = cs.commitments
    bsb22_coms = [None] * len(commitment_info)
    pi2_coeffs = [None] * len(commitment_info)
    commitment_vals = [None] * len(commitment_info)
    overrides = None
    if commitment_info:
        def bsb22_override(qmod, inputs):
            i = int(inputs[0])
            cinfo = commitment_info[i]
            pi2 = [0] * n
            for gi, vv in zip(cinfo.committed, inputs[1:]):
                pi2[gi] = vv % qmod
            # blind at rows whose qcp is 0 (the commitment row and the last
            # row, ≙ prove.go:305-309)
            pi2[cinfo.commitment_index] = rand(qmod)
            if n - 1 not in set(cinfo.committed) and n - 1 != cinfo.commitment_index:
                pi2[n - 1] = rand(qmod)
            coeffs = evals_to_coeffs(pi2)
            com = kzg.commit(coeffs)
            bsb22_coms[i] = com
            pi2_coeffs[i] = coeffs
            if isinstance(commitment_hash, tuple) and commitment_hash[0] == "mimc":
                # recursion-friendly: PLONK absorbs only the commitment point
                val = mimc_commitment_hash(commitment_hash[1], qmod, curve.fp.modulus,
                                           com, [])
            else:
                val = hash_to_fr(g1_to_bytes(curve, com, compressed=False),
                                 b"BSB22-Plonk", qmod)[0]
            commitment_vals[i] = val
            return [val]

        overrides = {hintlib.BSB22_PLACEHOLDER: bsb22_override}

    solved = ck.load("solve") if ck is not None else None
    if solved is not None:
        wires, av, bv, cv, bsb22_coms, pi2_coeffs, commitment_vals = solved
    else:
        wires, av, bv, cv = solve_scs(cs, public_values, secret_values,
                                      hint_overrides=overrides)
        if ck is not None:
            ck.save("solve", (wires, av, bv, cv, bsb22_coms, pi2_coeffs, commitment_vals))
    _mark("solve")
    av += [0] * (n - len(av))
    bv += [0] * (n - len(bv))
    cv += [0] * (n - len(cv))

    ts = make_transcript(q, list(CHALLENGES), fs_hash)
    bind_public_data(ts, curve, vk, public_values)

    def blind(coeffs, degree):
        bs = [rand(q) for _ in range(degree + 1)]
        return _add_poly(coeffs, _mul_zh(bs, n, q), q)

    round1 = ck.load("round1") if ck is not None else None
    if round1 is not None:
        a_coeffs, b_coeffs, c_coeffs, a_com, b_com, c_com = round1
    else:
        a_coeffs = blind(evals_to_coeffs(av), 1)
        b_coeffs = blind(evals_to_coeffs(bv), 1)
        c_coeffs = blind(evals_to_coeffs(cv), 1)
        if batch_msm:
            a_com, b_com, c_com = kzg.commit_batch([a_coeffs, b_coeffs, c_coeffs])
        else:
            a_com = kzg.commit(a_coeffs)
            b_com = kzg.commit(b_coeffs)
            c_com = kzg.commit(c_coeffs)
        if ck is not None:
            ck.save("round1", (a_coeffs, b_coeffs, c_coeffs, a_com, b_com, c_com))
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

    round2 = ck.load("round2") if ck is not None else None
    if round2 is not None:
        z_coeffs, z_com = round2
    else:
        z_coeffs = blind(evals_to_coeffs(zv), 2)
        z_com = kzg.commit(z_coeffs)
        if ck is not None:
            ck.save("round2", (z_coeffs, z_com))
    _mark("round2 Z")
    for cm in bsb22_coms:  # α binds the BSB22 commitments (≙ prove.go:471)
        ts.bind_point(b"alpha", curve, cm)
    ts.bind_point(b"alpha", curve, z_com)
    alpha = ts.challenge(b"alpha")

    # ---- stage 3: quotient on the 4n coset (prove.py:511-593) --------------
    # full Qk (committed coefficients + public inputs in the first slots)
    qk_full = list(cs.qc) + [0] * (n - cs.nb_gates)
    for j, pv in enumerate(public_values):
        qk_full[j] = (qk_full[j] + pv) % q
    for i, cinfo in enumerate(commitment_info):
        # the commitment hash enters Qk like a public input (≙ completeQk
        # placing commitmentVal at the commitment row, prove.go:381-383)
        ci = cinfo.commitment_index
        qk_full[ci] = (qk_full[ci] + commitment_vals[i]) % q
    qk_full_coeffs = evals_to_coeffs(qk_full)

    # z(ωX) coefficient scaling with a running power
    zw_coeffs = []
    wp = 1
    for c in z_coeffs:
        zw_coeffs.append(c * wp % q)
        wp = wp * omega % q

    shard = n + 2
    quo = ck.load("quotient") if ck is not None else None
    if quo is not None:
        t1, t2, t3, h_coms = quo
    else:
        ev = {
            "a": coset4_evals_dev(a_coeffs),
            "b": coset4_evals_dev(b_coeffs),
            "c": coset4_evals_dev(c_coeffs),
            "z": coset4_evals_dev(z_coeffs),
            "zw": coset4_evals_dev(zw_coeffs),
            "qk": coset4_evals_dev(qk_full_coeffs),
        }
        # BSB22: the gate's Σ qcp_i·PI2_i rides Qk's evals (the reference adds
        # it to the gate, prove.py:200-202; the sum is the same)
        for i in range(len(commitment_info)):
            ev["qk"] = tf.add(ev["qk"], tf.mont_mul(
                coset4_evals_dev(pk.trace_coeffs[f"qcp{i}"]), coset4_evals_dev(pi2_coeffs[i])))
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
        shards = [t_mont[:, k * shard:(k + 1) * shard] for k in range(3)]
        if batch_msm:
            h_coms = tuple(kzg.commit_mont_batch(shards))
        else:
            h_coms = tuple(kzg.commit_mont(t) for t in shards)
        if ck is not None:
            ck.save("quotient", (t1, t2, t3, h_coms))
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
    qcp_z = [_eval_poly(pk.trace_coeffs[f"qcp{i}"], zeta, q)
             for i in range(len(commitment_info))]
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
    ]
    for i in range(len(commitment_info)):
        lin_terms.append((pi2_coeffs[i], qcp_z[i]))
    lin_terms += [
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
    for i in range(len(commitment_info)):
        polys.append(pk.trace_coeffs[f"qcp{i}"])
        digests.append(vk.commitments[f"qcp{i}"])
        claimed.append(qcp_z[i])

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
        bsb22_commitments=bsb22_coms,
    )
