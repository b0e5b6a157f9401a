"""Groth16 Prove: witness solve (host), computeH and the MSMs (device),
blinding and assembly (host).

Port of gnark_icicle_tpu/backend/groth16/prove.py (``prove`` :187, the
device phase :371-555, ``_compute_h`` :31-90) with ``_assemble_proof``
(:558-589) copied. Flow:

  solve (host, native)  →  computeH (3 INTT → 3 coset NTT → coset INTT of
  (a·b−c)·den, the pointwise on its first pass → from Montgomery; h stays on
  the device, bit-reversed)  →
  MSMs A, B1, K, Z over G1 and B2 over G2  →  r, s blinding (host).

BSB22 commitments (the placeholder hint's override :199-246, the folded
proofs of knowledge :313-330, K without the committed wires :410-425),
checkpoints (``_Checkpoint`` :134-185: stages solve, h, msms) and the
batched MSM branch (:484-526, the keyword ``batch_msm``) are the
reference's, but for each commitment's Pedersen commitment and proof of
knowledge, which the reference computes as host MSMs: here they are one
``msm_batch`` of two problems on the device, inside the override
(``_pedersen_msms``). Each phase's wall time is logged (the port's ``logger``) after
the device has finished it. ``engine="host"`` is the reference's host engine
(:342-369, ``host_compute.py``): computeH and the MSMs, and the BSB22
commitments' Pedersen products, in host big-int arithmetic, with no device;
under one rng its proof is the device engine's. Not ported yet: a device
mesh; asking for one raises NotImplementedError.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import secrets
import time

import numpy as np
import torch

from ...constraint import hints as hintlib
from ...constraint.solver import solve, solved_u32
from ...device import DeviceCtx
from ...io.serialize import g1_to_bytes
from ...logger import logger
from ...ops.field import words_for
from ...ops.field_t import TField
from ...ops.msm import pick_window
from .. import pedersen
from ..hash_to_field import (
    COMMITMENT_DST, G16_FOLD_DST, evm_commitment_hash, hash_to_fr, mimc_commitment_hash,
    serialize_commitment,
)
from .host_compute import compute_h_host, msm_host, z_scalars_bitreversed
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


class _Checkpoint:
    """Stage checkpointing for preemptible accelerators. Copied from
    gnark_icicle_tpu/backend/groth16/prove.py:134-185: stages solve → h →
    msms (PLONK: solve, round1, round2, quotient); blinding is always fresh
    so a resumed proof is still randomized. Artifacts are bound to the
    proving task (a sha256 of the constraint count, domain, hash mode and
    witness) and dropped on mismatch. The port saves host objects only
    (ints, numpy, CPU tensors), so a resumed run loads on any device."""

    def __init__(self, directory, binding: bytes):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.binding = binding
        tag_path = self._p("binding")
        if os.path.exists(tag_path):
            with open(tag_path, "rb") as f:
                if f.read() != binding:  # different proving task: start over
                    for name in os.listdir(directory):
                        os.unlink(os.path.join(directory, name))
        with open(tag_path, "wb") as f:
            f.write(binding)

    def _p(self, name):
        return os.path.join(self.dir, name)

    def load(self, name):
        path = self._p(name + ".pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def save(self, name, obj):
        tmp = self._p(name + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._p(name + ".pkl"))  # atomic vs preemption

    def has(self, name) -> bool:
        return os.path.exists(self._p(name + ".pkl"))


def _pad_rows(n: int) -> int:
    """The padded row count of an MSM operand in the batched branch
    (gnark_icicle_tpu/parallel/pipeline.py:54 ``_pad_msm_inputs``):
    multiples of 64 below 4,096 rows, of 1,024 above. The padding decides
    which operands share one ``msm_batch``."""
    base = 64 if n < 4096 else 1024
    return n + (-n) % base


def _batched_g1_msms(ctx: DeviceCtx, ops: list) -> dict:
    """The G1 MSMs of a prove, grouped by padded size as the reference
    groups them (prove.py:484-526): ops is [(name, (table, inf), scalars)];
    each operand is padded to ``_pad_rows`` with infinity rows and zero
    scalars, a group of one takes ``msm``, a larger one ``msm_batch`` over
    its problems' tables stacked row-wise. Returns {name: (3, W, 1)}."""
    groups: dict = {}
    for name, (table, inf), scal in ops:
        n = scal.shape[1]
        pad = _pad_rows(n) - n
        if pad:
            table = torch.cat([table, table.new_zeros((pad, table.shape[1]))])
            inf = torch.cat([inf, inf.new_ones(pad)])
            scal = torch.nn.functional.pad(scal, (0, pad))
        groups.setdefault(n + pad, []).append((name, table, inf, scal))
    out = {}
    for n_pad, grp in groups.items():
        c = pick_window(n_pad)
        if len(grp) == 1:
            name, table, inf, scal = grp[0]
            out[name] = ctx.msm_g1.msm(table, inf, scal, c)
            continue
        res = ctx.msm_g1.msm_batch(torch.cat([g[1] for g in grp]),
                                   torch.stack([g[2] for g in grp]),
                                   torch.stack([g[3] for g in grp]), c)
        for m, g in enumerate(grp):
            out[g[0]] = res[..., m:m + 1]
    return out


def _pedersen_msms(ctx: DeviceCtx, pk: ProvingKey, i: int, values: list) -> tuple:
    """Commitment i's Pedersen commitment Σ vᵢ·basisᵢ and proof of knowledge
    Σ vᵢ·(σ·basisᵢ) (the host's ``pedersen.commit`` and
    ``prove_knowledge``, pedersen.py:37-44) as one ``msm_batch`` of two
    problems on ctx.device: the same scalars over the key's two tables,
    staged once per key (``device_arrays`` "pedersen"). Host affine points;
    (None, None) where nothing is committed."""
    if not values:
        return None, None
    t0 = time.perf_counter()
    table, inf = pk.device_arrays(ctx)["pedersen"][i]
    n = len(values)
    scal = ctx.fr_plain(values)
    res = ctx.msm_g1.msm_batch(table, inf.view(2, n), torch.stack([scal, scal]),
                               pick_window(n))
    cm, pok = ctx.g1.to_affine_host(res)
    logger().info("groth16 prove: pedersen msms took=%.3fs", time.perf_counter() - t0)
    return cm, pok


def _host_pedersen(curve, pk: ProvingKey, i: int, values: list) -> tuple:
    """_pedersen_msms's two products on the host (the host engine's, as the
    reference makes them, prove.py:229-231 and :318-321)."""
    if not values:
        return None, None
    key = pk.commitment_keys[i]
    return pedersen.commit(curve, key, values), pedersen.prove_knowledge(curve, key, values)


def _bsb22_override(ctx, cs, pk, curve, commitment_hash, commitment_pts, committed_values,
                    poks):
    """The BSB22 placeholder hint's replacement (prove.py:199-246, ≙
    solver.OverrideHint in prove.go:82-108): the Pedersen commitment of the
    committed private values and its proof of knowledge, made where the
    values are first known (``_pedersen_msms``; ``_host_pedersen`` where ctx
    is None, the host engine), kept in commitment_pts and poks, and the
    commitment wire's value the commitment's hash under
    ``commitment_hash``."""
    q = curve.fr.modulus
    fr_bytes = (q.bit_length() + 7) // 8

    def bsb22_override(qmod, inputs):
        i = int(inputs[0])
        cinfo = cs.commitments[i]
        rest = inputs[1:]
        hashed = rest[:len(cinfo.public_and_commitment_committed)]
        committed_values[i] = [v % qmod for v in rest[len(hashed):]]
        cm, poks[i] = (_pedersen_msms(ctx, pk, i, committed_values[i]) if ctx is not None
                       else _host_pedersen(curve, pk, i, committed_values[i]))
        commitment_pts[i] = cm
        if isinstance(commitment_hash, tuple) and commitment_hash[0] == "mimc":
            # recursion-friendly proof: the outer circuit replays this hash
            # natively (≙ recursion.NewShort via WithProverHashToFieldFunction)
            return [mimc_commitment_hash(commitment_hash[1], qmod, curve.fp.modulus, cm,
                                         hashed)]
        if isinstance(commitment_hash, tuple) and commitment_hash[0] == "evm":
            # Solidity-verifier-friendly proof: plain digest % r
            return [evm_commitment_hash(commitment_hash[1], qmod, cm, hashed)]
        msg = serialize_commitment(g1_to_bytes(curve, cm, compressed=False), hashed, fr_bytes)
        return [hash_to_fr(msg, COMMITMENT_DST, qmod)[0]]

    return {hintlib.BSB22_PLACEHOLDER: bsb22_override}


def _binding(cs, pk, q, commitment_hash, public_values, secret_values) -> bytes:
    """The checkpoint's task binding, the reference's bytes (prove.py:249-262)."""
    nb = (q.bit_length() + 7) // 8  # Fr width (48 bytes on BW6-761)
    return hashlib.sha256(
        b"g16ck" + cs.nb_constraints.to_bytes(8, "big")
        + pk.domain_log_n.to_bytes(2, "big")
        + repr(commitment_hash).encode()
        + b"".join(int(v % q).to_bytes(nb, "big") for v in public_values)
        + b"|sec|"
        + b"".join(int(v % q).to_bytes(nb, "big") for v in secret_values)
    ).digest()


def prove(cs, pk: ProvingKey, public_values, secret_values, curve,
          rng=None, checkpoint_dir: str | None = None,
          engine: str = "device", mesh=None,
          commitment_hash="sha256", device=None, batch_msm: bool = False) -> Proof:
    """Generate a Groth16 proof (≙ groth16.Prove, accelerated path).

    The arguments are the reference's; ``device`` is the torch device of the
    run (default: the first CUDA card; raises without one). rng supplies the
    blinding r, s exactly as in the reference, so one rng gives one proof.
    commitment_hash: the BSB22 commitment hash, "sha256" (gnark's RFC 9380
    path), ("mimc", outer_modulus) or ("evm", "sha256" | "keccak256").
    checkpoint_dir: persist the stages solve, h and msms there, so that a
    preempted run resumes from the last one done.
    batch_msm: run the G1 MSMs of one padded size as one ``msm_batch``
    (A, B1 and K on the Chain; the JAX package's ``GNARK_TPU_BATCH_MSM=1``);
    the proof is the same.
    engine: "device" (the kernels on ``device``) or "host" (host big-int
    computeH and MSMs, ≙ the reference's non-accelerated prover: no device,
    right for small systems; ``device`` and ``batch_msm`` are not read).
    """
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet")
    if engine not in ("device", "host"):
        raise ValueError(f"engine must be 'device' or 'host', not {engine!r}")
    log = logger()
    t_start = time.perf_counter()
    q = curve.fr.modulus
    ctx = DeviceCtx(curve, device) if engine == "device" else None
    rand = rng.randrange if rng is not None else (
        lambda m: secrets.randbelow(m - 1) + 1
    )

    commitment_pts = [None] * len(cs.commitments)
    committed_values = [None] * len(cs.commitments)
    poks = [None] * len(cs.commitments)
    overrides = (_bsb22_override(ctx, cs, pk, curve, commitment_hash, commitment_pts,
                                 committed_values, poks) if cs.commitments else None)
    ck = None
    if checkpoint_dir is not None:
        ck = _Checkpoint(checkpoint_dir, _binding(cs, pk, q, commitment_hash, public_values,
                                                  secret_values))

    def stage():
        t0 = time.perf_counter()
        dev = pk.device_arrays(ctx)
        log.info("groth16 prove: pk staging took=%.3fs", time.perf_counter() - t0)
        return dev

    # the solve's commitment override reads the Pedersen tables: the key is
    # staged before it
    dev = (stage() if ctx is not None and cs.commitments and not (ck is not None and ck.has("msms"))
           else None)
    t_solve = time.perf_counter()
    res = None
    if ck is not None:
        saved = ck.load("solve")
        if saved is not None:
            res, commitment_pts, committed_values = saved
    if res is None:
        res = solve(cs, public_values, secret_values, hint_overrides=overrides)
        if ck is not None:
            ck.save("solve", (res, commitment_pts, committed_values))
    t_solved = time.perf_counter()
    log.info("groth16 prove: solve took=%.3fs", t_solved - t_solve)

    # proofs of knowledge, folded with the G16-BSB22 challenge
    # (prove.py:313-330, ≙ prove.go:121-141); a solve read from a checkpoint
    # made none, and they are made again from its committed values
    commitment_pok = None
    if cs.commitments:
        fr_bytes = (q.bit_length() + 7) // 8
        for i, values in enumerate(committed_values):
            if values and poks[i] is None:
                poks[i] = (_pedersen_msms(ctx, pk, i, values)[1] if ctx is not None
                           else _host_pedersen(curve, pk, i, values)[1])
        msg = b"".join(v.to_bytes(fr_bytes, "big") for v in _commitment_wires(cs, res, q))
        challenge = hash_to_fr(msg, G16_FOLD_DST, q)[0]
        commitment_pok = pedersen.fold_proofs(curve, poks, challenge)
        log.info("groth16 prove: commitments took=%.3fs", time.perf_counter() - t_solved)
    t_com = time.perf_counter()

    log_n = pk.domain_log_n
    if ctx is None:
        return _prove_host(cs, pk, curve, res, rand, commitment_pts, commitment_pok, t_start)
    W = ctx.fr.n32
    msms = ck.load("msms") if ck is not None else None
    h = None
    if msms is None:
        h = ck.load("h") if ck is not None else None
        if h is None:
            h = _compute_h(ctx, solved_u32(res, "a", W), solved_u32(res, "b", W),
                           solved_u32(res, "c", W), log_n)
            if ck is not None:
                ck.save("h", h.cpu())
        h = h.to(ctx.device)
    ctx.sync()
    t_h = time.perf_counter()
    log.info("groth16 prove: computeH took=%.3fs", t_h - t_com)

    if msms is None:
        dev = dev if dev is not None else stage()
        t_pk = time.perf_counter()
        wires = ctx.fr_scalars(solved_u32(res, "wires", W))
        if cs.commitments:
            priv = wires.index_select(1, _k_index(cs, dev, wires.shape[1], ctx.device))
        else:
            priv = wires[:, cs.nb_public:].contiguous()
        out = _g1_msms(ctx, dev, wires, priv, h, batch_msm)
        table, inf = dev["b2"]
        bs2_dev = ctx.msm_g2.msm(table, inf, wires, pick_window(wires.shape[1]))
        krs_parts = [out[k] for k in ("k", "z") if k in out]
        msms = (ctx.g1_to_host(out["ar"]), ctx.g1_to_host(out["bs1"]),
                ctx.g2_to_host(bs2_dev), [ctx.g1_to_host(p) for p in krs_parts])
        if ck is not None:
            ck.save("msms", msms)
        log.info("groth16 prove: msms took=%.3fs", time.perf_counter() - t_pk)
    ar_msm, bs1_msm, bs2_msm, krs_msm = msms

    return _assemble_proof(
        cs, pk, curve, q, rand, ar_msm, bs1_msm, bs2_msm, krs_msm,
        commitment_pts, commitment_pok, logger, t_start, str(ctx.device),
    )


def _commitment_wires(cs, res, q: int) -> list:
    """The commitment wires' values as ints, read from the solver's words
    (res.wires would make every wire an int)."""
    words = solved_u32(res, "wires", words_for(q))
    return [int.from_bytes(words[c.commitment_index].astype("<u4").tobytes(), "little")
            for c in cs.commitments]


def _prove_host(cs, pk: ProvingKey, curve, res, rand, commitment_pts, commitment_pok,
                t_start: float) -> Proof:
    """The host engine's computeH and MSMs, then the assembly. Copied from
    gnark_icicle_tpu/backend/groth16/prove.py:342-369."""
    log_n = pk.domain_log_n
    h = compute_h_host(res.a, res.b, res.c, log_n, curve.fr)
    wires_i = res.wires
    if cs.commitments:
        excluded = {c.commitment_index for c in cs.commitments}
        for c in cs.commitments:
            excluded.update(c.private_committed)
        priv_i = [wires_i[w] for w in range(cs.nb_public, len(wires_i))
                  if w not in excluded]
    else:
        priv_i = wires_i[cs.nb_public:]
    g1h, g2h = curve.g1, curve.g2
    ar_msm = msm_host(g1h, pk.g1_a, wires_i)
    bs1_msm = msm_host(g1h, pk.g1_b, wires_i)
    bs2_msm = msm_host(g2h, pk.g2_b, wires_i)
    krs_msm = []
    if priv_i:
        krs_msm.append(msm_host(g1h, pk.g1_k, priv_i))
    krs_msm.append(msm_host(g1h, pk.g1_z, z_scalars_bitreversed(h, log_n, len(pk.g1_z))))
    return _assemble_proof(cs, pk, curve, curve.fr.modulus, rand, ar_msm, bs1_msm, bs2_msm,
                           krs_msm, commitment_pts, commitment_pok, logger, t_start, "host")


def _k_index(cs, dev: dict, nb_wires: int, device) -> torch.Tensor:
    """The wires of pk.K where the system has commitments: every private
    wire but the commitment wires and the committed private wires (their K
    points became vk.K entries and Pedersen bases). Built once per key and
    device, beside its staged tables (``dev``)."""
    if "k_idx" not in dev:
        keep = np.ones(nb_wires, dtype=bool)
        keep[:cs.nb_public] = False
        for c in cs.commitments:
            keep[c.commitment_index] = False
            keep[list(c.private_committed)] = False
        dev["k_idx"] = torch.from_numpy(np.flatnonzero(keep)).to(device)
    return dev["k_idx"]


def _g1_msms(ctx: DeviceCtx, dev: dict, wires, priv, h, batch_msm: bool) -> dict:
    """The G1 MSMs A, B1, K (where there are private wires) and Z:
    {name: (3, W, 1)}, one ``msm`` each or, with batch_msm, grouped by
    padded size (``_batched_g1_msms``)."""
    ops = [("ar", dev["a"], wires), ("bs1", dev["b1"], wires)]
    if priv.shape[1] > 0:
        ops.append(("k", dev["k"], priv))
    ops.append(("z", dev["z"], h))
    if batch_msm:
        return _batched_g1_msms(ctx, ops)
    return {name: ctx.msm_g1.msm(table, inf, scal, pick_window(scal.shape[1]))
            for name, (table, inf), scal in ops}


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
