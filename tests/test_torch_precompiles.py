"""The EVM precompile circuits of the port's std/ and the card route of its
BSB22 Pedersen commitments, against the JAX package, on the CPU.

The port's ``curves/secp256k1.py`` (host keys, RFC 6979 signatures),
``std/evmprecompiles.py`` (over ``sw_emulated.py``, ``ecdsa.py``,
``math_bits.py`` and ``hash/sha2.py``) and the Groth16 prover's Pedersen
step: the commitment and its proof of knowledge as one ``msm_batch`` of two
problems (``backend/groth16/prove.py`` ``_pedersen_msms``), which on the CPU
runs the MSM kernels' plain versions. Each is held to the JAX package (or,
for the Pedersen step, to the host ``backend/pedersen.py``), exactly.
Inputs come from numpy seeds; the commitment's hiding mask is fixed
(``fixed_mask``, as in tests/test_torch_bsb22.py).

EcAdd and EcRecover are tests/test_evmprecompiles_compiled.py's circuits
(:36-50, :122-160), built over each package's frontend and gadgets; the
EcRecover compile (867,307 constraints) takes minutes in each package and
is marked slow.
"""

import hashlib
import importlib
import pickle
import random
import secrets

import pytest

from gnark_icicle_tpu_torch.curves import bn254

from test_torch_common import CURVES, ref_curve, to_reference
from test_torch_emulated import PKGS, _plain, limbs, mod, rand_below, state

Q = bn254.R
ECADD_CONSTRAINTS = 5_447          # tests/test_evmprecompiles_compiled.py:26
ECADD_GATES = 17_527
ECRECOVER_CONSTRAINTS = 867_307    # tests/test_evmprecompiles_compiled.py:28
ECRECOVER_COMMITTED = 710_886


@pytest.fixture(autouse=True)
def fixed_mask(monkeypatch):
    monkeypatch.setattr(secrets, "randbelow", lambda m: 0x5EED % m)


class SeededRng:
    """random.Random's randrange over a numpy seed (keygen's interface)."""

    def __init__(self, seed):
        self.seed = seed

    def randrange(self, lo, hi):
        self.seed += 1
        return lo + rand_below(self.seed, hi - lo, 1)[0]


def signature(pkg: str, seed: int) -> tuple:
    """(priv, pub, msg, r, s, v) from a package's host secp256k1 and the
    recovery parity v."""
    secp = mod(pkg, "curves.secp256k1")
    evm = mod(pkg, "std.evmprecompiles")
    priv, pub = secp.keygen(SeededRng(seed))
    msg = rand_below(seed + 100, secp.N - 1, 1)[0] + 1
    r, s = secp.sign(priv, msg)
    v = next(v for v in (0, 1) if evm._recover_host(msg, v, r, s) == pub)
    return priv, pub, msg, r, s, v


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_secp256k1_host_sign_verify_and_recover_match(seed):
    """keygen, RFC 6979 sign and verify give the same key and signature in
    both packages; the signature verifies, not over msg + 1 nor under the
    key of priv + 1; ecrecover's host math and the evm.ecrecover hint
    recover the key in both."""
    got = [signature(pkg, seed) for pkg in PKGS]
    assert got[0] == got[1]
    priv, pub, msg, r, s, v = got[0]
    for pkg in PKGS:
        secp = mod(pkg, "curves.secp256k1")
        assert secp.verify(pub, msg, (r, s))
        assert not secp.verify(pub, msg + 1, (r, s))
        assert not secp.verify(secp.G1.scalar_mul(secp.G1.generator, priv + 1), msg, (r, s))
        hints = mod(pkg, "constraint.hints")
        words = [(x >> (64 * i)) & ((1 << 64) - 1) for x in (msg, r, s) for i in range(4)]
        out = hints.get_hint(hints.hint_id("evm.ecrecover"))(Q, words + [v, 4, 64])
        assert [sum(w << (64 * i) for i, w in enumerate(out[4 * j:4 * j + 4]))
                for j in range(2)] == list(pub)


def ec_add(pkg: str):
    fe = mod(pkg, "frontend")
    evm = mod(pkg, "std.evmprecompiles")
    sw = mod(pkg, "std.sw_emulated")
    k = sw.BN254G1.fp.n_limbs

    class EcAdd(fe.Circuit):
        px = fe.Secret(shape=k)
        py = fe.Secret(shape=k)
        qx = fe.Secret(shape=k)
        qy = fe.Secret(shape=k)
        rx = fe.Secret(shape=k)
        ry = fe.Secret(shape=k)

        def define(self, api):
            c = sw.EmulatedCurve(api, sw.BN254G1, Q)
            out = evm.ec_add(api, Q, c.witness_point(self.px, self.py),
                             c.witness_point(self.qx, self.qy))
            c.assert_is_equal(out, c.witness_point(self.rx, self.ry))

    return EcAdd


def ec_add_secrets(seed: int, wrong: bool = False) -> list:
    g1 = bn254.G1
    a, b = rand_below(seed, bn254.R - 1, 2)
    p, q = g1.scalar_mul(g1.generator, a + 1), g1.scalar_mul(g1.generator, b + 1)
    r = g1.add(p, q)
    if wrong:
        r = g1.add(r, g1.generator)
    fp = mod(PKGS[0], "std.sw_emulated").BN254G1.fp
    return [w for pt in (p, q, r) for c in pt for w in limbs(c, fp)]


@pytest.mark.parametrize("builder", ["r1cs", "scs"])
def test_ecadd_compiles_and_solves_as_the_reference(builder):
    """EcAdd (0x06): 5,447 constraints (17,527 gates) in both packages, the
    same system and one commitment, the same wires (the port's native R1CS
    solver against the JAX package's Python one), a wrong sum refused by
    both."""
    systems, wires = [], []
    for pkg in PKGS:
        cs = mod(pkg, "frontend").compile_circuit(Q, ec_add(pkg), builder=builder)
        systems.append(cs)
        if builder == "r1cs":
            solver = mod(pkg, "constraint.solver")
            wires.append(solver.solve(cs, [], ec_add_secrets(4), native=pkg == PKGS[0]).wires)
            with pytest.raises(solver.UnsatisfiedConstraintError):
                solver.solve(cs, [], ec_add_secrets(4, wrong=True))
        else:
            scs = mod(pkg, "constraint.scs")
            wires.append(list(scs.solve_scs(cs, [], ec_add_secrets(4))[0]))
            with pytest.raises(scs.SparseUnsatisfiedError):
                scs.solve_scs(cs, [], ec_add_secrets(4, wrong=True))
    size = [cs.nb_constraints if builder == "r1cs" else cs.nb_gates for cs in systems]
    assert size == [ECADD_CONSTRAINTS if builder == "r1cs" else ECADD_GATES] * 2
    assert len(systems[0].commitments) == 1
    assert state(systems[0]) == state(systems[1])
    assert wires[0] == wires[1]


def ec_recover(pkg: str):
    fe = mod(pkg, "frontend")
    evm = mod(pkg, "std.evmprecompiles")
    sw = mod(pkg, "std.sw_emulated")
    sfr, sfp = sw.SECP256K1.fr, sw.SECP256K1.fp

    class EcRecover(fe.Circuit):
        msg = fe.Secret(shape=sfr.n_limbs)
        v = fe.Secret()
        r = fe.Secret(shape=sfr.n_limbs)
        s = fe.Secret(shape=sfr.n_limbs)
        pubx = fe.Secret(shape=sfp.n_limbs)
        puby = fe.Secret(shape=sfp.n_limbs)

        def define(self, api):
            c = sw.EmulatedCurve(api, sw.SECP256K1, Q)
            fr = c.fr
            P = evm.ec_recover(api, Q, fr.from_limbs(self.msg), self.v,
                               fr.from_limbs(self.r), fr.from_limbs(self.s))
            c.assert_is_equal(P, c.witness_point(self.pubx, self.puby))

    return EcRecover


def state_digest(cs) -> dict:
    """state(cs) as a sha256 a field, each field's plain copy made and
    dropped in turn (an R1CS of 867,307 constraints)."""
    out = {}
    for k, v in cs.__getstate__().items():
        if not k.startswith("_"):
            out[k] = hashlib.sha256(pickle.dumps(_plain(v), protocol=5)).hexdigest()
    return out


@pytest.mark.slow
def test_ecrecover_compiles_to_the_reference():
    """EcRecover (0x01) at its full size: 867,307 constraints in both
    packages, 710,886 privately committed wires, the same system; the
    port's native solver accepts a signature of the host secp256k1 and
    refuses the key of priv + 1."""
    digests = []
    for pkg in reversed(PKGS):      # one system at a time in memory; the port's kept
        cs = mod(pkg, "frontend").compile_circuit(Q, ec_recover(pkg))
        assert cs.nb_constraints == ECRECOVER_CONSTRAINTS
        assert sum(len(c.private_committed) for c in cs.commitments) == ECRECOVER_COMMITTED
        digests.append(state_digest(cs))
    assert digests[0] == digests[1]
    priv, pub, msg, r, s, v = signature(PKGS[0], 41)
    sw = mod(PKGS[0], "std.sw_emulated")
    sfr, sfp = sw.SECP256K1.fr, sw.SECP256K1.fp

    def sec(point):
        return (limbs(msg, sfr) + [v] + limbs(r, sfr) + limbs(s, sfr)
                + limbs(point[0], sfp) + limbs(point[1], sfp))

    solver = mod(PKGS[0], "constraint.solver")
    solver.solve(cs, [], sec(pub))
    secp = mod(PKGS[0], "curves.secp256k1")
    with pytest.raises(solver.UnsatisfiedConstraintError):
        solver.solve(cs, [], sec(secp.G1.scalar_mul(secp.G1.generator, priv + 1)))


def emulated_mul(pkg: str):
    """One BN254 Fp product (tests/stats_circuits.py:32 ``_emu_binop``): the
    smallest emulated circuit with a commitment, 391 constraints
    (gnark_icicle_tpu/latest_stats.csv, emulated/bn254fp_mul)."""
    from test_torch_emulated import emulated_op

    return emulated_op(pkg, "BN254_FP", "mul")


def mul_witness(seed: int) -> tuple:
    em = mod(PKGS[0], "std.emulated")
    p = em.BN254_FP.modulus
    x, y = rand_below(seed, p, 2)
    Circuit, params = emulated_mul(PKGS[0])
    return Circuit(x=limbs(x, params), y=limbs(y, params),
                   z=limbs(x * y % p, params)).witness_values(Q)


@pytest.fixture
def pedersen_runs(monkeypatch):
    """Each call of the Groth16 prover's _pedersen_msms: its values, its
    (commitment, proof of knowledge) and the MSMKernel.msm_batch calls it
    made, by problem count."""
    from gnark_icicle_tpu_torch.ops.msm import MSMKernel

    prove_mod = importlib.import_module("gnark_icicle_tpu_torch.backend.groth16.prove")
    runs, batches = [], []
    msms, batch = prove_mod._pedersen_msms, MSMKernel.msm_batch

    def counted_batch(self, table, inf_mask, scalars, c):
        batches.append(inf_mask.shape[0])
        return batch(self, table, inf_mask, scalars, c)

    def recorded(ctx, pk, i, values):
        before = len(batches)
        out = msms(ctx, pk, i, values)
        runs.append({"values": list(values), "out": out, "batches": batches[before:]})
        return out

    monkeypatch.setattr(prove_mod, "_pedersen_msms", recorded)
    monkeypatch.setattr(MSMKernel, "msm_batch", counted_batch)
    return runs


def _batch_sums(group, lists: list) -> list:
    """Each list of affine points summed, in rounds of pairwise affine adds
    whose denominators share one inversion (Montgomery's trick), over the
    group's own field operations; a pair on one x goes through the group's
    add."""
    f = group.f
    while any(len(pts) > 1 for pts in lists):
        jobs, nxt = [], []
        for i, pts in enumerate(lists):
            nxt.append(pts[-1:] if len(pts) % 2 else [])
            jobs += [(i, a, b) for a, b in zip(pts[0::2], pts[1::2])]
        dens = [f.sub(b[0], a[0]) for _, a, b in jobs]
        live = [not f.is_zero(d) for d in dens]
        prefix, acc = [], f.one()
        for d, ok in zip(dens, live):
            prefix.append(acc)
            acc = f.mul(acc, d) if ok else acc
        inv = f.inv(acc)
        invs = [None] * len(dens)
        for j in reversed(range(len(dens))):
            if live[j]:
                invs[j] = f.mul(inv, prefix[j])
                inv = f.mul(inv, dens[j])
        for (i, a, b), di in zip(jobs, invs):
            if di is None:
                c = group.add(a, b)
                if c is not None:
                    nxt[i].append(c)
                continue
            lam = f.mul(f.sub(b[1], a[1]), di)
            x3 = f.sub(f.sub(f.mul(lam, lam), a[0]), b[0])
            nxt[i].append((x3, f.sub(f.mul(lam, f.sub(a[0], x3)), a[1])))
        lists = nxt
    return [pts[0] if pts else None for pts in lists]


def bucket_msm(group, points: list, scalars) -> tuple | None:
    """Σ sᵢ·Pᵢ over a host group by the bucket method (windows of 6 bits,
    the buckets summed by _batch_sums): the group element of the JAX host
    engine's ``msm_host`` (gnark_icicle_tpu/backend/groth16/host_compute.py
    :83, one scalar product a point), in a tenth of its time."""
    order = group.order
    pairs = [(int(s) % order, pt) for pt, s in zip(points, scalars) if pt is not None]
    pairs = [(s, pt) for s, pt in pairs if s]
    if not pairs:
        return None
    c = 6
    acc = None
    for w in reversed(range(-(-max(s for s, _ in pairs).bit_length() // c))):
        for _ in range(c):
            acc = group.add(acc, acc)
        buckets = [[] for _ in range(1 << c)]
        for s, pt in pairs:
            buckets[(s >> (c * w)) & ((1 << c) - 1)].append(pt)
        run = None
        for b in reversed(_batch_sums(group, buckets[1:])):
            run = group.add(run, b)
            acc = group.add(acc, run)
    return acc


@pytest.fixture
def fast_reference_msm(monkeypatch):
    """The JAX host engine's MSMs (Groth16's prove, PLONK's KZG commits) by
    bucket_msm: the same points, so the same proof bytes."""
    from gnark_icicle_tpu.backend.groth16 import host_compute
    from gnark_icicle_tpu.backend.plonk import host_engine

    monkeypatch.setattr(host_compute, "msm_host", bucket_msm)
    monkeypatch.setattr(host_engine, "msm_host", bucket_msm)


def test_bucket_msm_is_the_host_msm():
    """bucket_msm gives msm_host's point (identity points, zero scalars,
    doubling and cancelling pairs included), over G1 and G2."""
    from gnark_icicle_tpu.backend.groth16.host_compute import msm_host

    g1 = ref_curve("bn254").g1
    pts = [g1.scalar_mul(g1.generator, k % 37 + 2) for k in range(200)] + [None]
    scal = rand_below(9, bn254.R, 201)
    scal[3], scal[5], scal[7] = 0, bn254.R - 1, 1
    pts[8], pts[9] = pts[7], g1.neg(pts[7])      # a doubling and a cancelling pair
    scal[8] = scal[9] = scal[7]
    assert bucket_msm(g1, pts, scal) == msm_host(g1, pts, scal)
    assert bucket_msm(g1, pts[:2], [0, 0]) is None
    g2 = ref_curve("bn254").g2
    pts2 = [g2.scalar_mul(g2.generator, k + 2) for k in range(12)]
    assert bucket_msm(g2, pts2, scal[:12]) == msm_host(g2, pts2, scal[:12])


def test_groth16_card_route_pedersen_matches_reference(pedersen_runs, fast_reference_msm):
    """Groth16 on the 391-constraint emulated product (BN254): under the
    port's keys and one rng, the port's proof bytes equal the JAX package's
    (its host engine; the keys themselves are held to the JAX setup's by
    tests/test_torch_bsb22.py); the commitment and proof of knowledge came
    from one msm_batch of two problems, equal to the host pedersen.commit
    and prove_knowledge of the same values (affine); the proof verifies,
    and a commitment + G is rejected."""
    import dataclasses

    from gnark_icicle_tpu.backend import groth16 as ref_g16
    from gnark_icicle_tpu.io.serialize import proof_to_bytes
    from gnark_icicle_tpu_torch.backend import groth16, pedersen

    curve, ref = CURVES["bn254"], ref_curve("bn254")
    cs = mod(PKGS[0], "frontend").compile_circuit(Q, emulated_mul(PKGS[0])[0])
    ref_cs = mod(PKGS[1], "frontend").compile_circuit(Q, emulated_mul(PKGS[1])[0])
    assert cs.nb_constraints == ref_cs.nb_constraints == 391
    pub, sec = mul_witness(5)
    pk, vk = groth16.setup(cs, curve, rng=random.Random(21), device="cpu")
    proof = groth16.prove(cs, pk, pub, sec, curve, rng=random.Random(22), device="cpu")
    ref_proof = ref_g16.prove(ref_cs, to_reference(pk, ref), pub, sec, ref,
                              rng=random.Random(22), engine="host")
    assert proof_to_bytes(ref, to_reference(proof, ref)) == proof_to_bytes(ref, ref_proof)
    (run,) = pedersen_runs
    key = pk.commitment_keys[0]
    assert run["batches"] == [2] and len(run["values"]) == len(key.basis) > 0
    assert run["out"] == (pedersen.commit(curve, key, run["values"]),
                          pedersen.prove_knowledge(curve, key, run["values"]))
    assert proof.commitments == [run["out"][0]] and proof.commitment_pok == run["out"][1]
    groth16.verify(proof, vk, pub, curve)
    g1 = curve.g1
    assert not groth16.is_valid(dataclasses.replace(
        proof, commitments=[g1.add(proof.commitments[0], g1.generator)]), vk, pub, curve)


def test_plonk_proof_of_the_emulated_product_matches_reference(fast_reference_msm):
    """PLONK on the same circuit under SCS (1,778 gates, a 2^11 domain, one
    BSB22 commitment: Qcp): under the JAX setup's key and one rng, the
    port's proof equals the JAX package's (its host engine), and
    verifies."""
    from gnark_icicle_tpu.backend import plonk as ref_plonk
    from gnark_icicle_tpu_torch.backend import plonk

    from test_torch_common import public_fields

    curve, ref = CURVES["bn254"], ref_curve("bn254")
    cs = mod(PKGS[0], "frontend").compile_circuit(Q, emulated_mul(PKGS[0])[0], builder="scs")
    ref_cs = mod(PKGS[1], "frontend").compile_circuit(Q, emulated_mul(PKGS[1])[0],
                                                     builder="scs")
    assert cs.nb_gates == ref_cs.nb_gates == 1778 and len(cs.commitments) == 1
    pub, sec = mul_witness(6)
    ref_pk, _ = ref_plonk.setup(ref_cs, ref, rng=random.Random(31), engine="host")
    pk = plonk.ProvingKey.from_reference(ref_pk)
    proof = plonk.prove(cs, pk, pub, sec, curve, rng=random.Random(32), device="cpu")
    ref_proof = ref_plonk.prove(ref_cs, ref_pk, pub, sec, ref, rng=random.Random(32),
                                engine="host")
    assert public_fields(proof) == public_fields(ref_proof)
    plonk.verify(proof, pk.vk, pub, curve)
