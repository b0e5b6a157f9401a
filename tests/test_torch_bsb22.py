"""BSB22 commitments (``api.commit``) through the port's Groth16 and PLONK
on the CPU, against the JAX package.

The circuits are tests/test_commit.py's CommitCubic, TwoCommits and
CommitPrivateOnly, built over each package's frontend. Both packages
compile them to the same R1CS and SCS (commitment infos included), the
Groth16 keys (the Pedersen keys included) are the same under one rng, and
so are the proof bytes, for every commitment-hash mode of the JAX package:
Groth16 "sha256", ("mimc", m), ("evm", "sha256") and ("evm", "keccak256");
PLONK "sha256", and ("mimc", m) with ``fs_hash="mimc"``. The JAX side proves
with its host engine; the port proves PLONK, and Groth16 on BN254 with
"sha256" and on BLS12-377, with ``batch_msm=True`` (its G1 MSMs of one padded
size, and PLONK's round-1 and round-3 commits, as one msm_batch each), so
these are also the batched proves held to the JAX host engine. (On the CPU
a batched Groth16 prove of a tiny circuit is the slower one: its MSMs pad to
64 rows, a wider window.)
Each package's verifier accepts the other's proof on BN254 with "sha256",
where a tampered commitment and a missing commitment are rejected by both,
and a tampered proof of knowledge and public input by the port's (PLONK's
tampered public input by both); the port's verifier accepts the JAX proof
in the other modes on BN254 (the proofs being equal byte for byte, the JAX
verifier's check would repeat its own tests; ("evm", "sha256") differs
from ("evm", "keccak256") in the digest only, the other curves' verifies
from BN254's in the width only, and the card verifies BLS12-381's).
Curves: BN254 for every mode, BLS12-381 once, and BLS12-377 with ("mimc",
BW6-761's r), the 2-chain's hash.

``api.commit`` appends a hiding mask drawn with ``secrets.randbelow`` (both
packages' ``randomize_hint``); the tests fix it, so that the two solves see
one witness.
"""

import dataclasses
import random
import secrets

import pytest

from gnark_icicle_tpu import frontend as ref_frontend
from gnark_icicle_tpu.backend import groth16 as ref_g16
from gnark_icicle_tpu.backend import plonk as ref_plonk
from gnark_icicle_tpu.io.serialize import proof_to_bytes
from gnark_icicle_tpu_torch import frontend
from gnark_icicle_tpu_torch.backend import groth16, plonk

from test_torch_common import CURVES, public_fields, ref_curve, to_reference


def commit_cubic(fe):
    class CommitCubic(fe.Circuit):
        """Cubic with a commitment binding x and the public y."""
        x = fe.Secret()
        y = fe.Public()

        def define(self, api):
            c = api.commit(self.x, self.y)
            api.assert_is_different(c, 0)
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))

    return CommitCubic


def two_commits(fe):
    class TwoCommits(fe.Circuit):
        """The second commitment commits to an already-committed variable."""
        a = fe.Secret()
        b = fe.Secret()
        s = fe.Public()

        def define(self, api):
            c1 = api.commit(self.a, self.b)
            api.assert_is_different(c1, 0)
            c2 = api.commit(self.a, c1)
            api.assert_is_different(c2, 0)
            api.assert_is_equal(api.add(self.a, self.b), self.s)

    return TwoCommits


def commit_private_only(fe):
    class CommitPrivateOnly(fe.Circuit):
        a = fe.Secret()
        b = fe.Secret()
        p = fe.Public()

        def define(self, api):
            c = api.commit(self.a, self.b, api.mul(self.a, self.b))
            api.assert_is_different(c, 0)
            api.assert_is_equal(api.mul(self.a, self.b), self.p)

    return CommitPrivateOnly


CIRCUITS = {"commit_cubic": commit_cubic, "two_commits": two_commits,
            "commit_private_only": commit_private_only}
WITNESS = {"commit_cubic": ([35], [3]), "two_commits": ([7], [2, 5]),
           "commit_private_only": ([24], [4, 6])}
# commitment-hash moduli: BN254's own p, and BW6-761's r (the 2-chain's)
MODULI = {"bn254_p": CURVES["bn254"].fp.modulus, "bw6_761_r": CURVES["bw6_761"].fr.modulus}


@pytest.fixture(autouse=True)
def fixed_mask(monkeypatch):
    """Both packages' commitment mask (secrets.randbelow) fixed."""
    monkeypatch.setattr(secrets, "randbelow", lambda m: 0x5EED % m)


def _hash(mode):
    return (mode[0], MODULI[mode[1]]) if isinstance(mode, tuple) and mode[0] == "mimc" else mode


def _compile(name, curve, builder):
    q = CURVES[curve].fr.modulus
    return (frontend.compile_circuit(q, CIRCUITS[name](frontend), builder=builder),
            ref_frontend.compile_circuit(q, CIRCUITS[name](ref_frontend), builder=builder))


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {k: _plain(x) for k, x in vars(v).items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


@pytest.mark.parametrize("name", sorted(CIRCUITS))
@pytest.mark.parametrize("builder", ["r1cs", "scs"])
def test_compiled_systems_match(name, builder):
    cs, ref = _compile(name, "bn254", builder)
    assert _plain(cs.commitments) == _plain(ref.commitments) and cs.commitments
    state = vars(cs) if builder == "scs" else cs.__getstate__()
    ref_state = vars(ref) if builder == "scs" else ref.__getstate__()
    assert {k: _plain(v) for k, v in state.items()} == \
        {k: _plain(v) for k, v in ref_state.items()}


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_groth16_keys_match(name):
    """The keys of both packages under one rng, the Pedersen proving and
    verifying keys and the committed-wire indices included."""
    cs, ref_cs = _compile(name, "bn254", "r1cs")
    curve, ref = CURVES["bn254"], ref_curve("bn254")
    pk, vk = groth16.setup(cs, curve, rng=random.Random(11), device="cpu")
    ref_pk, ref_vk = ref_g16.setup(ref_cs, ref, rng=random.Random(11), engine="host")
    assert len(pk.commitment_keys) == len(cs.commitments) > 0
    for ours, theirs in ((pk, ref_pk), (vk, ref_vk)):
        assert {k: _plain(v) for k, v in public_fields(ours).items()} == \
            {k: _plain(v) for k, v in public_fields(theirs).items()}


def _rejections(system, ref_system, proof, ref_vk, vk, pub, curve, ref, tampers):
    """Each tampered proof or public input is rejected by both verifiers
    (Groth16's tampered proof of knowledge and public input by the port's:
    the JAX verifier's pairings on them repeat its own tests at a few
    seconds each)."""
    for kind, bad in tampers.items():
        bad_pub = [(pub[0] + 1) % curve.fr.modulus] if kind == "public input" else pub
        bad = proof if bad is None else bad
        assert not system.is_valid(bad, vk, bad_pub, curve), kind
        if system is groth16 and kind in ("proof of knowledge", "public input"):
            continue
        assert not ref_system.is_valid(_to_ref(ref_system, bad, ref), ref_vk, bad_pub, ref), kind


def _to_ref(ref_system, proof, ref):
    if ref_system is ref_g16:
        return to_reference(proof, ref)
    return ref_plonk.Proof(**public_fields(proof))


# (curve, circuit, commitment hash, which verifiers run: "both" checks each
# package's verifier on the other's proof, "port" the port's on the JAX
# proof, "none" neither: ("evm", "sha256") differs from ("evm",
# "keccak256") only in the digest, whose port verify runs; BLS12-381's
# sha256 verify and BLS12-377's MiMC verify are BN254's at another width,
# and the card runs BLS12-381's)
G16_CASES = [("bn254", "commit_cubic", "sha256", "both"),
             ("bn254", "commit_cubic", ("mimc", "bn254_p"), "port"),
             ("bn254", "commit_cubic", ("evm", "sha256"), "none"),
             ("bn254", "commit_cubic", ("evm", "keccak256"), "port"),
             ("bls12_381", "two_commits", "sha256", "none"),
             ("bls12_377", "commit_private_only", ("mimc", "bw6_761_r"), "none")]


@pytest.mark.parametrize("curve_name, name, mode, verifiers", G16_CASES)
def test_groth16_proof_matches_reference(curve_name, name, mode, verifiers):
    cs, ref_cs = _compile(name, curve_name, "r1cs")
    curve, ref = CURVES[curve_name], ref_curve(curve_name)
    pub, sec = WITNESS[name]
    h = _hash(mode)
    pk, vk = groth16.setup(cs, curve, rng=random.Random(21), device="cpu")
    ref_pk, ref_vk = ref_g16.setup(ref_cs, ref, rng=random.Random(21), engine="host")
    proof = groth16.prove(cs, pk, pub, sec, curve, rng=random.Random(22), device="cpu",
                          commitment_hash=h, batch_msm=curve_name == "bls12_377"
                          or verifiers == "both")
    ref_proof = ref_g16.prove(ref_cs, ref_pk, pub, sec, ref, rng=random.Random(22),
                              engine="host", commitment_hash=h)
    assert len(proof.commitments) == len(cs.commitments)
    assert proof_to_bytes(ref, to_reference(proof, ref)) == proof_to_bytes(ref, ref_proof)
    if verifiers == "none":
        return
    groth16.verify(groth16.Proof.from_reference(ref_proof), vk, pub, curve, commitment_hash=h)
    if verifiers == "port":
        return
    ref_g16.verify(to_reference(proof, ref), ref_vk, pub, ref, commitment_hash=h)
    g1 = curve.g1
    _rejections(groth16, ref_g16, proof, ref_vk, vk, pub, curve, ref, {
        "commitment": dataclasses.replace(proof, commitments=[g1.generator]),
        "proof of knowledge": dataclasses.replace(
            proof, commitment_pok=g1.add(proof.commitment_pok, g1.generator)),
        "missing commitment": dataclasses.replace(proof, commitments=[]),
        "public input": None})


# (curve, circuit, commitment hash, fs_hash); the first case also holds the
# port's setup (the Qcp columns and their commitments) to the JAX
# package's and runs both verifiers and the tampered proofs, the others
# prove on the JAX keys carried over (ProvingKey.from_reference), and the
# second runs the port's verifier; it takes both MiMC options at once
PLONK_CASES = [("bn254", "commit_cubic", "sha256", "sha256"),
               ("bn254", "commit_cubic", ("mimc", "bn254_p"), "mimc"),
               ("bls12_377", "commit_private_only", ("mimc", "bw6_761_r"), "sha256")]


@pytest.mark.parametrize("curve_name, name, mode, fs_hash", PLONK_CASES)
def test_plonk_proof_matches_reference(curve_name, name, mode, fs_hash):
    cs, ref_cs = _compile(name, curve_name, "scs")
    curve, ref = CURVES[curve_name], ref_curve(curve_name)
    pub, sec = WITNESS[name]
    kw = {"commitment_hash": _hash(mode), "fs_hash": fs_hash}
    first = mode == "sha256" and fs_hash == "sha256"
    ref_pk, ref_vk = ref_plonk.setup(ref_cs, ref, rng=random.Random(31), engine="host")
    if first:
        pk, vk = plonk.setup(cs, curve, rng=random.Random(31), device="cpu")
        assert public_fields(vk) == public_fields(ref_vk)
        assert pk.trace_coeffs == ref_pk.trace_coeffs and "qcp0" in pk.trace_coeffs
    else:
        pk = plonk.ProvingKey.from_reference(ref_pk)
        vk = pk.vk
    proof = plonk.prove(cs, pk, pub, sec, curve, rng=random.Random(32), device="cpu",
                        batch_msm=True, **kw)
    ref_proof = ref_plonk.prove(ref_cs, ref_pk, pub, sec, ref, rng=random.Random(32),
                                engine="host", **kw)
    assert public_fields(proof) == public_fields(ref_proof)
    if curve_name != "bn254":
        return
    plonk.verify(plonk.Proof.from_reference(ref_proof), vk, pub, curve, **kw)
    if not first:
        return
    ref_plonk.verify(ref_plonk.Proof(**public_fields(proof)), ref_vk, pub, ref, **kw)
    g1 = curve.g1
    _rejections(plonk, ref_plonk, proof, ref_vk, vk, pub, curve, ref, {
        "commitment": dataclasses.replace(
            proof, bsb22_commitments=[g1.add(proof.bsb22_commitments[0], g1.generator)]),
        "missing commitment": dataclasses.replace(proof, bsb22_commitments=[]),
        "public input": None})
