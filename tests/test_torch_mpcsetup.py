"""The port's Groth16 MPC ceremony, held to the JAX package's.

One ceremony a package on BN254 at n = 4 (x³ + x + 5 = y, three
constraints), as the JAX package's tests run it: two phase-1 and two
phase-2 contributions under one seeded rng. Each accumulator's state hash
equals the JAX package's after each step, the final keys are equal field
for field, and a port prove with the ceremony's key verifies under both
packages' verifiers. ``verify`` draws its coefficients from
``secrets.randbits``, so it is compared by its pass or fail only: it passes
on the port's ceremony, and both packages refuse a replaced ladder point, a
contribution replayed from another ceremony and an unbound δ.
``hash_to_g2`` equals the original on seeded messages.
"""

import dataclasses
import importlib
import random

import numpy as np
import pytest

from gnark_icicle_tpu_torch.curves import bls12_381, bn254

PKGS = {"port": "gnark_icicle_tpu_torch", "jax": "gnark_icicle_tpu"}
N = 4
CONTRIBUTIONS = 2


def _mods(pkg: str):
    base = PKGS[pkg]
    return (importlib.import_module(base + ".frontend"),
            importlib.import_module(base + ".curves.bn254"),
            importlib.import_module(base + ".backend.groth16.mpcsetup"))


def _cubic(fe):
    class Cubic(fe.Circuit):
        x = fe.Secret()
        y = fe.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))

    return Cubic


def _ceremony(pkg: str) -> dict:
    fe, bn, mpc = _mods(pkg)
    rng = random.Random(90)
    cs = fe.compile_circuit(bn.R, _cubic(fe))
    p1 = mpc.Phase1.init(bn.BN254, N)
    hashes = [p1.state_hash()]
    for _ in range(CONTRIBUTIONS):
        p1.contribute(rng=rng)
        hashes.append(p1.state_hash())
    p2 = mpc.Phase2.init(p1, cs)
    hashes2 = [p2.state_hash()]
    for _ in range(CONTRIBUTIONS):
        p2.contribute(rng=rng)
        hashes2.append(p2.state_hash())
    pk, vk = p2.finalize()
    return {"cs": cs, "p1": p1, "p2": p2, "pk": pk, "vk": vk, "phase1": hashes,
            "phase2": hashes2, "mpc": mpc, "curve": bn.BN254}


@pytest.fixture(scope="module")
def ceremonies():
    return {pkg: _ceremony(pkg) for pkg in PKGS}


@pytest.mark.parametrize("phase", ["phase1", "phase2"])
def test_state_hashes_match(ceremonies, phase):
    port, ref = ceremonies["port"][phase], ceremonies["jax"][phase]
    assert len(port) == CONTRIBUTIONS + 1
    assert len(set(port)) == len(port)      # each contribution moved the state
    assert port == ref


def _plain(v):
    """Keys and transcripts as plain data: dataclasses and dicts as dicts of
    their public fields, Fp2 as pairs of ints."""
    if dataclasses.is_dataclass(v):
        v = {k: x for k, x in vars(v).items() if not k.startswith("_")}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if hasattr(v, "c0"):
        return (v.c0, v.c1)
    if isinstance(v, (tuple, list)):
        return type(v)(_plain(x) for x in v)
    return v


@pytest.mark.parametrize("key", ["pk", "vk"])
def test_finalized_keys_match(ceremonies, key):
    port, ref = ceremonies["port"][key], ceremonies["jax"][key]
    assert type(port).__module__.startswith("gnark_icicle_tpu_torch.")
    names = [f.name for f in dataclasses.fields(port) if not f.name.startswith("_")]
    assert names == [f.name for f in dataclasses.fields(ref) if not f.name.startswith("_")]
    for name in names:
        assert _plain(getattr(port, name)) == _plain(getattr(ref, name)), name


def test_contributions_match(ceremonies):
    """The transcript: each contribution's challenge, hashes and knowledge
    proofs."""
    for phase in ("p1", "p2"):
        port = ceremonies["port"][phase].contributions
        ref = ceremonies["jax"][phase].contributions
        assert len(port) == len(ref) == CONTRIBUTIONS
        assert _plain(port) == _plain(ref), phase


@pytest.mark.parametrize("phase", ["p1", "p2"])
def test_verify_passes(ceremonies, phase):
    ceremonies["port"][phase].verify()


def _copy(p):
    """A phase's accumulator with its own lists and contribution records."""
    out = dataclasses.replace(p, contributions=[dict(w) for w in p.contributions])
    for f in dataclasses.fields(p):
        v = getattr(out, f.name)
        if isinstance(v, list) and f.name != "contributions":
            setattr(out, f.name, list(v))
    return out


def _replaced_ladder_point(cer):
    p1 = _copy(cer["p1"])
    p1.tau_g1[2] = cer["curve"].g1.add(p1.tau_g1[2], cer["curve"].g1.generator)
    return p1


def _replayed_contribution(cer):
    """Another ceremony's second contribution (valid in itself, bound to
    that ceremony's transcript) in place of this one's first."""
    other = cer["mpc"].Phase1.init(cer["curve"], N)
    rng = random.Random(93)
    for _ in range(2):
        other.contribute(rng=rng)
    p1 = _copy(cer["p1"])
    p1.contributions[0] = dict(other.contributions[1])
    return p1


def _unbound_delta(cer):
    g1, g2 = cer["curve"].g1, cer["curve"].g2
    p2 = _copy(cer["p2"])
    p2.delta_g1 = g1.scalar_mul(g1.generator, 777)
    p2.delta_g2 = g2.scalar_mul(g2.generator, 777)
    return p2


TAMPERS = {"replaced_ladder_point": (_replaced_ladder_point, "ladder"),
           "replayed_contribution": (_replayed_contribution, "transcript"),
           "unbound_delta": (_unbound_delta, "delta")}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("tamper", sorted(TAMPERS))
def test_verify_refuses(ceremonies, pkg, tamper):
    make, match = TAMPERS[tamper]
    with pytest.raises(ValueError, match=match):
        make(ceremonies[pkg]).verify()


def test_mpc_key_proves_and_verifies_in_both_packages(ceremonies):
    from gnark_icicle_tpu.backend import groth16 as ref_groth16
    from gnark_icicle_tpu_torch.backend import groth16

    from test_torch_common import to_reference

    cer = ceremonies["port"]
    curve = cer["curve"]
    pk = cer["pk"]
    proof = groth16.prove(cer["cs"], pk, [35], [3], curve, rng=random.Random(7),
                          device="cpu")
    assert "cpu" in {str(d) for d in pk._device}      # staged, cached as setup's keys
    groth16.verify(proof, cer["vk"], [35], curve)
    assert not groth16.is_valid(proof, cer["vk"], [36], curve)
    ref_curve = ceremonies["jax"]["curve"]
    ref_groth16.verify(to_reference(proof, ref_curve), to_reference(cer["vk"], ref_curve),
                       [35], ref_curve)


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_hash_to_g2_matches(curve):
    from gnark_icicle_tpu.curves import bls12_381 as ref_bls381
    from gnark_icicle_tpu.curves import bn254 as ref_bn254
    from gnark_icicle_tpu.curves.hash_to_g2 import hash_to_g2 as ref_hash
    from gnark_icicle_tpu_torch.curves.hash_to_g2 import hash_to_g2

    c, rc = {"bn254": (bn254.BN254, ref_bn254.BN254),
             "bls12_381": (bls12_381.BLS12_381, ref_bls381.BLS12_381)}[curve]
    rng = np.random.default_rng(5)
    for length, dst in ((0, 1), (32, 2), (97, 3)):
        msg = rng.bytes(length)
        got = hash_to_g2(c, msg, bytes([dst]))
        assert c.g2.is_on_curve(got) and c.g2.in_subgroup(got)
        assert _plain(got) == _plain(ref_hash(rc, msg, bytes([dst])))
