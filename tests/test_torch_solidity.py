"""The port's Solidity exports and EVM interpreter, held to the JAX package's.

Small BN254 circuits (x³ + x + 5 = y, and the same with one api.commit)
are set up and proved by the port on the CPU, through Groth16 (plain, and
committed with the EVM hash ("evm", "keccak256")) and PLONK (plain and
BSB22). Each verifying key goes to the JAX package field by field, so that
both exports read the same key:

- the contracts' texts are equal;
- the port's interpreter accepts the port's proofs and raises ``Revert`` on
  each tamper, and the JAX package's interpreter gives the same result on
  the same source and calldata, the custom error included;
- the precompiles 0x05-0x08 return the same bytes on seeded inputs, among
  them a point off the curve, a coordinate ≥ p and a G2 point outside the
  subgroup.
"""

import dataclasses
import importlib
import random

import numpy as np
import pytest

from gnark_icicle_tpu_torch import evm
from gnark_icicle_tpu_torch.backend import calldata, groth16, plonk
from gnark_icicle_tpu_torch.backend.plonk_solidity import export_plonk_solidity
from gnark_icicle_tpu_torch.backend.solidity import export_solidity
from gnark_icicle_tpu_torch.curves import bn254
from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret, compile_circuit

CURVE = bn254.BN254
Q, P = bn254.R, bn254.P


class Cubic(Circuit):
    x = Secret()
    y = Public()

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(self.y, api.add(x3, self.x, 5))


class CommitCubic(Circuit):
    x = Secret()
    y = Public()

    def define(self, api):
        c = api.commit(self.x, self.y)
        api.assert_is_different(c, 0)
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(self.y, api.add(x3, self.x, 5))


# contract id -> (backend, circuit, builder, commitment hash, export's hash_fn)
CONTRACTS = {
    "groth16": (groth16, Cubic, "r1cs", None, "sha256"),
    "groth16_commit": (groth16, CommitCubic, "r1cs", ("evm", "keccak256"), "keccak256"),
    "plonk": (plonk, Cubic, "scs", None, None),
    "plonk_bsb22": (plonk, CommitCubic, "scs", None, None),
}


def to_jax(v, tower):
    """A port value as the JAX package's: its dataclasses (keys, Pedersen
    keys) as the class of the same name and module there, field by field,
    and every Fp2 as the JAX package's Fp2."""
    from gnark_icicle_tpu.curves.tower import Fp2

    if dataclasses.is_dataclass(v):
        mod = importlib.import_module(type(v).__module__.replace(
            "gnark_icicle_tpu_torch", "gnark_icicle_tpu"))
        return getattr(mod, type(v).__name__)(**{
            f.name: to_jax(getattr(v, f.name), tower)
            for f in dataclasses.fields(v) if not f.name.startswith("_")})
    if hasattr(v, "c0"):
        return Fp2(tower, v.c0, v.c1)
    if isinstance(v, (tuple, list)):
        return type(v)(to_jax(x, tower) for x in v)
    if isinstance(v, dict):
        return {k: to_jax(x, tower) for k, x in v.items()}
    return v


def ref_curve():
    from gnark_icicle_tpu.curves import bn254 as ref_bn254

    return ref_bn254.BN254


@pytest.fixture(scope="module")
def artifacts():
    """Each contract's (vk, proof, contract source), made by the port on the
    CPU; lazily, so that a test of one contract proves only its circuit."""
    made = {}

    def get(name):
        if name not in made:
            backend, circuit, builder, h, hash_fn = CONTRACTS[name]
            cs = compile_circuit(Q, circuit, builder=builder)
            kw = {"commitment_hash": h} if h else {}
            pk, vk = backend.setup(cs, CURVE, rng=random.Random(60), device="cpu")
            proof = backend.prove(cs, pk, [35], [3], CURVE, rng=random.Random(61),
                                  device="cpu", **kw)
            backend.verify(proof, vk, [35], CURVE, **kw)
            src = (export_solidity(vk, CURVE, hash_fn) if backend is groth16
                   else export_plonk_solidity(vk, CURVE))
            made[name] = (vk, proof, src)
        return made[name]

    return get


LAYOUTS = {"groth16": [8, 1], "groth16_commit": [8, 2, 2, 1], "plonk": [25, 1],
           "plonk_bsb22": [28, 1]}


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_calldata_layouts(artifacts, name):
    """25 + 3·nb_commitments PLONK words; Groth16's eight, then the
    commitment and its proof of knowledge; encode is 32 bytes a word."""
    args = (calldata.groth16_args if CONTRACTS[name][0] is groth16
            else calldata.plonk_args)(artifacts(name)[1], [35])
    assert [len(a) for a in args] == LAYOUTS[name]
    assert len(calldata.encode(args)) == 32 * sum(LAYOUTS[name])


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_export_text_matches(artifacts, name):
    from gnark_icicle_tpu.backend.plonk_solidity import export_plonk_solidity as ref_plonk
    from gnark_icicle_tpu.backend.solidity import export_solidity as ref_groth16

    vk, _, src = artifacts(name)
    rc = ref_curve()
    ref_vk = to_jax(vk, rc.tower)
    assert type(ref_vk).__module__.startswith("gnark_icicle_tpu.")
    want = (ref_groth16(ref_vk, rc, CONTRACTS[name][4]) if CONTRACTS[name][0] is groth16
            else ref_plonk(ref_vk, rc))
    assert src == want


def _double(pt):
    return list(CURVE.g1.add(tuple(pt), tuple(pt)))


# contract id -> case -> a function of verifyProof's arguments (None: the
# untampered proof)
def _tamper(arg, fn):
    """Replace argument ``arg`` by ``fn`` of it."""
    def run(args):
        out = [list(a) for a in args]
        out[arg] = fn(out[arg])
        return out
    return run


def _set(i, fn):
    return lambda words: words[:i] + [fn(words[i])] + words[i + 1:]


TAMPERS = {
    "groth16": {
        "valid": None,
        "input_plus_one": _tamper(-1, _set(0, lambda w: w + 1)),
        "proof_word_plus_one": _tamper(0, _set(0, lambda w: (w + 1) % P)),
        "input_not_in_field": _tamper(-1, _set(0, lambda w: Q)),
    },
    "groth16_commit": {
        "valid": None,
        "pok_doubled": _tamper(2, _double),
        "commitment_doubled": _tamper(1, _double),
    },
    "plonk": {
        "valid": None,
        "z_shifted_plus_one": _tamper(0, _set(24, lambda w: (w + 1) % Q)),
        "batch_opening_off_curve": _tamper(0, _set(14, lambda w: (w + 1) % P)),
    },
    "plonk_bsb22": {
        "valid": None,
        "commitment_plus_generator": _tamper(0, lambda w: w[:26] + list(
            CURVE.g1.add((w[26], w[27]), CURVE.g1.generator))),
    },
}
CASES = [(name, case) for name in sorted(TAMPERS) for case in TAMPERS[name]]


def _outcome(mod, src, args, raw: bool):
    """None where the contract accepts; the Revert's error where it
    reverts (the module's own Revert: any other exception fails)."""
    contract = mod.load_contract(src)
    try:
        if raw:
            contract.call_calldata("verifyProof", calldata.encode(args))
        else:
            contract.call("verifyProof", *args)
    except mod.Revert as e:
        return ("revert", e.error)
    return None


@pytest.mark.parametrize("name,case", CASES, ids=[f"{n}-{c}" for n, c in CASES])
def test_contract_results_match(artifacts, name, case):
    from gnark_icicle_tpu import evm as ref_evm

    _, proof, src = artifacts(name)
    args = (calldata.groth16_args if CONTRACTS[name][0] is groth16
            else calldata.plonk_args)(proof, [35])
    tamper = TAMPERS[name][case]
    if tamper is not None:
        args = tamper(args)
    raw = case == "valid"       # the untampered proof through the ABI bytes
    got = _outcome(evm, src, args, raw)
    assert got == _outcome(ref_evm, src, args, raw)
    if tamper is None:
        assert got is None
    else:
        assert got is not None and got[0] == "revert"


# -- the precompiles -----------------------------------------------------------

def _words(*ints) -> bytes:
    return b"".join(int(c).to_bytes(32, "big") for c in ints)


def _twist_point_outside_subgroup(seed: int):
    """A point of BN254's twist whose order is not r: y² = x³ + b′ solved
    for x from a seed, its cofactor not cleared."""
    from gnark_icicle_tpu_torch.curves.hash_to_g2 import _sqrt_fp2
    from gnark_icicle_tpu_torch.curves.tower import Fp2

    rng = np.random.default_rng(seed)
    while True:
        x = Fp2(bn254.TOWER, int(rng.integers(1, 1 << 62)), int(rng.integers(1, 1 << 62)))
        y = _sqrt_fp2(x * x * x + CURVE.g2.b)
        if y is not None and not CURVE.g2.in_subgroup((x, y)):
            return x, y


def _g2_words(q):
    return (q[0].c1, q[0].c0, q[1].c1, q[1].c0)


def _precompile_inputs() -> list:
    """(address, input bytes): seeded valid inputs and the failures."""
    rng = np.random.default_rng(7)
    g1, g2 = CURVE.g1, CURVE.g2
    k = [int(v) for v in rng.integers(1, 1 << 62, size=6)]
    a = g1.scalar_mul(g1.generator, k[0])
    b = g1.scalar_mul(g1.generator, k[1])
    h = g2.scalar_mul(g2.generator, k[2])
    big = [int.from_bytes(rng.bytes(32), "big") for _ in range(3)]
    cases = [
        (5, _words(32, 32, 32, big[0], big[1], Q)),
        (5, _words(1, 32, 2, 3) + bytes([7]) + big[2].to_bytes(32, "big") + b"\x01\x00"),
        (5, _words(32, 32, 32, big[0], big[1], 0)),
        (6, _words(*a, *b)),
        (6, _words(*a, *g1.neg(a))),
        (6, _words(0, 0, *b)),
        (6, _words(*a, b[0], (b[1] + 1) % P)),                    # off the curve
        (6, _words(a[0] + P, a[1], *b)),                          # coordinate ≥ p
        (6, _words(*a)[:40]),                                     # short input
        (7, _words(*a, big[0])),
        (7, _words(*a, Q)),
        (7, _words(a[0], (a[1] + 1) % P, 5)),                     # off the curve
        (7, _words(a[0], a[1] + P, 5)),                           # coordinate ≥ p
        (8, b""),
        (8, _words(*a, *_g2_words(h)) + _words(*g1.neg(a), *_g2_words(h))),
        (8, _words(*a, *_g2_words(h)) + _words(*b, *_g2_words(h))),
        (8, _words(*a, *_g2_words(h))[:191]),                     # not 192 bytes a pair
        (8, _words(*a, *_g2_words(_twist_point_outside_subgroup(11)))),
        (8, _words(*a, h[0].c1 + P, h[0].c0, h[1].c1, h[1].c0)),  # coordinate ≥ p
        (8, _words(*a, h[0].c1, h[0].c0, h[1].c1, (h[1].c0 + 1) % P)),   # off the twist
        (8, _words(0, 0, *_g2_words(h)) + _words(*a, 0, 0, 0, 0)),       # infinities
    ]
    return cases


def test_precompiles_match():
    from gnark_icicle_tpu import evm as ref_evm

    seen = {"ok": 0, "failed": 0}
    for addr, data in _precompile_inputs():
        got = evm._precompile(addr, data)
        assert got == ref_evm._precompile(addr, data), (addr, data.hex())
        seen["failed" if got is None else "ok"] += 1
    assert seen["failed"] >= 7 and seen["ok"] >= 10
