"""The port's Groth16 slice (gnark_icicle_tpu_torch.backend.groth16) against
the JAX package on a Chain circuit (bench.py's benchmark circuit, cut in
depth): about 300 constraints on BN254 and 65 on BLS12-381 (a 2^7 domain, so
that setup's G1 products take the fixed-base ladder). Same rng, same keys,
same h, same proof bytes; the JAX verifier accepts the port's proof; both
verifiers reject a tampered public input. Each side compiles the circuit
with its own frontend and proves over its own curve objects.
"""

import dataclasses
import random

import pytest

from gnark_icicle_tpu.backend import groth16 as ref_g16
from gnark_icicle_tpu.backend.groth16.host_compute import (
    compute_h_host, z_scalars_bitreversed,
)
from gnark_icicle_tpu.constraint.solver import solve as ref_solve
from gnark_icicle_tpu import frontend as ref_frontend
from gnark_icicle_tpu.io.serialize import proof_to_bytes
from gnark_icicle_tpu_torch import frontend
from gnark_icicle_tpu_torch.backend import groth16
from gnark_icicle_tpu_torch.backend.groth16.prove import _compute_h
from gnark_icicle_tpu_torch.constraint.solver import solve, solved_u32
from gnark_icicle_tpu_torch.device import DeviceCtx

from test_torch_common import (
    CURVE, CURVES, R, public_fields as _fields, ref_curve, to_reference,
)

STEPS = 300
STEPS_BLS = 64
BLS = "bls12_381"


def chain_circuit(fe, steps: int):
    """x_{i+1} = x_i² + x_i + i, as bench.py:431-439, over frontend ``fe``."""

    class Chain(fe.Circuit):
        x = fe.Secret()
        out = fe.Public()

        def define(self, api):
            v = self.x
            for i in range(steps):
                v = api.add(api.mul(v, v), v, i)
            api.assert_is_equal(v, self.out)

    return Chain


def _witness(q, steps, x0=3):
    v = x0
    for i in range(steps):
        v = (v * v + v + i) % q
    return [v], [x0]


def _slice(curve_name, steps):
    curve, ref = CURVES[curve_name], ref_curve(curve_name)
    q = curve.fr.modulus
    cs = frontend.compile_circuit(q, chain_circuit(frontend, steps))
    ref_cs = ref_frontend.compile_circuit(q, chain_circuit(ref_frontend, steps))
    pub, sec = _witness(q, steps)
    pk, vk = groth16.setup(cs, curve, rng=random.Random(1), device="cpu")
    ref_pk, ref_vk = ref_g16.setup(ref_cs, ref, rng=random.Random(1),
                                   engine="host")
    proof = groth16.prove(cs, pk, pub, sec, curve, rng=random.Random(2),
                          device="cpu")
    ref_proof = ref_g16.prove(ref_cs, ref_pk, pub, sec, ref,
                              rng=random.Random(2), engine="host")
    return dict(cs=cs, ref_cs=ref_cs, pub=pub, sec=sec, pk=pk, vk=vk,
                ref_pk=ref_pk, ref_vk=ref_vk, proof=proof, ref_proof=ref_proof,
                curve=curve, ref=ref, steps=steps)


@pytest.fixture(scope="module")
def slice_run():
    return _slice("bn254", STEPS)


@pytest.fixture(scope="module")
def slice_run_bls12_381():
    return _slice(BLS, STEPS_BLS)


def test_circuit_size(slice_run):
    assert 300 <= slice_run["cs"].nb_constraints < 512


def test_circuit_size_bls12_381(slice_run_bls12_381):
    run = slice_run_bls12_381
    assert 64 < run["cs"].nb_constraints <= 128
    assert run["pk"].domain_log_n == 7


@pytest.mark.parametrize("key", ["pk", "vk"])
def test_setup_matches_reference(slice_run, key):
    assert _fields(slice_run[key]) == _fields(slice_run["ref_" + key])


@pytest.mark.parametrize("key", ["pk", "vk"])
def test_setup_matches_reference_bls12_381(slice_run_bls12_381, key):
    test_setup_matches_reference(slice_run_bls12_381, key)


def test_compute_h_matches_host(slice_run):
    cs, pk, curve = slice_run["cs"], slice_run["pk"], slice_run["curve"]
    res = solve(cs, slice_run["pub"], slice_run["sec"])
    ctx = DeviceCtx(curve, "cpu")
    n = 1 << pk.domain_log_n
    h = _compute_h(ctx, solved_u32(res, "a"), solved_u32(res, "b"),
                   solved_u32(res, "c"), pk.domain_log_n)
    want = z_scalars_bitreversed(
        compute_h_host(res.a, res.b, res.c, pk.domain_log_n,
                       slice_run["ref"].fr),
        pk.domain_log_n, n)
    assert ctx.fr.decode_plain(h) == want


def test_compute_h_matches_host_bls12_381(slice_run_bls12_381):
    test_compute_h_matches_host(slice_run_bls12_381)


def test_proof_matches_reference_bytes(slice_run):
    proof, ref_proof = slice_run["proof"], slice_run["ref_proof"]
    ref = slice_run["ref"]
    assert _fields(proof) == _fields(ref_proof)
    assert proof_to_bytes(ref, to_reference(proof, ref)) == \
        proof_to_bytes(ref, ref_proof)


def test_proof_matches_reference_bytes_bls12_381(slice_run_bls12_381):
    test_proof_matches_reference_bytes(slice_run_bls12_381)


def test_jax_verifier_accepts_port_proof(slice_run):
    ref = slice_run["ref"]
    ref_g16.verify(to_reference(slice_run["proof"], ref), slice_run["ref_vk"],
                   slice_run["pub"], ref)
    groth16.verify(slice_run["proof"], slice_run["vk"], slice_run["pub"],
                   slice_run["curve"])


def test_jax_verifier_accepts_port_proof_bls12_381(slice_run_bls12_381):
    test_jax_verifier_accepts_port_proof(slice_run_bls12_381)


def test_tampered_public_input_rejected_by_both(slice_run):
    ref, curve = slice_run["ref"], slice_run["curve"]
    bad = [(slice_run["pub"][0] + 1) % curve.fr.modulus]
    assert not groth16.is_valid(slice_run["proof"], slice_run["vk"], bad, curve)
    assert not ref_g16.is_valid(to_reference(slice_run["proof"], ref),
                                slice_run["ref_vk"], bad, ref)


def test_tampered_public_input_rejected_by_both_bls12_381(slice_run_bls12_381):
    test_tampered_public_input_rejected_by_both(slice_run_bls12_381)


@pytest.mark.parametrize("name", ["ProvingKey", "VerifyingKey", "Proof"])
def test_dataclass_fields_match_reference(name):
    ours = [f.name for f in dataclasses.fields(getattr(groth16, name))]
    theirs = [f.name for f in dataclasses.fields(getattr(ref_g16, name))]
    assert ours == theirs


def test_key_carry_roundtrip(slice_run):
    ref = slice_run["ref"]
    pk = groth16.ProvingKey.from_reference(slice_run["ref_pk"])
    assert _fields(pk) == _fields(slice_run["pk"])
    assert _fields(to_reference(pk, ref)) == _fields(slice_run["ref_pk"])
    assert isinstance(to_reference(slice_run["vk"], ref), ref_g16.VerifyingKey)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"checkpoint_dir": "x"},
                                {"engine": "host"}])
def test_unported_options_raise(slice_run, kw):
    with pytest.raises(NotImplementedError):
        groth16.prove(slice_run["cs"], slice_run["pk"], slice_run["pub"],
                      slice_run["sec"], CURVE, device="cpu", **kw)


def test_unported_setup_engine_raises(slice_run):
    with pytest.raises(NotImplementedError):
        groth16.setup(slice_run["cs"], CURVE, engine="host", device="cpu")


def test_unported_curve_raises():
    from gnark_icicle_tpu_torch.curves import bls12_377

    with pytest.raises(NotImplementedError):
        DeviceCtx(bls12_377.BLS12_377, "cpu")


def test_copied_setup_helpers_match_reference(slice_run):
    import importlib

    from gnark_icicle_tpu_torch.ops.ec import _batch_inv

    # the packages export a setup() function under the module's name
    ref_setup = importlib.import_module("gnark_icicle_tpu.backend.groth16.setup")
    port_setup = importlib.import_module(
        "gnark_icicle_tpu_torch.backend.groth16.setup")

    cs = slice_run["ref_cs"]
    n = 1 << slice_run["pk"].domain_log_n
    omega = CURVE.fr.root_of_unity(slice_run["pk"].domain_log_n)
    tau = 123456789
    assert port_setup.qap_evaluations(cs, tau, n, omega) == \
        ref_setup.qap_evaluations(cs, tau, n, omega)
    xs = [3, 5, R - 1, 7 ** 40 % R]
    assert _batch_inv(xs, R) == ref_setup._batch_inv(xs, R)
    for m in (2, 3, 300, 512, 513):
        assert port_setup._next_pow2_log(m) == ref_setup._next_pow2_log(m)
    pts = list(range(n - 1))
    assert port_setup._bit_reverse_list(pts, n) == \
        ref_setup._bit_reverse_list(pts, n)


@pytest.mark.parametrize("native", [True, False])
def test_solved_u32_matches_solver_u16(slice_run, native):
    from gnark_icicle_tpu_torch.ops.field import repack32_to_16

    res = solve(slice_run["cs"], slice_run["pub"], slice_run["sec"],
                native=native)
    ref_res = ref_solve(slice_run["ref_cs"], slice_run["pub"],
                        slice_run["sec"], native=native)
    for name in ("wires", "a", "b", "c"):
        got = repack32_to_16(solved_u32(res, name))
        want = getattr(ref_res, name + "_u16")()
        assert (got == want).all(), name
        assert (getattr(res, name + "_u16")() == want).all(), name
