"""The port's Groth16 slice (gnark_icicle_tpu_torch.backend.groth16) against
the JAX package on a Chain circuit (bench.py's benchmark circuit, cut in
depth), one case per curve: about 300 constraints on BN254 (a 2^9 domain), 65
on BLS12-381 and BLS12-377 (2^7: setup's G1 products take the fixed-base
ladder; BLS12-377's Fp2 has u² = −5) and 63 on BW6-761 (2^6, with 257 G1
setup products, so the ladder runs at 24 words too; its G2 lies over Fp).
Same rng, same keys, same h, same proof bytes; the JAX verifier accepts the
port's proof; both verifiers reject a tampered public input. Each side
compiles the circuit with its own frontend and proves over its own curve
objects; the JAX side proves with its host engine.
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

# Chain steps and the domain they give, per curve
STEPS = {"bn254": 300, "bls12_381": 64, "bls12_377": 64, "bw6_761": 62}
LOG_N = {"bn254": 9, "bls12_381": 7, "bls12_377": 7, "bw6_761": 6}


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


_SLICES: dict = {}


def _slice(curve_name):
    """Both packages' setup and prove of one curve's Chain (cached: each
    worker builds a curve's slice once)."""
    if curve_name in _SLICES:
        return _SLICES[curve_name]
    steps = STEPS[curve_name]
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
    _SLICES[curve_name] = dict(
        name=curve_name, cs=cs, ref_cs=ref_cs, pub=pub, sec=sec, pk=pk, vk=vk,
        ref_pk=ref_pk, ref_vk=ref_vk, proof=proof, ref_proof=ref_proof,
        curve=curve, ref=ref, steps=steps)
    return _SLICES[curve_name]


@pytest.fixture(scope="module")
def slice_run():
    """The BN254 slice, for the tests that need one curve."""
    return _slice("bn254")


@pytest.fixture(scope="module", params=sorted(STEPS))
def run(request):
    """One case per curve."""
    return _slice(request.param)


def test_circuit_size(run):
    n = run["cs"].nb_constraints
    assert n > run["steps"] and run["pk"].domain_log_n == LOG_N[run["name"]]
    assert 1 << (LOG_N[run["name"]] - 1) < n <= 1 << LOG_N[run["name"]]
    if run["name"] == "bn254":
        assert 300 <= n < 512


@pytest.mark.parametrize("key", ["pk", "vk"])
def test_setup_matches_reference(run, key):
    assert _fields(run[key]) == _fields(run["ref_" + key])


def test_compute_h_matches_host(run):
    cs, pk, curve = run["cs"], run["pk"], run["curve"]
    res = solve(cs, run["pub"], run["sec"])
    ctx = DeviceCtx(curve, "cpu")
    n = 1 << pk.domain_log_n
    W = ctx.fr.n32
    h = _compute_h(ctx, solved_u32(res, "a", W), solved_u32(res, "b", W),
                   solved_u32(res, "c", W), pk.domain_log_n)
    want = z_scalars_bitreversed(
        compute_h_host(res.a, res.b, res.c, pk.domain_log_n, run["ref"].fr),
        pk.domain_log_n, n)
    assert ctx.fr.decode_plain(h) == want


def _proof_bytes(run, proof) -> bytes:
    """The JAX package's proof serialisation; for BW6-761, whose G2 lies
    over Fp and which that serialiser does not cover, the raw coordinates
    (Ar, Bs, Krs), each big-endian in the 96 bytes of a 761-bit element."""
    ref = run["ref"]
    if run["name"] != "bw6_761":
        return proof_to_bytes(ref, proof)
    return b"".join(c.to_bytes(96, "big") for pt in (proof.ar, proof.bs, proof.krs)
                    for c in pt)


def test_proof_matches_reference_bytes(run):
    proof, ref_proof, ref = run["proof"], run["ref_proof"], run["ref"]
    assert _fields(proof) == _fields(ref_proof)
    assert _proof_bytes(run, to_reference(proof, ref)) == _proof_bytes(run, ref_proof)


def test_jax_verifier_accepts_port_proof(run):
    ref = run["ref"]
    ref_g16.verify(to_reference(run["proof"], ref), run["ref_vk"], run["pub"], ref)
    groth16.verify(run["proof"], run["vk"], run["pub"], run["curve"])


def test_tampered_public_input_rejected_by_both(run):
    ref, curve = run["ref"], run["curve"]
    bad = [(run["pub"][0] + 1) % curve.fr.modulus]
    assert not groth16.is_valid(run["proof"], run["vk"], bad, curve)
    assert not ref_g16.is_valid(to_reference(run["proof"], ref), run["ref_vk"],
                                bad, ref)


@pytest.mark.parametrize("name", ["ProvingKey", "VerifyingKey", "Proof"])
def test_dataclass_fields_match_reference(name):
    ours = [f.name for f in dataclasses.fields(getattr(groth16, name))]
    theirs = [f.name for f in dataclasses.fields(getattr(ref_g16, name))]
    assert ours == theirs


def test_key_carry_roundtrip(run):
    """Keys carried from the JAX package equal the port's own, field by
    field (BW6-761's g2_* fields hold Fp coordinates, BLS12-377's Fp2 has
    u² = −5), so one rng proves the same proof from either."""
    ref = run["ref"]
    pk = groth16.ProvingKey.from_reference(run["ref_pk"])
    assert _fields(pk) == _fields(run["pk"])
    assert _fields(to_reference(pk, ref)) == _fields(run["ref_pk"])
    assert isinstance(to_reference(run["vk"], ref), ref_g16.VerifyingKey)
    assert isinstance(pk.g2_beta[0], int) == (run["name"] == "bw6_761")


@pytest.mark.parametrize("kw", [{"engine": "tpu"}])
def test_unported_options_raise(slice_run, kw):
    """An engine other than "device" and "host" (the host engine is ported)
    does not exist."""
    with pytest.raises(ValueError):
        groth16.prove(slice_run["cs"], slice_run["pk"], slice_run["pub"],
                      slice_run["sec"], CURVE, device="cpu", **kw)


def test_unported_setup_engine_raises(slice_run):
    with pytest.raises(ValueError):
        groth16.setup(slice_run["cs"], CURVE, engine="tpu", device="cpu")


def test_unported_curve_raises():
    """BLS24-315 (G2 over Fp4, no device form) is not ported."""
    from gnark_icicle_tpu.curves import bls24_315

    with pytest.raises(NotImplementedError):
        DeviceCtx(bls24_315.BLS24_315, "cpu")


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
        got = repack32_to_16(solved_u32(res, name, 8))
        want = getattr(ref_res, name + "_u16")()
        assert (got == want).all(), name
        assert (getattr(res, name + "_u16")() == want).all(), name
