"""The port's KZG and PLONK slice (gnark_icicle_tpu_torch.backend.{kzg,plonk})
against the JAX package, on the CPU with the plain versions of the kernels.

- Module by module: the 4n coset transforms (``Domain.coset_ntt_nat`` and
  ``coset_intt_nat``) and ``mont_inv`` limb for limb against the JAX
  package's ``Domain`` and ``LimbField``; the quotient
  (``plonk_quotient_plain`` through ``_quotient_device``) against the JAX
  host engine's ``quotient_host`` on all four curves, and on BN254 against
  the JAX ``_quotient_device`` itself, run on the CPU as tests/test_plonk.py
  runs it; KZG ``commit`` and ``open`` against the JAX ``KZG`` on one SRS,
  and ``unsafe_srs``'s fixed-base ladder against the JAX host SRS.
- The slice: a Chain circuit (bench.py's PLONK circuit, cut in depth) at a
  2^5 domain on BN254 and 2^3 on the others. The JAX package's host engine
  sets it up (its keys and SRS carried to the port with ``from_reference``)
  and proves it; the port proves it under the same rng. The proof bytes are
  equal (``io/plonk_serialize.plonk_proof_to_bytes``), both verifiers accept
  the proof and both reject a tampered public input. On BN254 the port's
  own setup gives the JAX package's keys. The JAX package's device and host
  engines give one proof under one rng (the KZG and quotient checks above
  hold the pieces where they differ in form), so the host engine is the
  reference here.
- BW6-761: the JAX transcript binds every field element in 32 bytes
  (backend/transcript.py:54), which raises OverflowError for a 377-bit
  value above 2^256; the port binds gnark-crypto's 48 (ROADMAP §C). Its
  BW6-761 case runs the JAX package with that one method widened to 48
  bytes (``_ref_fr_width``), so that there is a reference proof to hold
  the port's to.

The plain MSM's Horner takes about a second per commitment on BN254 and
more at 12 and 24 words, so each curve proves once (module scope) and the
port's setup runs on BN254 only; the card runs it on every curve
(chip_smoke.py).
"""

import contextlib
import dataclasses
import importlib
import random

import numpy as np
import pytest
import torch

from gnark_icicle_tpu import frontend as ref_frontend
from gnark_icicle_tpu.backend import plonk as ref_plonk
from gnark_icicle_tpu.backend import transcript as ref_transcript
from gnark_icicle_tpu.backend.kzg import KZG as RefKZG
from gnark_icicle_tpu.backend.kzg import unsafe_srs as ref_unsafe_srs
from gnark_icicle_tpu.backend.plonk.host_engine import quotient_host
from gnark_icicle_tpu.io.plonk_serialize import plonk_proof_to_bytes
from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu.ops.ntt import domain_for as ref_domain_for
from gnark_icicle_tpu_torch import frontend
from gnark_icicle_tpu_torch.backend import plonk
from gnark_icicle_tpu_torch.backend.kzg import KZG, SRS, unsafe_srs
from gnark_icicle_tpu_torch.backend.plonk.prove import _quotient_device
from gnark_icicle_tpu_torch.device import DeviceCtx
from gnark_icicle_tpu_torch.ops.field import field_for
from gnark_icicle_tpu_torch.ops.field_t import QUOTIENT_INPUTS, TField
from gnark_icicle_tpu_torch.ops.ntt import domain_for

from test_torch_common import (
    CURVES, lanes_to_ref, public_fields as _fields, rand_ints, ref_curve,
)

# Chain steps (about 3 gates each) and the domain they give, per curve
STEPS = {"bn254": 8, "bls12_381": 2, "bls12_377": 2, "bw6_761": 2}
LOG_N = {"bn254": 5, "bls12_381": 3, "bls12_377": 3, "bw6_761": 3}


def chain_circuit(fe, steps: int):
    """x_{i+1} = x_i² + x_i + i, as bench.py:359 bench_plonk, over ``fe``."""

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


@contextlib.contextmanager
def _ref_fr_width(curve_name: str):
    """The JAX transcript with field elements bound in gnark-crypto's
    fr.Bytes: 48 for BW6-761's r (the JAX package's 32 overflow); nothing
    changes for the other curves."""
    if curve_name != "bw6_761":
        yield
        return

    def bind_fr(self, name, v):
        self.bind(name, int(v % self.q).to_bytes(48, "big"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_transcript.GnarkTranscript, "bind_fr", bind_fr)
        yield


_SLICES: dict = {}


def _slice(curve_name):
    """One curve's Chain: the JAX host engine's setup and prove, and the
    port's prove with the carried keys (cached per worker)."""
    if curve_name in _SLICES:
        return _SLICES[curve_name]
    steps = STEPS[curve_name]
    curve, ref = CURVES[curve_name], ref_curve(curve_name)
    q = curve.fr.modulus
    cs = frontend.compile_circuit(q, chain_circuit(frontend, steps), builder="scs")
    ref_cs = ref_frontend.compile_circuit(q, chain_circuit(ref_frontend, steps),
                                          builder="scs")
    pub, sec = _witness(q, steps)
    with _ref_fr_width(curve_name):
        ref_pk, ref_vk = ref_plonk.setup(ref_cs, ref, rng=random.Random(1), engine="host")
        ref_proof = ref_plonk.prove(ref_cs, ref_pk, pub, sec, ref, rng=random.Random(2),
                                    engine="host")
    pk = plonk.ProvingKey.from_reference(ref_pk)
    vk = plonk.VerifyingKey.from_reference(ref_vk)
    proof = plonk.prove(cs, pk, pub, sec, curve, rng=random.Random(2), device="cpu")
    _SLICES[curve_name] = dict(
        name=curve_name, cs=cs, ref_cs=ref_cs, pub=pub, sec=sec, pk=pk, vk=vk,
        ref_pk=ref_pk, ref_vk=ref_vk, proof=proof, ref_proof=ref_proof,
        curve=curve, ref=ref)
    return _SLICES[curve_name]


@pytest.fixture(scope="module", params=sorted(STEPS))
def run(request):
    """One case per curve."""
    return _slice(request.param)


@pytest.fixture(scope="module")
def bn254_run():
    return _slice("bn254")


def _to_ref_proof(proof):
    return ref_plonk.Proof(**_fields(proof))


# -- modules -------------------------------------------------------------------

@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_coset_transforms_match_reference(curve, log_n=5):
    """The 4n coset forms of PLONK, on the 4n domain of a 2^3 circuit."""
    q = CURVES[curve].fr.modulus
    ref = ref_domain_for(ref_field_for(q), ref_curve(curve).fr, log_n, coset=True)
    port = domain_for(field_for(q), CURVES[curve].fr, log_n, "cpu", coset=True)
    x = field_for(q).encode(rand_ints(log_n, q, 1 << log_n), "cpu")
    for name in ("coset_ntt_nat", "coset_intt_nat"):
        want = np.asarray(getattr(ref, name)(np.array(lanes_to_ref(x))))
        np.testing.assert_array_equal(lanes_to_ref(getattr(port, name)(x)), want, name)
    back = port.coset_intt_nat(port.coset_ntt_nat(x))
    assert torch.equal(back, x)


@pytest.mark.parametrize("curve", ["bn254", "bw6_761"])
def test_mont_inv_matches_limbfield(curve):
    """The port's batch inverse (``TField.mont_inv``: ``fr_batch_inv`` on the
    card, its plain version here) against the JAX ``LimbField.mont_inv``,
    zeros inside and at the end included."""
    q = CURVES[curve].fr.modulus
    vals = rand_ints(11, q, 12)        # 0, 1, q − 1 and random values
    vals[5], vals[6], vals[-1] = 0, q - 2, 0
    F = field_for(q)
    x = F.encode(vals, "cpu")
    got = TField(F).mont_inv(x)
    want = np.asarray(ref_field_for(q).mont_inv(lanes_to_ref(x)))
    np.testing.assert_array_equal(lanes_to_ref(got), want)
    assert F.decode(got) == [pow(v, -1, q) if v else 0 for v in vals]
    assert F.decode(F.mont_pow(x, 5)) == [pow(v, 5, q) for v in vals]


def test_field_predicates():
    F = field_for(CURVES["bn254"].fr.modulus)
    a = F.encode([0, 1, 2], "cpu")
    b = F.encode([0, 3, 2], "cpu")
    assert F.is_zero(a).tolist() == [True, False, False]
    assert F.eq(a, b).tolist() == [True, False, True]
    mask = torch.tensor([False, True, False])
    assert F.decode(F.select(mask, a, b)) == [0, 1, 2]


def _quotient_case(curve_name, log_n, seed):
    """Random 4n evaluations and challenges (numpy seed) for the quotient."""
    curve = CURVES[curve_name]
    q = curve.fr.modulus
    n = 1 << log_n
    ev = {k: rand_ints(seed + i, q, 4 * n, edge=(i % 3 == 0))
          for i, k in enumerate(QUOTIENT_INPUTS)}
    beta, gamma, alpha = rand_ints(seed + 99, q, 3, edge=False)
    g = curve.fr.multiplicative_generator
    return ev, n, beta, gamma, alpha, g, g * g % q


def _port_quotient(curve_name, ev, n, beta, gamma, alpha, k1, k2):
    curve = CURVES[curve_name]
    ctx = DeviceCtx(curve, "cpu")
    log_n = n.bit_length() - 1
    dom4 = ctx.domain(log_n + 2, coset=True)
    ev_dev = {k: ctx.fr.encode(v, "cpu") for k, v in ev.items()}
    t = _quotient_device(ctx, dom4, ev_dev, n, beta, gamma, alpha, k1, k2,
                         curve.fr.multiplicative_generator,
                         curve.fr.root_of_unity(log_n + 2), curve.fr.modulus)
    return t, ctx


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_quotient_matches_host_engine(curve):
    ev, n, beta, gamma, alpha, k1, k2 = _quotient_case(curve, 3, 20)
    t, ctx = _port_quotient(curve, ev, n, beta, gamma, alpha, k1, k2)
    want = quotient_host(ev, n, beta, gamma, alpha, k1, k2, ref_curve(curve).fr)
    assert ctx.fr.decode(t) == want


def test_quotient_matches_jax_device_engine():
    """BN254 against the JAX package's own _quotient_device (its jnp row
    function and Fermat tables on XLA:CPU), limb for limb."""
    from gnark_icicle_tpu.backend.plonk.prove import _quotient_device as ref_quotient
    from gnark_icicle_tpu.device import DeviceCtx as RefCtx

    ev, n, beta, gamma, alpha, k1, k2 = _quotient_case("bn254", 3, 40)
    t, _ = _port_quotient("bn254", ev, n, beta, gamma, alpha, k1, k2)
    ref = ref_curve("bn254")
    rctx = RefCtx(ref)
    F = rctx.fr_dev
    ref_ev = {k: F.encode(v) for k, v in ev.items()}
    q = ref.fr.modulus
    want = ref_quotient(rctx, rctx.domain(5, coset=True), ref_ev, n, beta, gamma, alpha,
                        k1, k2, ref.fr.multiplicative_generator, ref.fr.root_of_unity(5), q)
    np.testing.assert_array_equal(lanes_to_ref(t), np.asarray(want))


@pytest.mark.parametrize("log_n", [3, 4])
def test_quotient_tables_match_reference(monkeypatch, log_n):
    """BN254: the port's quotient tables (xs, L1 and the cycle of 1/Z_H,
    ``_quotient_tables``, its batch inverse the plain version on the CPU)
    against the JAX package's ``_quotient_tables`` on a coset shift from a
    numpy seed, limb for limb (the JAX tables tile 1/Z_H to 4n rows). Both
    packages cache the tables per (q, n), so the test gives each a fresh
    cache."""
    from gnark_icicle_tpu.device import DeviceCtx as RefCtx

    ref_prove = importlib.import_module("gnark_icicle_tpu.backend.plonk.prove")
    port_prove = importlib.import_module("gnark_icicle_tpu_torch.backend.plonk.prove")
    monkeypatch.setattr(ref_prove, "_DOMAIN_TABLES", {})
    monkeypatch.setattr(port_prove, "_DOMAIN_TABLES", {})
    curve = CURVES["bn254"]
    q = curve.fr.modulus
    n = 1 << log_n
    g = rand_ints(70 + log_n, q, 1, edge=False)[0]
    eta = curve.fr.root_of_unity(log_n + 2)
    xs, l1, zh_inv = port_prove._quotient_tables(DeviceCtx(curve, "cpu"), n, g, eta, q)
    want = ref_prove._quotient_tables(RefCtx(ref_curve("bn254")), None, n, g, eta, q)
    for got, ref in zip((xs, l1), want[:2], strict=True):
        np.testing.assert_array_equal(lanes_to_ref(got), np.asarray(ref).astype(np.int32))
    np.testing.assert_array_equal(np.tile(lanes_to_ref(zh_inv), (n, 1)),
                                  np.asarray(want[2]).astype(np.int32))
    F = field_for(q)
    assert F.decode(xs) == [g * pow(eta, i, q) % q for i in range(4 * n)]


def test_plonk_quotient_plain_cycles_zh_by_row():
    """1/Z_H comes from its (W, 4) cycle by row mod 4, the kernel's rule."""
    from gnark_icicle_tpu_torch.ops.field_t import QUOTIENT_CONSTS, plonk_quotient_plain

    q = CURVES["bn254"].fr.modulus
    F = field_for(q)
    m = 8
    zeros = [F.encode([0] * m, "cpu") for _ in QUOTIENT_INPUTS]
    qk = F.encode(list(range(1, m + 1)), "cpu")
    zeros[QUOTIENT_INPUTS.index("qk")] = qk
    consts = F.encode([0] * (len(QUOTIENT_CONSTS) - 1) + [1], "cpu")
    zh = F.encode([2, 3, 5, 7], "cpu")
    got = F.decode(plonk_quotient_plain(F, zeros, zeros[0], zeros[0], zh, consts))
    assert got == [(i + 1) * [2, 3, 5, 7][i % 4] % q for i in range(m)]


def test_kzg_commit_and_open_match_reference():
    """BN254: the port's KZG on the JAX package's SRS (carried) against the
    JAX KZG, whose MSM runs on XLA:CPU."""
    curve, ref = CURVES["bn254"], ref_curve("bn254")
    q = curve.fr.modulus
    ref_srs = ref_unsafe_srs(ref, 40, tau=987654321, engine="host")
    srs = SRS.from_reference(ref_srs)
    coeffs = rand_ints(60, q, 35)
    port, jax_kzg = KZG(curve, srs, "cpu"), RefKZG(ref, ref_srs)
    # a commitment of 34 coefficients and the opening of 35 (its quotient
    # has 34): one MSM size, one XLA:CPU compile
    assert port.commit(coeffs[:34]) == jax_kzg.commit(coeffs[:34])
    value, proof = port.open(coeffs, 77)
    assert (value, proof) == jax_kzg.open(coeffs, 77)
    assert value == sum(c * pow(77, i, q) for i, c in enumerate(coeffs)) % q
    com = port.commit(coeffs)
    assert port.verify(com, 77, value, proof)
    assert not port.verify(com, 77, value + 1, proof)


def test_unsafe_srs_ladder_matches_reference():
    """256 powers and more take the fixed-base ladder (its plain version
    here); the JAX host SRS from the same τ has the same points."""
    curve, ref = CURVES["bn254"], ref_curve("bn254")
    srs = unsafe_srs(curve, 260, tau=424242, device="cpu")
    want = ref_unsafe_srs(ref, 260, tau=424242, engine="host")
    assert srs.g1_powers == want.g1_powers
    assert (srs.g2_gen, srs.g2_tau) == (want.g2_gen, want.g2_tau)


# -- the slice -------------------------------------------------------------------

def test_circuit_size(run):
    assert run["pk"].log_n == LOG_N[run["name"]]
    assert run["cs"].nb_gates == run["ref_cs"].nb_gates


def _proof_bytes(run, proof) -> bytes:
    return plonk_proof_to_bytes(run["ref"], proof)


def test_proof_matches_reference_bytes(run):
    proof, ref_proof = run["proof"], run["ref_proof"]
    assert _fields(proof) == _fields(ref_proof)
    with _ref_fr_width(run["name"]):
        assert _proof_bytes(run, _to_ref_proof(proof)) == _proof_bytes(run, ref_proof)


def test_both_verifiers_accept(run):
    plonk.verify(run["proof"], run["vk"], run["pub"], run["curve"])
    with _ref_fr_width(run["name"]):
        ref_plonk.verify(_to_ref_proof(run["proof"]), run["ref_vk"], run["pub"], run["ref"])


def test_tampered_public_input_rejected_by_both(run):
    bad = [(run["pub"][0] + 1) % run["curve"].fr.modulus]
    assert not plonk.is_valid(run["proof"], run["vk"], bad, run["curve"])
    with _ref_fr_width(run["name"]):
        assert not ref_plonk.is_valid(_to_ref_proof(run["proof"]), run["ref_vk"], bad,
                                      run["ref"])


def test_key_carry(run):
    """from_reference carries every public field; the SRS and G2 points
    come over as the port's objects."""
    pk, ref_pk = run["pk"], run["ref_pk"]
    assert isinstance(pk.srs, SRS) and isinstance(pk.vk, plonk.VerifyingKey)
    assert pk.srs.g1_powers == ref_pk.srs.g1_powers
    assert pk.srs.g2_tau == ref_pk.srs.g2_tau
    for name in ("trace_coeffs", "log_n", "k1", "k2"):
        assert getattr(pk, name) == getattr(ref_pk, name)
    assert (pk.sigma == ref_pk.sigma).all()
    assert _fields(run["vk"]) == _fields(run["ref_vk"])


def test_port_setup_matches_reference(bn254_run):
    """BN254: the port's own setup under the JAX run's rng gives its keys."""
    r = bn254_run
    pk, vk = plonk.setup(r["cs"], r["curve"], rng=random.Random(1), device="cpu")
    assert _fields(vk) == _fields(r["ref_vk"])
    assert pk.trace_coeffs == r["ref_pk"].trace_coeffs
    assert (pk.sigma == r["ref_pk"].sigma).all()
    assert pk.srs.g1_powers == r["ref_pk"].srs.g1_powers


@pytest.mark.parametrize("name", ["ProvingKey", "VerifyingKey", "Proof"])
def test_dataclass_fields_match_reference(name):
    ours = [f.name for f in dataclasses.fields(getattr(plonk, name))]
    theirs = [f.name for f in dataclasses.fields(getattr(ref_plonk, name))]
    assert ours == theirs


@pytest.mark.parametrize("option", ["engine", "setup_engine"])
def test_unported_options_raise(bn254_run, option):
    r = bn254_run
    args = (r["cs"], r["pk"], r["pub"], r["sec"], r["curve"])
    calls = {
        "engine": lambda: plonk.prove(*args, engine="host", device="cpu"),
        "setup_engine": lambda: plonk.setup(r["cs"], r["curve"], engine="host",
                                            device="cpu"),
    }
    with pytest.raises(NotImplementedError):
        calls[option]()
