"""The serving path of the port on the CPU: gnark-format artifacts in, a
resident prover, gnark-format bytes out.

The Cubic of tests/circuits.py (x³ + x + 5 = y) on BN254, for Groth16 and
PLONK: the constraint system goes through gnark's ``.r1cs``/``.scs`` and the
keys through their wire formats; ``Groth16Prover``/``PlonkProver`` bound to
what was read answer requests whose witnesses come from bytes, and each
proof's bytes equal those of a direct ``prove`` on the original system and
keys under the same rng (the JAX package's bytes for these are in
tests/test_torch_io.py). A proving key dumped after its device staging was
built loads without it and proves the same. Beside them: the provers'
device rule (none given and no card: RuntimeError; ``engine="host"``:
NotImplementedError), one ``DeviceCtx`` per (curve, device), and
``profile.device_trace`` writing a trace that holds an ``annotate`` region.
"""

import json
import os
import random

import pytest
import torch

from gnark_icicle_tpu.curves import bls24_315
from gnark_icicle_tpu_torch import frontend, profile
from gnark_icicle_tpu_torch.backend import groth16, plonk
from gnark_icicle_tpu_torch.backend.prover_service import Groth16Prover, PlonkProver
from gnark_icicle_tpu_torch.device import DeviceCtx
from gnark_icicle_tpu_torch.io import gnark_cs, keys, plonk_serialize, serialize

from test_torch_common import CURVE, CURVES, R, public_fields


class Cubic(frontend.Circuit):
    x = frontend.Secret()
    y = frontend.Public()

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(self.y, api.add(x3, self.x, 5))


# system -> (backend, builder, prover, .r1cs/.scs writer and reader, proof and
# vk encoders and decoders)
SYSTEMS = {
    "groth16": (groth16, "r1cs", Groth16Prover, gnark_cs.write_r1cs, gnark_cs.read_r1cs,
                serialize.proof_to_bytes, serialize.proof_from_bytes,
                serialize.vk_to_bytes, serialize.vk_from_bytes),
    "plonk": (plonk, "scs", PlonkProver, gnark_cs.write_scs, gnark_cs.read_scs,
              plonk_serialize.plonk_proof_to_bytes, plonk_serialize.plonk_proof_from_bytes,
              plonk_serialize.plonk_vk_to_bytes, plonk_serialize.plonk_vk_from_bytes),
}


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_served_proof_through_bytes_equals_the_direct_one(tmp_path, system):
    (backend, builder, Prover, write_cs, read_cs, proof_to, proof_from, vk_to,
     vk_from) = SYSTEMS[system]
    cs = frontend.compile_circuit(R, Cubic, builder=builder)
    served_cs = read_cs(write_cs(cs))
    pk, vk = backend.setup(cs, CURVE, rng=random.Random(1), device="cpu")
    read_vk, _ = vk_from(CURVE, vk_to(CURVE, vk))
    assert public_fields(read_vk) == public_fields(vk)
    served_pk = pk
    if system == "groth16":   # PLONK's proving key has no encoding in either package
        served_pk = keys.pk_from_bytes(CURVE, keys.pk_to_bytes(CURVE, pk))
        assert public_fields(served_pk) == public_fields(pk)

    prover = Prover(served_cs, served_pk, CURVE, device="cpu")
    assert prover.device == torch.device("cpu")
    pub, sec = serialize.witness_from_bytes(CURVE, serialize.witness_to_bytes(CURVE, [35], [3]))
    if system == "groth16":
        assert prover.warmup(pub, sec, rng=random.Random(9)) > 0
    data = proof_to(CURVE, prover.prove(pub, sec, rng=random.Random(7)))
    direct = backend.prove(cs, pk, [35], [3], CURVE, rng=random.Random(7), device="cpu")
    assert data == proof_to(CURVE, direct)
    got, off = proof_from(CURVE, data)
    assert off == len(data) and public_fields(got) == public_fields(direct)

    if system == "groth16":
        # the served key holds its CPU staging now; the dump leaves it out
        assert served_pk._device
        path = str(tmp_path / "pk.dump")
        keys.pk_write_dump(served_pk, path)
        assert served_pk._device
        dumped = keys.pk_read_dump(path)
        assert dumped._device == {}
        again = Groth16Prover(served_cs, dumped, CURVE, device="cpu")
        assert proof_to(CURVE, again.prove(pub, sec, rng=random.Random(7))) == data


@pytest.mark.parametrize("Prover", [Groth16Prover, PlonkProver])
def test_prover_device_rule(Prover):
    with pytest.raises(NotImplementedError, match="engine='device'"):
        Prover(None, None, CURVE, engine="host", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the prover would bind to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prover(None, None, CURVE)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_device_ctx_once_per_curve_and_device(curve):
    ctx = DeviceCtx(CURVES[curve], "cpu")
    assert DeviceCtx(CURVES[curve], torch.device("cpu")) is ctx
    assert DeviceCtx._cache[(CURVES[curve].name, torch.device("cpu"))] is ctx
    assert all(DeviceCtx(c, "cpu") is not ctx for n, c in CURVES.items() if n != curve)
    with pytest.raises(NotImplementedError):
        DeviceCtx(bls24_315.BLS24_315, "cpu")
    assert not any(k[0] == "bls24-315" for k in DeviceCtx._cache)


def test_device_trace_holds_the_annotated_region(tmp_path):
    with profile.device_trace(str(tmp_path), device="cpu") as trace:
        assert trace.path is None
        with profile.annotate("request"):
            torch.ones(64, dtype=torch.int64).cumsum(0)
    assert os.path.dirname(trace.path) == str(tmp_path) and os.path.isfile(trace.path)
    events = json.load(open(trace.path))["traceEvents"]
    region = [e for e in events if e.get("name") == "request"]
    assert len(region) == 1 and region[0]["cat"] == "user_annotation"
    inside = [e for e in events if e.get("name") == "aten::cumsum"]
    assert inside and region[0]["ts"] <= inside[0]["ts"] <= region[0]["ts"] + region[0]["dur"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with profile.device_trace(str(tmp_path / "none")):
                pass
