"""Prover stage checkpoint/resume in the port's Groth16 and PLONK, on the
CPU, in the sequence of the JAX package's tests/test_checkpoint.py: the
stage files a prove leaves, a resume that is re-randomized and verifies, a
partial resume after the last stage's file is deleted, and a different
public input that invalidates the stages (a Groth16 resume is
re-randomized; PLONK draws its blinding inside its stages, so its full
resume gives the first proof again). Beside them: a prove resumed from
the last stage (Groth16 ``msms.pkl``, PLONK ``quotient.pkl``) under the
uninterrupted prove's rng gives its proof byte for byte, and the binding
bytes are the JAX package's. Circuits: the Cubic of tests/circuits.py (x³ +
x + 5 = y) over each package's frontend, BN254.
"""

import dataclasses
import hashlib
import os
import random

import pytest

from gnark_icicle_tpu_torch import frontend
from gnark_icicle_tpu_torch.backend import groth16, plonk

from test_torch_common import CURVE, R


class Cubic(frontend.Circuit):
    x = frontend.Secret()
    y = frontend.Public()

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(self.y, api.add(x3, self.x, 5))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


SYSTEMS = {"groth16": (groth16, "r1cs", ["binding", "h.pkl", "msms.pkl", "solve.pkl"],
                       "msms.pkl"),
           "plonk": (plonk, "scs", ["binding", "quotient.pkl", "round1.pkl", "round2.pkl",
                                    "solve.pkl"], "quotient.pkl")}


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_checkpoint_resume_and_binding(tmp_path, system):
    mod, builder, files, last = SYSTEMS[system]
    cs = frontend.compile_circuit(R, Cubic, builder=builder)
    pk, vk = mod.setup(cs, CURVE, rng=random.Random(41), device="cpu")
    d = str(tmp_path / "ck")

    def prove(pub, sec, seed):
        return mod.prove(cs, pk, pub, sec, CURVE, rng=random.Random(seed), device="cpu",
                         checkpoint_dir=d)

    p1 = prove([35], [3], 42)
    assert sorted(os.listdir(d)) == files

    # a full resume under the first prove's rng: the same proof, byte for byte
    assert _fields(prove([35], [3], 42)) == _fields(p1)
    # a resume under another rng: stages load and the proof verifies; Groth16
    # draws its blinding after the last stage, so it is fresh, while PLONK's
    # blinding is drawn inside its stages, which hold it
    p2 = prove([35], [3], 43)
    mod.verify(p2, vk, [35], CURVE)
    if system == "groth16":
        assert p2.ar != p1.ar
    else:
        assert _fields(p2) == _fields(p1)

    # partial preemption: drop the last stage only, the earlier ones reused
    os.unlink(os.path.join(d, last))
    p3 = prove([35], [3], 42)
    assert _fields(p3) == _fields(p1)
    assert sorted(os.listdir(d)) == files

    # a different proving task must not reuse stale stages
    p4 = prove([73], [4], 45)
    mod.verify(p4, vk, [73], CURVE)


def test_checkpoint_bindings_are_the_references():
    """The stage files are bound by the JAX package's bytes (a sha256 of the
    task), so a directory carries between the packages' provers."""
    from gnark_icicle_tpu.backend.groth16.prove import _Checkpoint as RefCheckpoint
    from gnark_icicle_tpu_torch.backend.groth16.prove import _Checkpoint, _binding
    from gnark_icicle_tpu_torch.backend.plonk.prove import _binding as plonk_binding

    cs = frontend.compile_circuit(R, Cubic)
    pk, _ = groth16.setup(cs, CURVE, rng=random.Random(41), device="cpu")
    nb = 32
    want = hashlib.sha256(
        b"g16ck" + cs.nb_constraints.to_bytes(8, "big") + pk.domain_log_n.to_bytes(2, "big")
        + repr("sha256").encode() + (35).to_bytes(nb, "big") + b"|sec|"
        + (3).to_bytes(nb, "big")).digest()
    assert _binding(cs, pk, R, "sha256", [35], [3]) == want
    scs = frontend.compile_circuit(R, Cubic, builder="scs")
    ppk, _ = plonk.setup(scs, CURVE, rng=random.Random(41), device="cpu")
    want = hashlib.sha256(
        b"plonkck" + scs.nb_gates.to_bytes(8, "big") + ppk.log_n.to_bytes(2, "big")
        + b"sha256" + repr("sha256").encode() + (35).to_bytes(nb, "big") + b"|sec|"
        + (3).to_bytes(nb, "big")).digest()
    assert plonk_binding(scs, ppk, R, "sha256", "sha256", [35], [3]) == want
    assert [m for m in vars(_Checkpoint) if not m.startswith("__")] == \
        [m for m in vars(RefCheckpoint) if not m.startswith("__")]
