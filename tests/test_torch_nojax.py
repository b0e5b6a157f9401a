"""The port stands alone, and runs on the card unless asked for the CPU.

The machine with the card has no JAX, and the port imports nothing of the
JAX package either: a subprocess with ``jax`` and every ``gnark_icicle_tpu``
module blocked on ``sys.meta_path`` imports every module of the port and
runs a tiny compile → setup → prove → verify slice with the port's own
frontend and curves (the 2-chain's curves and std/ gadgets, the BSB22
copies, io/, the prover service, the ceremony, the Solidity exports and the
EVM interpreter are among the modules it imports; the slice's circuit has a
commitment and proves with batch_msm=True), then serves it: the system
through gnark's .r1cs, the key and the witness through their bytes, a
resident prover, and the proof's bytes, which are the direct proof's; then
the deploy path: a ceremony's keys prove a small circuit, whose exported
Groth16 contract accepts the proof in the EVM interpreter and reverts on a
tampered input, and a PLONK contract's export parses; then the emulated-field
layer (std/emulated.py and the EVM precompile modules among the imports): an
emulated product compiled and solved with the port's own hints; then the rollup
gadgets (std/eddsa.py, merkle.py, keccakf, sha3, gkr, fri, compress_lzss and the
others among the imports): chip_smoke.py's TransferCircuit at depth 2 compiled
and solved, an overdraft refused; then the host engine (the recursion verifiers,
the emulated pairings, BLS24-315, testing.py and stats.py among the imports):
the slice's circuit proved again with ``engine="host"``, to the device
engine's bytes (the multi-device layer, ``parallel/`` with its dry run, among
the imports). chip_smoke.py refuses to run without a GPU, and the entry
points raise where there is no card and no ``device="cpu"`` under their
default engines.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "gnark_icicle_tpu_torch"
# the files that run on the machine with the card
STANDALONE = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                            REPO / "tests" / "test_torch_cuda.py"])

SLICE = r'''
import importlib, pkgutil, random, secrets, sys

class Block:
    """jax, jaxlib and the JAX package (gnark_icicle_tpu and its modules)."""
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "gnark_icicle_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)  # the test run shares the machine among workers
import gnark_icicle_tpu_torch as port
for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(mod.name)
# the 2-chain's modules among them: its curves and the native gadgets; and
# KZG and PLONK with the transcript and point encoding they need
for name in ("curves.bls12_377", "curves.bw6_761", "std.algebra_native",
             "std.algebra_towers", "std.pairing_bls12_377",
             "std.recursion.native_groth16", "backend.kzg", "backend.transcript",
             "backend.plonk.keys", "backend.plonk.setup", "backend.plonk.prove",
             "backend.plonk.verify", "io.serialize", "backend.pedersen",
             "backend.hash_to_field", "std.hash.mimc", "io.cbor", "io.intcomp",
             "io.gnark_cs", "io.keys", "io.plonk_serialize", "backend.prover_service",
             "profile", "std.pedersen", "curves.hash_to_g2", "backend.groth16.mpcsetup",
             "backend.solidity", "backend.plonk_solidity", "backend.calldata", "evm",
             "std.math_cmp", "std.multicommit", "std.logderivlookup", "std.rangecheck",
             "std.emulated", "std.sw_emulated", "std.ecdsa", "std.math_bits", "std.hash.sha2",
             "std.pairing_bn254", "std.evmprecompiles", "curves.secp256k1",
             "curves.twisted_edwards", "std.eddsa", "std.merkle", "std.selector",
             "std.bitslice", "std.hash.keccakf", "std.hash.sha3", "std.fiat_shamir",
             "std.polynomial", "std.sumcheck", "std.gkr", "std.fri", "std.compress_lzss",
             "std.pairing_bls12_381", "std.pairing_bw6_761", "std.kzg_gadget",
             "std.recursion.groth16", "std.recursion.plonk", "std.recursion.native_plonk",
             "backend.groth16.host_compute", "backend.plonk.host_engine", "curves.bls24_315",
             "testing", "stats", "parallel", "parallel.mesh", "parallel.msm", "parallel.ntt",
             "parallel.pipeline", "parallel.dryrun"):
    assert "gnark_icicle_tpu_torch." + name in sys.modules, name

from gnark_icicle_tpu_torch.curves import bn254
from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret, compile_circuit
from gnark_icicle_tpu_torch.backend import groth16

R, STEPS = bn254.R, 12

class Chain(Circuit):
    x = Secret()
    out = Public()

    def define(self, api):
        v = self.x
        for i in range(STEPS):
            v = api.add(api.mul(v, v), v, i)
        api.assert_is_different(api.commit(self.x, v), 0)   # BSB22
        api.assert_is_equal(v, self.out)

v = 3
for i in range(STEPS):
    v = (v * v + v + i) % R
secrets.randbelow = lambda m: 0x5EED % m   # the commitment's hiding mask, fixed
cs = compile_circuit(R, Chain)
pk, vk = groth16.setup(cs, bn254.BN254, rng=random.Random(1), device="cpu")
proof = groth16.prove(cs, pk, [v], [3], bn254.BN254, rng=random.Random(2),
                      device="cpu", batch_msm=True)
groth16.verify(proof, vk, [v], bn254.BN254)
assert not groth16.is_valid(proof, vk, [v + 1], bn254.BN254)
# the host engine: the same proof, with no device
from gnark_icicle_tpu_torch.io import serialize
hproof = groth16.prove(cs, pk, [v], [3], bn254.BN254, rng=random.Random(2), engine="host")
assert serialize.proof_to_bytes(bn254.BN254, hproof) == serialize.proof_to_bytes(bn254.BN254, proof)

# the serving path: the system, the key and the witness from bytes, a
# resident prover, the proof in bytes: the direct proof's
from gnark_icicle_tpu_torch.backend.prover_service import Groth16Prover
from gnark_icicle_tpu_torch.io import gnark_cs, keys, serialize

served = Groth16Prover(gnark_cs.read_r1cs(gnark_cs.write_r1cs(cs)),
                       keys.pk_from_bytes(bn254.BN254, keys.pk_to_bytes(bn254.BN254, pk)),
                       bn254.BN254, device="cpu")
pub, sec = serialize.witness_from_bytes(bn254.BN254,
                                        serialize.witness_to_bytes(bn254.BN254, [v], [3]))
data = serialize.proof_to_bytes(bn254.BN254, served.prove(pub, sec, rng=random.Random(2)))
assert data == serialize.proof_to_bytes(bn254.BN254, proof)
assert serialize.proof_from_bytes(bn254.BN254, data)[1] == len(data)
# the deploy path: a ceremony's keys, a proof, the Solidity verifier run in
# the EVM interpreter; the PLONK export parses
from gnark_icicle_tpu_torch import evm
from gnark_icicle_tpu_torch.backend import calldata, plonk
from gnark_icicle_tpu_torch.backend.groth16.mpcsetup import Phase1, Phase2
from gnark_icicle_tpu_torch.backend.plonk_solidity import export_plonk_solidity
from gnark_icicle_tpu_torch.backend.solidity import export_solidity

class Square(Circuit):
    x = Secret()
    y = Public()

    def define(self, api):
        api.assert_is_equal(api.mul(self.x, self.x), self.y)

sq = compile_circuit(R, Square)
rng = random.Random(5)
p1 = Phase1.init(bn254.BN254, 2)
p1.contribute(rng=rng)
p2 = Phase2.init(p1, sq)
p2.contribute(rng=rng)
mpk, mvk = p2.finalize()
mproof = groth16.prove(sq, mpk, [9], [3], bn254.BN254, rng=rng, device="cpu")
groth16.verify(mproof, mvk, [9], bn254.BN254)
contract = evm.load_contract(export_solidity(mvk, bn254.BN254))
contract.call_calldata("verifyProof", calldata.encode(calldata.groth16_args(mproof, [9])))
try:
    contract.call("verifyProof", *calldata.groth16_args(mproof, [10]))
    raise AssertionError("the contract accepted a tampered input")
except evm.Revert as e:
    assert e.error == "ProofInvalid", e.error
_, pvk = plonk.setup(compile_circuit(R, Square, builder="scs"), bn254.BN254,
                     rng=random.Random(6), device="cpu")
assert evm.load_contract(export_plonk_solidity(pvk, bn254.BN254)).functions["verifyProof"]
# the emulated-field layer: a secp256k1 product compiled and solved by the
# native solver (its hints, the deferred mulcheck and the range table's
# commitment the port's own), a wrong product refused
from gnark_icicle_tpu_torch.constraint.solver import UnsatisfiedConstraintError, solve
from gnark_icicle_tpu_torch.std.emulated import SECP256K1_FP, EmulatedField

class EmulMul(Circuit):
    x = Secret(shape=4)
    y = Secret(shape=4)
    z = Public(shape=4)

    def define(self, api):
        f = EmulatedField(api, SECP256K1_FP, R)
        f.assert_equal(f.mul(f.from_limbs(self.x), f.from_limbs(self.y)), f.from_limbs(self.z))

def limbs(v):
    return [(v >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]

ecs = compile_circuit(R, EmulMul)
a, b, p = 3 ** 150, 5 ** 100, SECP256K1_FP.modulus
solve(ecs, *EmulMul(x=limbs(a % p), y=limbs(b % p), z=limbs(a * b % p)).witness_values(R))
try:
    solve(ecs, *EmulMul(x=limbs(a % p), y=limbs(b % p),
                        z=limbs((a * b + 1) % p)).witness_values(R))
    raise AssertionError("the solver accepted a wrong emulated product")
except UnsatisfiedConstraintError:
    pass
# the rollup gadgets: chip_smoke.py's TransferCircuit at depth 2 (EdDSA over
# Baby Jubjub, MiMC paths) compiled and solved on an operator's transfer
# (examples/rollup.py Operator.transfer over the port's host modules), an
# overdraft refused
import chip_smoke
from gnark_icicle_tpu_torch.curves import twisted_edwards as te
from gnark_icicle_tpu_torch.std.hash.mimc import MiMCHost
from gnark_icicle_tpu_torch.std.merkle import MerkleTreeHost

def mimc(*values):
    h = MiMCHost(R)
    h.write(*values)
    return h.h

keys = [te.generate_key(f"acct{i}".encode()) for i in range(4)]
tree = MerkleTreeHost(R, [mimc(k.public[0], k.public[1], 1000, 0) for k in keys])

def transfer(amount):
    a, b = keys[0].public, keys[1].public
    sig_r, sig_s = te.sign(keys[0], mimc(a[0], b[0], amount, 0))
    sibs, dirs = tree.proof(0)
    after = MerkleTreeHost(R, [l for l in tree.levels[0]])
    after.update(0, mimc(a[0], a[1], 1000 - amount, 1))
    rsibs, rdirs = after.proof(1)
    after.update(1, mimc(b[0], b[1], 1000 + amount, 0))
    return dict(root_before=tree.root, root_after=after.root, sender_pub_x=a[0],
                sender_pub_y=a[1], receiver_pub_x=b[0], receiver_pub_y=b[1],
                sender_balance=1000, sender_nonce=0, receiver_balance=1000, receiver_nonce=0,
                amount=amount, sig_rx=sig_r[0], sig_ry=sig_r[1], sig_s=sig_s,
                sender_sibs=sibs, sender_dirs=dirs, receiver_sibs=rsibs, receiver_dirs=rdirs)

Transfer, _ = chip_smoke.rollup_circuits(2, 1)
tcs = compile_circuit(R, Transfer)
assert tcs.nb_constraints == 21_351, tcs.nb_constraints
solve(tcs, *Transfer(**transfer(250)).witness_values(R))
try:
    solve(tcs, *Transfer(**transfer(1001)).witness_values(R))
    raise AssertionError("the solver accepted an overdraft")
except UnsatisfiedConstraintError:
    pass
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "gnark_icicle_tpu"))
assert not leaked, leaked
print("SLICE-OK")
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", SLICE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SLICE-OK" in out.stdout


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert files
    for f in files:
        assert not pat.search(f.read_text()), f


@pytest.mark.parametrize("path", STANDALONE, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_package_import_in_standalone_sources(path):
    pat = re.compile(r"^\s*(import|from)\s+gnark_icicle_tpu(?!_torch)\b", re.M)
    assert not pat.search(path.read_text()), path


def test_chip_smoke_refuses_without_gpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, shutil.copy(REPO / "chip_smoke.py", tmp_path))):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env={**os.environ, "PYTHONPATH": ""},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("entry", ["setup", "prove", "DeviceCtx", "msm_host", "plonk.setup",
                                   "plonk.prove", "KZG.commit", "unsafe_srs", "Groth16Prover",
                                   "PlonkProver", "device_trace", "dryrun", "rank_device"])
def test_entry_points_raise_without_cuda(entry):
    """No device given and no card: every entry point raises instead of
    running the plain versions on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")
    from gnark_icicle_tpu_torch import profile
    from gnark_icicle_tpu_torch.backend import groth16, plonk
    from gnark_icicle_tpu_torch.backend.kzg import KZG, unsafe_srs
    from gnark_icicle_tpu_torch.backend.prover_service import Groth16Prover, PlonkProver
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.device import DeviceCtx
    from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret, compile_circuit
    from gnark_icicle_tpu_torch.ops.ec_t import TCurve
    from gnark_icicle_tpu_torch.ops.field import field_for
    from gnark_icicle_tpu_torch.ops.msm import msm_host
    from gnark_icicle_tpu_torch.parallel.dryrun import dryrun
    from gnark_icicle_tpu_torch.parallel.mesh import rank_device

    class Square(Circuit):
        x = Secret()
        out = Public()

        def define(self, api):
            api.assert_is_equal(api.mul(self.x, self.x), self.out)

    curve = bn254.BN254
    calls = {
        "setup": lambda: groth16.setup(compile_circuit(bn254.R, Square), curve),
        "prove": lambda: groth16.prove(compile_circuit(bn254.R, Square), None,
                                       [9], [3], curve, device=None),
        "DeviceCtx": lambda: DeviceCtx(curve, None),
        "msm_host": lambda: msm_host(TCurve(field_for(bn254.P), 9), curve.fr,
                                     [curve.g1.generator], [5]),
        "plonk.setup": lambda: plonk.setup(compile_circuit(bn254.R, Square, builder="scs"),
                                           curve),
        "plonk.prove": lambda: plonk.prove(compile_circuit(bn254.R, Square, builder="scs"),
                                           None, [9], [3], curve),
        "KZG.commit": lambda: KZG(curve, unsafe_srs(curve, 4, tau=5, device="cpu"))
                              .commit([1, 2]),
        "unsafe_srs": lambda: unsafe_srs(curve, 4, tau=5),
        "Groth16Prover": lambda: Groth16Prover(compile_circuit(bn254.R, Square), None, curve),
        "PlonkProver": lambda: PlonkProver(compile_circuit(bn254.R, Square, builder="scs"),
                                           None, curve),
        "device_trace": lambda: profile.device_trace("unused").__enter__(),
        "dryrun": lambda: dryrun(2),
        "rank_device": lambda: rank_device(None, local_rank=0),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
