"""The port's multi-device layer (gnark_icicle_tpu_torch/parallel/, the
``mesh=`` prove, the batched Domain transforms) against the JAX package, on
the CPU.

The ranks are the port's dry run (``parallel/dryrun.py``) at d = 2 (the
proof's MSMs data-parallel on the whole mesh) and d = 8 (sub-meshes of two
ranks), spawned on ``device="cpu"`` over gloo, with JAX and the JAX package
blocked in every rank. What the ranks wrote is held here to the JAX package,
exactly: the sharded NTT's limbs (2^6 at d = 2, 2^8 at d = 8; forward and
inverse) to the single-device ``Domain.ntt``/``intt``, repacked; each
sharded MSM's affine point (G1 and G2, an infinity point and a zero scalar
among them; at d = 8 the four sub-meshes' dispatches of 37 padded rows) to
``bn254.G1.msm``/``G2.msm``; and the sharded proofs of a Chain and of a
Chain with one ``api.commit`` (its hiding mask fixed) to the JAX package's
single-device ``groth16.prove`` under one rng, byte for byte (the JAX
package's own tests/test_parallel.py and __graft_entry__.py:186-227 hold
its sharded results equal to these). The dry run itself checks each against
the port's single device, verifies the proofs, the committed one under a
fresh mask and rng=None, and at d = 2 the checkpointed sharded prove and
the mesh's refusals.

The rest run in this process: the batched Domain transforms against the
JAX Domain's leading batch axes, the mesh helpers on a one-rank gloo group,
the row padding against the reference's rule and the per-rank key staging.
"""

import json
import os
import pickle
import random
import secrets
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnark_icicle_tpu_torch.ops.field import field_for
from gnark_icicle_tpu_torch.ops.ntt import Domain
from gnark_icicle_tpu_torch.parallel import dryrun as dr

from test_torch_common import CURVES, lanes_to_ref, rand_ints, ref_curve, ref_to_lanes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checks of each dry run: d = 2 runs the data-parallel branch, the
# checkpoints and the refusals; d = 8 the sub-meshes
DRYRUN_CHECKS = {2: ("ntt", "msm", "prove", "prove_committed", "checkpoint", "refusals"),
                 8: ("ntt", "msm", "dispatch", "prove", "prove_committed")}
BLOCKED = ("jax", "jaxlib", "gnark_icicle_tpu")


def _start_dryrun(d: int, tmp):
    """The port's dry run on d CPU ranks over gloo, started in a process of
    its own whose path starts with packages that refuse to import (JAX and
    the JAX package); ``--no-single``: the proofs' bytes are held to the JAX
    package's here."""
    block = tmp / "blocked"
    for name in BLOCKED:
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in the port\\'s ranks')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(block), REPO]))
    return subprocess.Popen(
        [sys.executable, "-m", "gnark_icicle_tpu_torch.parallel.dryrun", str(d), "--device",
         "cpu", "--backend", "gloo", "--out", str(tmp / "out"), "--checks",
         ",".join(DRYRUN_CHECKS[d]), "--no-single"],
        cwd=str(block), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _dryrun_result(proc, tmp) -> tuple:
    """(the dry run's JSON lines by check, what its rank 0 wrote)."""
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:] + err[-8000:]
    lines = {}
    for line in out.splitlines():
        if line.startswith("{"):
            got = json.loads(line)
            lines[got["check"]] = got
    with open(tmp / "out" / "results.pkl", "rb") as f:
        return lines, pickle.load(f)


def _ref_fp2(v):
    from gnark_icicle_tpu.curves.tower import Fp2

    tp = ref_curve("bn254").tower
    if v is None:
        return None
    return tuple(Fp2(tp, c.c0, c.c1) if hasattr(c, "c0") else c for c in v)


def _ints(p):
    """A point of either package as nested ints (None = infinity)."""
    if p is None:
        return None
    return tuple((c.c0, c.c1) if hasattr(c, "c0") else c for c in p)


def _ref_msm(group: str, scalars, points):
    ref = ref_curve("bn254")
    grp = ref.g1 if group == "g1" else ref.g2
    return _ints(grp.msm(scalars, [_ref_fp2(p) for p in points]))


def _ref_proof(steps: int, commit: bool, monkeypatch) -> bytes:
    """The JAX package's single-device proof of the dry run's Chain: setup
    and prove under its rngs, the hiding mask fixed as the dry run fixes it."""
    from gnark_icicle_tpu import frontend as ref_frontend
    from gnark_icicle_tpu.backend import groth16 as ref_g16
    from gnark_icicle_tpu.io.serialize import proof_to_bytes

    ref = ref_curve("bn254")
    q = ref.fr.modulus
    cs = ref_frontend.compile_circuit(q, dr.chain_circuit(ref_frontend, steps, commit))
    pk, _ = ref_g16.setup(cs, ref, rng=random.Random(dr.SETUP_RNG), engine="host")
    monkeypatch.setattr(secrets, "randbelow", lambda m: dr.MASK % m)
    proof = ref_g16.prove(cs, pk, [dr.chain_output(q, steps)], [dr.CHAIN_X], ref,
                          rng=random.Random(dr.PROVE_RNG), engine="host")
    monkeypatch.undo()
    return proof_to_bytes(ref, proof)


def _ref_side(d: int, monkeypatch) -> dict:
    """What the JAX package gives for the dry run's inputs (made from the
    same seeds): the NTT's limbs, the MSMs' points and the proofs' bytes."""
    import jax.numpy as jnp

    from gnark_icicle_tpu.ops.field import field_for as ref_field_for
    from gnark_icicle_tpu.ops.ntt import domain_for as ref_domain_for

    ref, port = ref_curve("bn254"), CURVES["bn254"]
    r = ref.fr.modulus
    log_n = dr.ntt_log(d)
    F = ref_field_for(r)
    dom = ref_domain_for(F, ref.fr, log_n)
    x = F.encode(dr._rand_ints(11, r, 1 << log_n))
    # the Domain's transforms donate their input: each gets a copy
    out = {"ntt": {name: np.asarray(getattr(dom, name)(jnp.array(x))) for name in ("ntt", "intt")},
           "msm": {}, "dispatch": {}}
    for group, k0, seed in (("g1", 5, 21), ("g2", 9, 22)):
        pts, _ = dr._points(port.g1 if group == "g1" else port.g2, 8 * d, k0)
        scalars = dr._rand_ints(seed, r, 8 * d)
        scalars[5] = 0
        out["msm"][group] = (_ref_msm(group, scalars, pts), pts, scalars)
    if "dispatch" in DRYRUN_CHECKS[d]:
        for name, group, seed in (("a", "g1", 31), ("b1", "g1", 32), ("b2", "g2", 33),
                                  ("k", "g1", 34), ("z", "g1", 35)):
            pts, _ = dr._points(port.g1 if group == "g1" else port.g2, dr.DISPATCH_ROWS, seed)
            out["dispatch"][name] = _ref_msm(group, dr._rand_ints(seed, r, dr.DISPATCH_ROWS), pts)
    out["proofs"] = {commit: _ref_proof(dr.chain_steps(d), commit, monkeypatch)
                     for commit in (False, True)}
    return out


@pytest.mark.parametrize("d", sorted(DRYRUN_CHECKS))
def test_dryrun_matches_reference(d, tmp_path, monkeypatch):
    """One dry run of d ranks (the JAX package's side computed while it
    runs): every check passed, and its NTT limbs, MSM points and proof bytes
    equal the JAX package's, exactly."""
    proc = _start_dryrun(d, tmp_path)
    try:
        want = _ref_side(d, monkeypatch)
    except BaseException:
        proc.kill()
        raise
    lines, res = _dryrun_result(proc, tmp_path)
    assert sorted(lines) == sorted(c for c in DRYRUN_CHECKS[d] if c != "dispatch" or d >= 4)
    assert lines["ntt"]["equal"] and lines["ntt"]["round_trip"]
    assert lines["ntt"]["log_n"] == dr.ntt_log(d) == {2: 6, 8: 8}[d]
    assert lines["msm"]["g1"] == lines["msm"]["g2"] == "equal"
    assert lines["prove"]["verified"] and lines["prove_committed"]["fresh_verified"]
    if "checkpoint" in lines:
        assert all(lines["checkpoint"][run] == "byte_equal" for run in ("fresh", "partial", "full"))
        assert lines["refusals"]["engine_host"] and lines["refusals"]["other_device"]

    # the sharded NTT's limbs against the JAX single-device Domain, repacked
    for name in ("ntt", "intt"):
        np.testing.assert_array_equal(lanes_to_ref(torch.from_numpy(res["ntt"][name])),
                                      want["ntt"][name])
    # each MSM's affine point against the JAX package's host MSM, on the
    # dry run's own points and scalars
    for group in ("g1", "g2"):
        got = res["msm"][group]
        point, pts, scalars = want["msm"][group]
        assert got["points"] == pts and got["scalars"] == scalars
        assert None in pts and 0 in scalars
        assert _ints(got["result"]) == point
    for name, point in want["dispatch"].items():
        assert _ints(res["dispatch"]["results"][name]) == point
    # the sharded proofs' bytes against the JAX package's single-device proof
    for check, commit in (("prove", False), ("prove_committed", True)):
        assert res[check]["steps"] == dr.chain_steps(d)
        assert lines[check]["domain_log_n"] >= 2 * (d - 1).bit_length()
        assert res[check]["proof"] == want["proofs"][commit]


@pytest.mark.parametrize("name", ["ntt", "intt"])
def test_batched_domain_matches_reference(name, log_m=3, blocks=4):
    """A (W, G·m) batch of G transforms of m (the sharded NTT's column and
    row transforms, under a root of another domain's) against the JAX
    Domain's leading batch axis (gnark_icicle_tpu/ops/ntt.py:216-246)."""
    import jax.numpy as jnp

    from gnark_icicle_tpu.ops.field import field_for as ref_field_for
    from gnark_icicle_tpu.ops.ntt import Domain as RefDomain

    fr = CURVES["bn254"].fr
    q, m = fr.modulus, 1 << log_m
    root = pow(fr.root_of_unity(log_m + 2), 4, q)       # as ω^N2 of a larger domain
    ref_F = ref_field_for(q)
    x = ref_F.encode(rand_ints(130 + log_m, q, m * blocks))
    want = np.asarray(getattr(RefDomain(ref_F, log_m, root), name)(
        jnp.array(x).reshape(blocks, m, -1))).reshape(blocks * m, -1)
    port = Domain(field_for(q), log_m, root, None, "cpu")
    np.testing.assert_array_equal(lanes_to_ref(getattr(port, name)(ref_to_lanes(x))), want)


def test_batched_passes_equal_separate_transforms(monkeypatch):
    """A batch cut into several passes (each pass one launch over all the
    blocks, the m-wide table read at its own stride) equals each block
    transformed alone, both directions, with a post table as wide as the
    batch on the last store."""
    from gnark_icicle_tpu_torch.ops import ntt

    monkeypatch.setattr(ntt, "pass_split", lambda log_n: ntt.split_stages(log_n, 3, 1))
    fr = CURVES["bn254"].fr
    F = field_for(fr.modulus)
    log_m, blocks = 6, 4
    m = 1 << log_m
    assert len(ntt.pass_split(log_m)) == 3
    dom = Domain(F, log_m, fr.root_of_unity(log_m), None, "cpu")
    x = F.encode(rand_ints(140, fr.modulus, m * blocks), "cpu")
    post = F.encode(rand_ints(141, fr.modulus, m * blocks), "cpu")
    for key, dif in (("f", True), ("i", True), ("f", False)):
        got = dom._transform(x, key, dif, post=post)
        for b in range(blocks):
            cut = slice(b * m, (b + 1) * m)
            want = dom._transform(x[:, cut].contiguous(), key, dif, post=post[:, cut].contiguous())
            assert torch.equal(got[:, cut], want)
    assert torch.equal(dom.bit_reverse(x)[:, m:2 * m], dom.bit_reverse(x[:, m:2 * m]))
    with pytest.raises(ValueError):
        dom.ntt(x[:, :m + 1].contiguous())


@pytest.mark.parametrize("n,d", [(35, 1), (37, 2), (64, 8), (100, 3), (4095, 4), (5000, 8),
                                 (131_512, 4), (262_144, 4)])
def test_padded_rows_matches_reference(n, d):
    """The row padding against the reference's _pad_msm_inputs: the same
    padded count, a multiple of d, infinity rows and zero scalars."""
    import jax.numpy as jnp

    from gnark_icicle_tpu.parallel.pipeline import _pad_msm_inputs as ref_pad
    from gnark_icicle_tpu_torch.parallel.pipeline import _pad_msm_inputs, padded_rows

    _, inf, scal = ref_pad((jnp.zeros((n, 1), jnp.int32),), jnp.zeros((n,), bool),
                           jnp.zeros((n, 1), jnp.int32), d)
    assert padded_rows(n, d) == scal.shape[0] and padded_rows(n, d) % d == 0
    table, pinf, pscal = _pad_msm_inputs(torch.ones((n, 2), dtype=torch.int32),
                                         torch.zeros(n, dtype=torch.bool),
                                         torch.ones((1, n), dtype=torch.int32), d)
    assert table.shape[0] == pinf.shape[0] == pscal.shape[1] == scal.shape[0]
    assert bool(pinf[n:].all()) and not bool(pinf[:n].any()) and int(pscal[:, n:].abs().sum()) == 0
    assert np.asarray(inf[n:]).all()


@pytest.fixture
def one_rank(tmp_path):
    """A world of one rank on the CPU over gloo (a file store)."""
    import torch.distributed as dist

    from gnark_icicle_tpu_torch.parallel import world_mesh

    if dist.is_initialized():
        pytest.fail("a process group is already running")
    mesh = world_mesh("gloo", device="cpu", rank=0, world_size=1,
                      init_method=f"file://{tmp_path / 'store'}")
    yield mesh
    dist.destroy_process_group()


def test_one_rank_mesh(one_rank):
    """The mesh helpers on one rank: its fields, the sub-mesh split (made
    once, refused beyond the mesh's size), the collectives, the sharded
    MSM and NTT against the single device's, and the proof's sub-meshes
    below four ranks (the whole mesh, every table)."""
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.device import DeviceCtx
    from gnark_icicle_tpu_torch.ops.ntt import domain_for
    from gnark_icicle_tpu_torch.parallel import ShardedNTT, sharded_msm, split_submeshes
    from gnark_icicle_tpu_torch.parallel.pipeline import groth16_meshes, table_shards

    mesh = one_rank
    assert (mesh.ranks, mesh.index, mesh.size, mesh.device) == ((0,), 0, 1, torch.device("cpu"))
    subs = split_submeshes(mesh, {"x": 1})
    assert split_submeshes(mesh, {"x": 1}) is subs and subs["x"].member
    with pytest.raises(ValueError):
        split_submeshes(mesh, {"x": 1, "y": 1})
    assert mesh.broadcast_object({"k": 7}) == {"k": 7}
    assert mesh.all_gather_object(5) == [5]
    t = torch.arange(6, dtype=torch.int32).view(1, 2, 3)
    assert torch.equal(mesh.all_to_all(t), t) and torch.equal(mesh.all_gather(t)[0], t)

    ctx = DeviceCtx(bn254.BN254, "cpu")
    pts = [bn254.BN254.g1.scalar_mul(bn254.BN254.g1.generator, k) for k in range(1, 9)]
    scal = ctx.fr_plain(rand_ints(150, bn254.R, 8))
    table, inf = ctx.g1_points(pts)
    got = sharded_msm(ctx.msm_g1, mesh, table, inf, scal)
    assert ctx.g1_to_host(got) == ctx.g1_to_host(ctx.msm_g1.msm(table, inf, scal, 4))
    x = ctx.fr.encode(rand_ints(151, bn254.R, 16), "cpu")
    sntt = ShardedNTT(ctx.fr, bn254.BN254.fr, 4, mesh)
    dom = domain_for(ctx.fr, bn254.BN254.fr, 4, "cpu")
    assert torch.equal(sntt.ntt(x), dom.ntt(x)) and torch.equal(sntt.intt(x), dom.intt(x))

    meshes = groth16_meshes(mesh)
    assert all(m is mesh for m in meshes.values())
    assert table_shards(meshes) == {t: (0, 1) for t in ("a", "b1", "b2", "k", "z")}


def test_world_mesh_refusals(tmp_path):
    """A backend other than NCCL and gloo, and NCCL on the CPU, are refused;
    a rank's device is the caller's, and without a card only "cpu"."""
    from gnark_icicle_tpu_torch.parallel import world_mesh
    from gnark_icicle_tpu_torch.parallel.mesh import rank_device

    with pytest.raises(ValueError):
        world_mesh("mpi", device="cpu", rank=0, world_size=1)
    assert rank_device("cpu") == torch.device("cpu")
    assert rank_device("cuda:3") == torch.device("cuda", 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            rank_device(None, local_rank=0)


def test_prove_mesh_refusals():
    """prove with a mesh refuses the host engine and a device other than
    the mesh's, before it reads the mesh any further."""
    from types import SimpleNamespace

    from gnark_icicle_tpu_torch.backend import groth16

    mesh = SimpleNamespace(device=torch.device("cpu"))
    curve = CURVES["bn254"]
    for kw in ({"engine": "host"}, {"device": "meta"}):
        with pytest.raises(ValueError):
            groth16.prove(None, None, [], [], curve, mesh=mesh, **kw)


def test_key_staged_by_rows():
    """device_arrays with shards stages only the tables named, each member's
    rows of the table padded with infinity (the whole table's rows where
    the padding adds none), cached per shards."""
    from gnark_icicle_tpu_torch import frontend
    from gnark_icicle_tpu_torch.backend import groth16
    from gnark_icicle_tpu_torch.device import DeviceCtx
    from gnark_icicle_tpu_torch.parallel.pipeline import padded_rows

    curve = CURVES["bn254"]
    cs = frontend.compile_circuit(curve.fr.modulus, dr.chain_circuit(frontend, 10))
    pk, _ = groth16.setup(cs, curve, rng=random.Random(1), device="cpu")
    ctx = DeviceCtx(curve, "cpu")
    whole = pk.device_arrays(ctx)
    for size in (1, 2, 3):
        n_pad = padded_rows(len(pk.g1_a), size)
        rows = n_pad // size
        for index in range(size):
            dev = pk.device_arrays(ctx, {"a": (index, size), "b2": (index, size)})
            assert sorted(dev) == ["a", "b2"]
            assert pk.device_arrays(ctx, {"a": (index, size), "b2": (index, size)}) is dev
            for name, full in (("a", whole["a"]), ("b2", whole["b2"])):
                table, inf = dev[name]
                lo = index * rows
                real = max(0, min(rows, len(pk.g1_a) - lo))
                assert torch.equal(table[:real], full[0][lo:lo + real])
                assert torch.equal(inf[:real], full[1][lo:lo + real])
                assert bool(inf[real:].all()) and inf.shape[0] == rows
    assert pk.pedersen_arrays(ctx) is whole["pedersen"]
