"""A dry run of the multi-device layer on N ranks, each a process.

    python -m gnark_icicle_tpu_torch.parallel.dryrun N [--device cpu|cuda]
        [--backend gloo|nccl] [--out DIR]

The port's ``dryrun_multichip`` (__graft_entry__.py:85-227). It spawns N
ranks (``torch.multiprocessing``), joined through a file store in a
temporary directory, on ``--device`` over ``--backend`` (``cuda``: rank i
on card i % device_count; ranks that share a card take gloo), and checks on
BN254:

  ntt       ``ShardedNTT`` forward and inverse against the single-device
            ``Domain`` bit for bit, at 2^(2·⌈log2 N⌉ + 2) (at least 2^6),
            and the inverse of the forward giving the input back;
  msm       ``sharded_msm`` on G1 and G2 (8·N points, one at infinity, one
            with a zero scalar) against the host MSM of ``curves/`` and the
            single-device ``msm``, the same point on every rank;
  dispatch  at N ≥ 4, the proof's four sub-meshes each dispatching its
            MSMs over 37 rows (padded): A and B1 on G1, B2 on G2, K and Z
            on the last, against the host MSM;
  prove     the sharded Groth16 prove of a Chain whose domain is divisible
            by N², the same on every rank, byte-equal to the single-device
            proof under one rng (but with ``--no-single``, where the caller
            holds the bytes to a reference of its own), and verified;
  prove_committed  the same with one ``api.commit``, its hiding mask fixed:
            byte-equal; then under a fresh mask and rng=None, the same
            proof on every rank, verified;
  checkpoint the sharded prove with ``checkpoint_dir``: fresh, resumed after
            its last stage is deleted, and resumed whole, each byte-equal to
            check prove's;
  refusals  ``engine="host"`` and a device other than the mesh's refused.

``--checks`` names some of them (default: all). Rank 0 prints one JSON line
a check; a failed check fails the run (exit code 1) and prints no line for
it. With ``--out`` rank 0 writes what it
compared to ``DIR/results.pkl`` (the tests hold it to the JAX package).
It imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import random
import secrets
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

CHAIN_X = 3            # the Chain's secret input
SETUP_RNG, PROVE_RNG = 1, 2
MASK = 0x5EED          # the byte comparisons' hiding mask: secrets.randbelow(m) = MASK % m
DISPATCH_ROWS = 37


def chain_circuit(fe, steps: int, commit: bool = False):
    """x_{i+1} = x_i² + x_i + i for `steps` steps over the frontend module
    `fe` (bench.py's Chain); with `commit`, one ``api.commit`` over x, the
    middle value and the last."""

    class Chain(fe.Circuit):
        x = fe.Secret()
        out = fe.Public()

        def define(self, api):
            v, mid = self.x, None
            for i in range(steps):
                v = api.add(api.mul(v, v), v, i)
                if i == steps // 2:
                    mid = v
            if commit:
                api.assert_is_different(api.commit(self.x, mid, v), 0)
            api.assert_is_equal(v, self.out)

    return Chain


def chain_output(q: int, steps: int, x: int = CHAIN_X) -> int:
    v = x
    for i in range(steps):
        v = (v * v + v + i) % q
    return v


def chain_steps(d: int) -> int:
    """Steps whose domain n is at least d² (so that N1 = 2^⌊log n / 2⌋ is
    a multiple of d): more than n/2 constraints."""
    return max(40, d * d - 24)


def ntt_log(d: int) -> int:
    return max(6, 2 * (d - 1).bit_length() + 2)


@contextlib.contextmanager
def fixed_mask():
    """``api.commit``'s hiding mask (``secrets.randbelow``) fixed to MASK."""
    draw = secrets.randbelow
    secrets.randbelow = lambda m: MASK % m
    try:
        yield
    finally:
        secrets.randbelow = draw


def _rand_ints(seed: int, q: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, -(-q.bit_length() // 32)), dtype=np.uint64)
    return [int.from_bytes(r.astype("<u4").tobytes(), "little") % q for r in words]


def check_ntt(mesh, ctx) -> dict:
    from .ntt import ShardedNTT
    from ..ops.ntt import domain_for

    d, F = mesh.size, ctx.fr
    log_n = ntt_log(d)
    n = 1 << log_n
    rows = n // d
    x = F.encode(_rand_ints(11, F.modulus, n), ctx.device)
    sntt = ShardedNTT(F, ctx.curve.fr, log_n, mesh)
    lo = mesh.index * rows
    mine = x[:, lo:lo + rows].contiguous()
    fwd = sntt.ntt(mine)
    inv = sntt.intt(mine)
    back = sntt.intt(fwd)
    fwd_all = torch.cat(mesh.all_gather(fwd), dim=1)
    inv_all = torch.cat(mesh.all_gather(inv), dim=1)
    round_trip = all(mesh.all_gather_object(bool(torch.equal(back, mine))))
    dom = domain_for(F, ctx.curve.fr, log_n, ctx.device)
    equal = {"ntt": torch.equal(fwd_all, dom.ntt(x)), "intt": torch.equal(inv_all, dom.intt(x))}
    if not all(equal.values()) or not round_trip:
        raise AssertionError(f"sharded NTT at 2^{log_n}: equal {equal}, round trip {round_trip}")
    return {"line": {"log_n": log_n, "n1": sntt.n1, "n2": sntt.n2, "equal": True,
                     "round_trip": True},
            "data": {k: t.cpu().numpy() for k, t in (("x", x), ("ntt", fwd_all),
                                                      ("intt", inv_all))}}


def _points(group, n: int, k0: int):
    """(k0 + i)·G for i < n by additions, with their discrete logs; point 3
    at infinity (its log 0)."""
    pts, logs = [], []
    p = group.scalar_mul(group.generator, k0)
    for i in range(n):
        pts.append(None if i == 3 else p)
        logs.append(0 if i == 3 else k0 + i)
        p = group.add(p, group.generator)
    return pts, logs


def _oracle(group, r: int, scalars: list, logs: list):
    """Σ s_i·P_i as one host product, the points' logs known."""
    k = sum(s * l for s, l in zip(scalars, logs)) % r
    return group.scalar_mul(group.generator, k) if k else None


def check_msm(mesh, ctx) -> dict:
    from .msm import sharded_msm

    curve, r = ctx.curve, ctx.curve.fr.modulus
    n = 8 * mesh.size
    line, data = {"points": n}, {}
    for gname, group, host, kernel, stage in (
            ("g1", curve.g1, ctx.g1_to_host, ctx.msm_g1, ctx.g1_points),
            ("g2", curve.g2, ctx.g2_to_host, ctx.msm_g2, ctx.g2_points)):
        pts, logs = _points(group, n, 5 if gname == "g1" else 9)
        scalars = _rand_ints(21 if gname == "g1" else 22, r, n)
        scalars[5] = 0
        table, inf = stage(pts)
        rows = n // mesh.size
        lo, hi = mesh.index * rows, (mesh.index + 1) * rows
        got = host(sharded_msm(kernel, mesh, table[lo:hi].contiguous(), inf[lo:hi].contiguous(),
                               ctx.fr_plain(scalars[lo:hi])))
        single = host(kernel.msm(table, inf, ctx.fr_plain(scalars), 4))
        want = _oracle(group, r, scalars, logs)
        every = mesh.all_gather_object(got)
        if got != want or single != want or any(e != got for e in every):
            raise AssertionError(f"sharded {gname} MSM of {n} points differs")
        line[gname] = "equal"
        data[gname] = {"points": pts, "scalars": scalars, "result": got}
    return {"line": line, "data": data}


def check_dispatch(mesh, ctx) -> dict:
    """The proof's four sub-meshes, each its MSMs over DISPATCH_ROWS rows."""
    from .pipeline import dispatch_msm, groth16_meshes, shard_points

    curve, r = ctx.curve, ctx.curve.fr.modulus
    meshes = groth16_meshes(mesh)
    jobs = [("a", "a", "g1", 31), ("b1", "b1", "g1", 32), ("b2", "b2", "g2", 33),
            ("k", "hk", "g1", 34), ("z", "hk", "g1", 35)]
    mine, wants = {}, {}
    for name, sub, gname, seed in jobs:
        group = curve.g1 if gname == "g1" else curve.g2
        pts, logs = _points(group, DISPATCH_ROWS, seed)
        scalars = _rand_ints(seed, r, DISPATCH_ROWS)
        wants[name] = _oracle(group, r, scalars, logs)
        m = meshes[sub]
        if not m.member:
            continue
        host, kernel, stage = ((ctx.g1_to_host, ctx.msm_g1, ctx.g1_points) if gname == "g1"
                               else (ctx.g2_to_host, ctx.msm_g2, ctx.g2_points))
        t_shard, i_shard = shard_points(*stage(pts), m)
        point = dispatch_msm(kernel, m, t_shard, i_shard, ctx.fr_plain(scalars))
        if m.index == 0:
            mine[name] = host(point)
    got = {}
    for part in mesh.all_gather_object(mine):
        got.update(part)
    if got != wants:
        bad = sorted(k for k in wants if got.get(k) != wants[k])
        raise AssertionError(f"sub-mesh dispatches differ: {bad}")
    return {"line": {"rows": DISPATCH_ROWS, "submeshes": {k: list(m.ranks) for k, m in
                                                          meshes.items()},
                     "equal": sorted(got)},
            "data": {"results": got}}


_KEYS: dict = {}
_PROOFS: dict = {}     # check prove's bytes, by commit


def _keys(mesh, ctx, commit: bool):
    """(cs, pk, vk, public, secret) of the Chain: every rank compiles it,
    the first sets it up (SETUP_RNG) and sends the keys; once a run."""
    from .. import frontend
    from ..backend import groth16

    if commit in _KEYS:
        return _KEYS[commit]
    q = ctx.curve.fr.modulus
    steps = chain_steps(mesh.size)
    cs = frontend.compile_circuit(q, chain_circuit(frontend, steps, commit))
    keys = None
    if mesh.index == 0:
        pk, vk = groth16.setup(cs, ctx.curve, rng=random.Random(SETUP_RNG), device=ctx.device)
        pk._device = {}
        keys = (pk, vk)
    pk, vk = mesh.broadcast_object(keys)
    _KEYS[commit] = (cs, pk, vk, [chain_output(q, steps)], [CHAIN_X])
    return _KEYS[commit]


def check_prove(mesh, ctx, commit: bool, single: bool = True) -> dict:
    from ..backend import groth16
    from ..io.serialize import proof_to_bytes

    curve = ctx.curve
    cs, pk, vk, pub, sec = _keys(mesh, ctx, commit)
    with fixed_mask():
        t0 = time.perf_counter()
        proof = groth16.prove(cs, pk, pub, sec, curve, rng=random.Random(PROVE_RNG), mesh=mesh)
        seconds = time.perf_counter() - t0
        one = (groth16.prove(cs, pk, pub, sec, curve, rng=random.Random(PROVE_RNG),
                             device=ctx.device) if mesh.index == 0 and single else None)
    got = proof_to_bytes(curve, proof)
    every = mesh.all_gather_object(got)
    line = {"commit": commit, "constraints": cs.nb_constraints, "domain_log_n": pk.domain_log_n,
            "seconds": seconds}
    if mesh.index == 0:
        if any(e != got for e in every):
            raise AssertionError(f"the ranks' sharded proofs (commit={commit}) differ")
        if single:
            if got != proof_to_bytes(curve, one):
                raise AssertionError(f"the sharded proof (commit={commit}) differs from the "
                                     "single device's")
            line["byte_equal"] = True
        if not commit:
            groth16.verify(proof, vk, pub, curve)
            line["verified"] = True
    _PROOFS[commit] = every[0]
    if commit:      # a fresh mask and r, s from the first rank
        fresh = groth16.prove(cs, pk, pub, sec, curve, mesh=mesh)
        every = mesh.all_gather_object(proof_to_bytes(curve, fresh))
        if mesh.index == 0:
            if len(set(every)) != 1:
                raise AssertionError("the ranks' proofs under rng=None differ")
            groth16.verify(fresh, vk, pub, curve)
            line["fresh_verified"] = True
    return {"line": line, "data": {"steps": chain_steps(mesh.size), "proof": got,
                                   "public": pub, "secret": sec}}


def check_checkpoint(mesh, ctx, directory: str) -> dict:
    from ..backend import groth16
    from ..io.serialize import proof_to_bytes

    curve = ctx.curve
    cs, pk, vk, pub, sec = _keys(mesh, ctx, False)
    if False not in _PROOFS:
        check_prove(mesh, ctx, False)
    want = _PROOFS[False]
    runs = {}
    for run in ("fresh", "partial", "full"):
        if run == "partial" and mesh.index == 0:
            os.unlink(os.path.join(directory, "msms.pkl"))
        mesh.barrier()
        proof = groth16.prove(cs, pk, pub, sec, curve, rng=random.Random(PROVE_RNG), mesh=mesh,
                              checkpoint_dir=directory)
        every = mesh.all_gather_object(proof_to_bytes(curve, proof))
        if any(e != want for e in every):
            raise AssertionError(f"the {run} checkpointed sharded proof differs")
        runs[run] = "byte_equal"
    return {"line": runs, "data": {}}


def check_refusals(mesh, ctx) -> dict:
    from ..backend import groth16

    cs, pk, vk, pub, sec = _keys(mesh, ctx, False)
    other = torch.device("cpu") if ctx.device.type == "cuda" else torch.device("meta")
    refused = {}
    for label, kw in (("engine_host", {"engine": "host"}), ("other_device", {"device": other})):
        try:
            groth16.prove(cs, pk, pub, sec, ctx.curve, rng=random.Random(PROVE_RNG), mesh=mesh,
                          **kw)
        except ValueError:
            refused[label] = True
        else:
            raise AssertionError(f"a mesh prove with {kw} was not refused")
    return {"line": refused, "data": {}}


CHECKS = ("ntt", "msm", "dispatch", "prove", "prove_committed", "checkpoint", "refusals")


def _rank(rank: int, n: int, device: str, backend: str, store: str, out: str | None,
          scratch: str, names: tuple, single: bool) -> None:
    import torch.distributed as dist

    from ..curves import bn254
    from ..device import DeviceCtx
    from .mesh import world_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    mesh = world_mesh(backend, device="cpu" if device == "cpu" else None, rank=rank,
                      world_size=n, init_method=f"file://{store}", local_rank=rank)
    ctx = DeviceCtx(bn254.BN254, mesh.device)
    checks = {"ntt": check_ntt, "msm": check_msm, "dispatch": check_dispatch,
              "prove": lambda m, c: check_prove(m, c, False, single),
              "prove_committed": lambda m, c: check_prove(m, c, True, single),
              "checkpoint": lambda m, c: check_checkpoint(m, c, os.path.join(scratch, "ck")),
              "refusals": check_refusals}
    checks = [(name, checks[name]) for name in names if name != "dispatch" or n >= 4]
    results = {"d": n, "device": str(mesh.device), "backend": backend}
    for name, check in checks:
        t0 = time.perf_counter()
        got = check(mesh, ctx)
        if rank == 0:
            print(json.dumps({"check": name, "ranks": n, "device": str(mesh.device),
                              "backend": backend, **got["line"],
                              "wall_s": time.perf_counter() - t0}), flush=True)
        results[name] = got["data"]
    if rank == 0 and out is not None:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "results.pkl"), "wb") as f:
            pickle.dump(results, f, protocol=pickle.HIGHEST_PROTOCOL)
    mesh.barrier()
    dist.destroy_process_group()
    # a finished rank ends without the interpreter's finalization, in which
    # the backend's threads can abort it
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def dryrun(n: int, device: str = "cuda", backend: str = "gloo", out: str | None = None,
           checks: tuple = CHECKS, single: bool = True) -> None:
    """Spawn the n ranks and run the checks (dispatch only at n ≥ 4);
    raises where a rank failed."""
    import torch.multiprocessing as mp

    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    unknown = set(checks) - set(CHECKS)
    if unknown:
        raise ValueError(f"no checks {sorted(unknown)}; the checks are {CHECKS}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run the dry run with --device cpu")
    if out is not None:
        os.makedirs(out, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dryrun_", dir=out)
    try:
        mp.spawn(_rank, args=(n, device, backend, os.path.join(tmp, "store"), out, tmp,
                              tuple(checks), single),
                 nprocs=n, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ranks", type=int)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--out", default=None, help="directory of results.pkl")
    ap.add_argument("--checks", default=",".join(CHECKS),
                    help="comma-separated checks (default: all)")
    ap.add_argument("--no-single", dest="single", action="store_false",
                    help="no single-device proof to hold the sharded ones to")
    args = ap.parse_args(argv)
    dryrun(args.ranks, args.device, args.backend, args.out, tuple(args.checks.split(",")),
           args.single)
    return 0


if __name__ == "__main__":
    sys.exit(main())
