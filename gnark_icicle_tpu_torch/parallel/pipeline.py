"""The Groth16 proof MSMs over sub-meshes, and the row padding and sharding
of MSM operands.

Port of gnark_icicle_tpu/parallel/pipeline.py: ``split_submeshes`` (:34-51,
in ``mesh.py``), ``_pad_msm_inputs`` (:54-79), ``dispatch_msm`` (:82-102)
and ``pipelined_groth16_msms`` (:105-131). The reference carves its devices
into disjoint sub-meshes and dispatches the MSMs A, B1, B2 and (K, Z) on
one each, so that they run at once. Here a sub-mesh is a process group and
its ranks run only its MSMs, on their rows of those tables alone (the
reference's row ``NamedSharding``, :98-102: ``backend/groth16/keys.py``
stages a rank's rows); different sub-meshes run at once because they are
different ranks. Then one ``all_gather`` of the results over the whole mesh
gives every rank every point, so that each assembles the proof.

The padding is the reference's: infinity points with zero scalars, which
add nothing, up to a multiple of lcm(d, 64) below 4,096 rows and of
lcm(d, 1,024) above, so that every rank holds as many rows.
"""

from __future__ import annotations

import math

import torch

from ..ops.msm import MSMKernel, pick_window
from .mesh import Mesh, split_submeshes
from .msm import sharded_msm

# the sub-meshes of the proof's MSMs and the key tables each reads
# (pipeline.py:121-130)
GROTH16_TABLES = {"a": ("a",), "b1": ("b1",), "b2": ("b2",), "hk": ("k", "z")}


def padded_rows(n: int, d: int) -> int:
    """n rows padded to a multiple of lcm(d, 64) below 4,096 rows, of
    lcm(d, 1,024) above (pipeline.py:54-79)."""
    base = 64 if n < 4096 else 1024
    step = d * base // math.gcd(d, base)
    return n + (-n) % step


def shard_range(n_pad: int, mesh: Mesh) -> tuple:
    """The rows [lo, hi) of a padded operand that this member holds."""
    rows = n_pad // mesh.size
    return mesh.index * rows, (mesh.index + 1) * rows


def _pad_msm_inputs(table: torch.Tensor, inf: torch.Tensor, scal: torch.Tensor, d: int):
    """An MSM's operands, table (N, row), inf (N,) and scalars (Wr, N),
    padded to ``padded_rows(N, d)`` rows with infinity points and zero
    scalars (pipeline.py:54-79)."""
    n = scal.shape[1]
    pad = padded_rows(n, d) - n
    if pad == 0:
        return table, inf, scal
    return (torch.cat([table, table.new_zeros((pad, table.shape[1]))]),
            torch.cat([inf, inf.new_ones(pad)]),
            torch.nn.functional.pad(scal, (0, pad)))


def shard_points(table: torch.Tensor, inf: torch.Tensor, mesh: Mesh) -> tuple:
    """This member's rows of a whole point table and its infinity mask,
    padded as ``_pad_msm_inputs`` pads."""
    n = inf.shape[0]
    table, inf, _ = _pad_msm_inputs(table, inf, table.new_zeros((1, n)), mesh.size)
    lo, hi = shard_range(inf.shape[0], mesh)
    return table[lo:hi].contiguous(), inf[lo:hi].contiguous()


def dispatch_msm(kernel: MSMKernel, mesh: Mesh, table_shard: torch.Tensor,
                 inf_shard: torch.Tensor, scal: torch.Tensor, c: int | None = None):
    """One MSM on `mesh` (pipeline.py:82-102): the points are this member's
    rows of the padded table (``shard_points``, or a key's per-rank
    staging), the scalars (Wr, N) the whole vector, which is padded and cut
    to the same rows here. Returns the (planes, W, 1) sum on the mesh's
    members and None on the other ranks, which run nothing."""
    if not mesh.member:
        return None
    n_pad = padded_rows(scal.shape[1], mesh.size)
    lo, hi = shard_range(n_pad, mesh)
    if table_shard.shape[0] != hi - lo or inf_shard.shape[0] != hi - lo:
        raise ValueError(f"the table shard holds {inf_shard.shape[0]} rows, not {hi - lo}")
    scal = torch.nn.functional.pad(scal, (0, n_pad - scal.shape[1]))[:, lo:hi].contiguous()
    return sharded_msm(kernel, mesh, table_shard, inf_shard, scal,
                       c if c is not None else pick_window(n_pad // mesh.size))


def groth16_meshes(mesh: Mesh) -> dict:
    """The sub-meshes {"a", "b1", "b2", "hk"} of the proof's MSMs: at four
    ranks or more, ⌊d/4⌋ ranks each and the rest to "hk"
    (gnark_icicle_tpu/backend/groth16/prove.py:448-456); below four, each
    the whole mesh (the MSMs data-parallel one after another, :457-468)."""
    if mesh.size >= 4:
        share = mesh.size // 4
        return split_submeshes(mesh, {"a": share, "b1": share, "b2": share,
                                      "hk": mesh.size - 3 * share})
    return {name: mesh for name in GROTH16_TABLES}


def table_shards(meshes: dict) -> dict:
    """{key table: (this rank's index, the sub-mesh's size)} for the tables
    that this rank's MSMs read (``ProvingKey.device_arrays``'s shards)."""
    return {table: (m.index, m.size) for name, m in meshes.items() if m.member
            for table in GROTH16_TABLES[name]}


def pipelined_groth16_msms(ctx, mesh: Mesh, meshes: dict, dev: dict, wires, priv_wires,
                           h_scalars) -> dict:
    """The proof's MSMs on their sub-meshes (pipeline.py:105-131; meshes from
    ``groth16_meshes``, below four ranks each the whole mesh, which then runs
    them data-parallel one after another, as the reference's
    backend/groth16/prove.py:457-468): A, B1 and B2 over the wires, K over
    the private wires (where there are any) and Z over h, each run by its
    sub-mesh's ranks on their rows (dev: this rank's staged shards), then
    one ``all_gather`` over `mesh` so that every rank has every result.
    Returns {"ar", "bs1", "bs2"[, "krs_k"], "krs_z"} as host affine points
    (None = infinity)."""
    jobs = [("ar", "a", ctx.msm_g1, "a", wires), ("bs1", "b1", ctx.msm_g1, "b1", wires),
            ("bs2", "b2", ctx.msm_g2, "b2", wires)]
    if priv_wires.shape[1] > 0:
        jobs.append(("krs_k", "hk", ctx.msm_g1, "k", priv_wires))
    jobs.append(("krs_z", "hk", ctx.msm_g1, "z", h_scalars))
    mine = {}
    for name, sub, kernel, table, scal in jobs:
        point = dispatch_msm(kernel, meshes[sub], *dev[table], scal) if meshes[sub].member \
            else None
        if point is not None and meshes[sub].index == 0:
            mine[name] = (ctx.g2_to_host if name == "bs2" else ctx.g1_to_host)(point)
    out = {}
    for part in mesh.all_gather_object(mine):
        out.update(part)
    return out
