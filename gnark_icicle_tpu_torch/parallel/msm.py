"""The MSM sharded by rows over a mesh: each rank a whole local MSM, then
the partial sums gathered and tree-added.

Port of gnark_icicle_tpu/parallel/msm.py:27-58 ``sharded_msm``: the points
and scalars are split by rows over the mesh's ranks; each rank runs the
whole Pippenger MSM on its rows (``ops/msm.py`` ``MSMKernel.msm``: buckets,
reduction and Horner, no communication) with c = ``pick_window(N/d)``, as
the reference does; the d projective partial sums, (planes, W, 1) each, are
gathered in one collective (the list form of ``all_gather``, which NCCL and
gloo both take), and every rank adds them in rank order with the group's
complete add (``ops/ec_t.py`` ``add``: ``g1_add``/``g2_add`` on the card),
so every rank returns the same point.
"""

from __future__ import annotations

import torch

from ..ops.msm import MSMKernel, pick_window
from .mesh import Mesh


def sharded_msm(kernel: MSMKernel, mesh: Mesh, table_shard: torch.Tensor,
                inf_shard: torch.Tensor, scalars_shard: torch.Tensor,
                c: int | None = None) -> torch.Tensor:
    """Σ s_i·P_i over the rows of every member: this rank's rows are
    table_shard (its affine point rows), inf_shard (its infinity mask) and
    scalars_shard ((Wr, N/d) plain-form scalars), each rank the same count.
    Returns the (planes, W, 1) projective sum, the same on every member."""
    if not mesh.member:
        raise ValueError(f"this rank is outside {mesh}")
    cc = c if c is not None else pick_window(scalars_shard.shape[1])
    part = kernel.msm(table_shard, inf_shard, scalars_shard, cc)
    parts = mesh.all_gather(part)
    acc = parts[0]
    for p in parts[1:]:
        acc = kernel.tc.add(acc, p)
    return acc
