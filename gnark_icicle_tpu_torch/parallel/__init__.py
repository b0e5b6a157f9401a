"""Several devices on torch.distributed: the MSM sharded by rows, the NTT in
four steps with three exchanges, and the proof's MSMs on sub-meshes.

Port of gnark_icicle_tpu/parallel/__init__.py (:1-12), with the same
exports; ``Mesh``, ``world_mesh`` and ``ShardedNTT``'s cache are the port's
own (a mesh is a process group, one process a rank: ``mesh.py``).
``python -m gnark_icicle_tpu_torch.parallel.dryrun N`` checks the layer on N
ranks (``dryrun.py``).
"""

from .mesh import Mesh, split_submeshes, world_mesh
from .msm import sharded_msm
from .ntt import ShardedNTT, sharded_ntt
from .pipeline import dispatch_msm, pipelined_groth16_msms

__all__ = [
    "sharded_msm", "ShardedNTT",
    "split_submeshes", "dispatch_msm", "pipelined_groth16_msms",
    "Mesh", "world_mesh", "sharded_ntt",
]
