"""The NTT sharded over a mesh: a four-step transform with three exchanges.

Port of gnark_icicle_tpu/parallel/ntt.py:29-141 ``ShardedNTT``. The domain
of N = N1·N2 (N1 = 2^⌊log N / 2⌋, both divisible by the mesh's d) is an
N1×N2 matrix, x[j1·N2 + j2], and with the output k = k1 + N1·k2

    X[k1 + N1·k2] = Σ_{j2} ω_{N2}^{j2·k2} · (ω_N^{j2·k1} · Σ_{j1} ω_{N1}^{j1·k1} · x[j1·N2 + j2]).

Each rank holds N/d consecutive elements in natural order, in and out.
A transform is: exchange 1 (rows j1 to columns j2), the N2/d column
transforms of N1 (``ops/ntt.py`` ``Domain`` of the root ω^N2, one batch:
their passes launch once over all of them), the twiddle grid ω^(±j2·k1)
(built once per direction on each rank for its rows j2, by Montgomery
products doubling the table, as the reference's ``_grid`` :64-90 does, and
applied on the column transforms' last store in their bit-reversed order),
exchange 2, the N1/d row transforms of N2 (the root ω^N1), 1/N on their last
store for the inverse, and exchange 3 back to natural order.

The port's data is (W, n) limb-major, so the axis that the reference's
``all_to_all(..., split_axis, concat_axis, tiled=True)`` splits is the last
one here, while ``all_to_all_single`` splits dim 0: :meth:`_exchange` packs
the d chunks contiguous as (d, W, A, B) first and lays the received chunks
out after, which is the reference's all_to_all followed by its swapaxes.
"""

from __future__ import annotations

import torch

from ..ops.field import Field
from ..ops.field_t import TField
from ..ops.ntt import Domain, _pow_table
from .mesh import Mesh


class ShardedNTT:
    """Forward and inverse NTT of 2^log_n, natural order, sharded over
    `mesh`: each member holds the N/d consecutive elements of its index."""

    def __init__(self, F: Field, prime_field, log_n: int, mesh: Mesh):
        self.F = F
        self.tf = TField(F)
        self.log_n = log_n
        self.n = 1 << log_n
        self.mesh = mesh
        d = self.d = mesh.size
        log_n1 = log_n // 2
        self.n1 = 1 << log_n1
        self.n2 = self.n // self.n1
        if self.n1 % d or self.n2 % d:
            raise ValueError(f"N1={self.n1}, N2={self.n2} must be divisible by the mesh's {d}")
        if not mesh.member:
            raise ValueError(f"this rank is outside {mesh}")
        q = self.q = prime_field.modulus
        self.omega = prime_field.root_of_unity(log_n)
        dev = mesh.device
        # the reference's sub-domains: ω^N2 for the columns, ω^N1 for the rows
        self.dom1 = Domain(F, log_n1, pow(self.omega, self.n2, q), None, dev)
        self.dom2 = Domain(F, log_n - log_n1, pow(self.omega, self.n1, q), None, dev)
        self.n_inv = F.const(pow(self.n, -1, q), dev)
        self._grids: dict = {}

    def _grid(self, inverse: bool) -> torch.Tensor:
        """T[j2, k1] = ω^(±j2·k1) for this rank's rows j2 (N2/d of them),
        k1 in bit-reversed order within each row: (W, N2/d · N1)."""
        if inverse in self._grids:
            return self._grids[inverse]
        F, tf, dev = self.F, self.tf, self.mesh.device
        w = pow(self.omega, -1, self.q) if inverse else self.omega
        rows = self.n2 // self.d
        first = self.mesh.index * rows
        # ω^j2 for j2 = first .. first + rows − 1
        base = tf.mont_mul(_pow_table(tf, F.const(w, dev), rows),
                           F.const(pow(w, first, self.q), dev))
        W = base.shape[0]
        table = F.const(1, dev).expand(W, rows).reshape(W, rows, 1)
        cur = base.reshape(W, rows, 1)
        while table.shape[2] < self.n1:
            t = table.shape[2]
            nxt = tf.mont_mul(table.reshape(W, rows * t).contiguous(),
                              cur.expand(W, rows, t).reshape(W, rows * t).contiguous())
            table = torch.cat([table, nxt.view(W, rows, t)], dim=2)
            cur = tf.mont_mul(cur.reshape(W, rows), cur.reshape(W, rows)).view(W, rows, 1)
        grid = table[:, :, :self.n1].index_select(2, self.dom1._rev).reshape(W, -1).contiguous()
        self._grids[inverse] = grid
        return grid

    def _exchange(self, x: torch.Tensor, a: int, b: int) -> torch.Tensor:
        """The distributed transpose: x is (W, a · d·b), rows i < a of this
        rank by columns of d chunks of b; chunk k goes to rank k, and rank s's
        chunk for this one lands as the columns s·a .. s·a + a − 1 of the
        result, (W, b · d·a)."""
        W, d = x.shape[0], self.d
        send = x.view(W, a, d, b).permute(2, 0, 1, 3)
        recv = self.mesh.all_to_all(send)                     # (d, W, a, b)
        return recv.permute(1, 3, 0, 2).reshape(W, b * d * a)

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        if x.shape[1] != self.n // self.d:
            raise ValueError(f"a rank holds {self.n // self.d} elements, not {x.shape[1]}")
        key = "i" if inverse else "f"
        n1, n2, d = self.n1, self.n2, self.d
        # [j1 local, j2] -> [j2 local, j1]
        m = self._exchange(x, n1 // d, n2 // d)
        # the column transforms over j1, the twiddle grid on their last store
        y = self.dom1.bit_reverse(self.dom1._transform(m, key, True, post=self._grid(inverse)))
        # [j2 local, k1] -> [k1 local, j2]
        y = self._exchange(y, n2 // d, n1 // d)
        # the row transforms over j2, 1/N on the inverse's last store
        z = self.dom2.bit_reverse(self.dom2._transform(
            y, key, True, post=self.n_inv if inverse else None))
        # [k1 local, k2] -> [k2 local, k1]: natural order
        return self._exchange(z, n1 // d, n2 // d)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """natural -> natural forward transform of this rank's (W, N/d)."""
        return self._transform(x, inverse=False)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """natural -> natural inverse transform (1/N included)."""
        return self._transform(x, inverse=True)


_SHARDED: dict = {}


def sharded_ntt(F: Field, prime_field, log_n: int, mesh: Mesh) -> ShardedNTT:
    """One ShardedNTT per (modulus, log_n, mesh) in a process, so that its
    sub-domains and grids are built once (the reference caches its grids on
    the object, :62)."""
    key = (F.modulus, log_n, mesh)
    if key not in _SHARDED:
        _SHARDED[key] = ShardedNTT(F, prime_field, log_n, mesh)
    return _SHARDED[key]
