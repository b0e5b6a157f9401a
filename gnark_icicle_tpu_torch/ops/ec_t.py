"""G1 and G2 group law on the card: the MSM wave step, add and double.

Port of gnark_icicle_tpu/ops/ec_t.py ``TCurve`` (:208) and ``TCurve2``
(:586), for the base field's W words (``ops/field.py`` ``words_for``: 8 for
BN254, 12 for BLS12-381 and BLS12-377, 24 for BW6-761; the reference's
``self.K = F.K``, :232 and :621). BW6-761's G2 lies over Fp: it is a
:class:`TCurve` with G2's b3, on the ``g1.cu`` entries of BW6-761. A
batch of projective points is ONE int32 tensor of coordinate planes: G1
``(3, W, n)`` for (X, Y, Z), G2 ``(6, W, n)`` for (x0, x1, y0, y1, z0, z1),
each plane a ``(W, n)`` Montgomery element batch. Identity is (0 : 1 : 0). A
lane prefix ``P[..., :S]`` of a wider batch is a valid operand: the kernels
take the row stride ``ld``.

Affine point tables, the MSM's gather source, are row-major: one row of
2W words (G1: x, y) or 4W words (G2: x0, x1, y0, y1) per point.

Kernels (``csrc/g1.cu``, ``csrc/g2.cu``):

* ``add_mixed_masked`` — K4/K5 (ops/ec_t.py:529, :896): acc += (±)table[idx]
  where mask, in place, with the gather, sign and mask inside the kernel;
* ``add`` and ``double`` — the complete RCB16 add and double, the products
  of K2/K3 (ops/ec_t.py:266, :649) fused per call.

For CPU tensors each method runs the plain version, ``ops/ec.py``
``DevCurve``; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..curves import bls12_377, bls12_381, bn254, bw6_761
from .cuda import Kernel, is_cuda, require, stream
from .ec import DevCurve, DevField, DevField2
from .field import Field, ints_to_limbs32, to16, to32


def _group_kernels(curve: str, g: str, k_mixed: str, k_mul: str):
    """(add_mixed_masked, add, double) entries of one group of one curve."""
    return (Kernel(g, curve, f"{g}_add_mixed_masked", k_mixed),
            Kernel(g, curve, f"{g}_add", k_mul),
            Kernel(g, curve, f"{g}_double", k_mul))


# base-field modulus -> {"g1": kernels, "g2": kernels} of its curve; the
# "g2" (Fp2) family only where the curve's G2 lies over Fp2
EC_KERNELS = {
    q: {"g1": _group_kernels(curve, "g1", "gnark_icicle_tpu/ops/ec_t.py:529",
                             "gnark_icicle_tpu/ops/ec_t.py:266"),
        **({"g2": _group_kernels(curve, "g2", "gnark_icicle_tpu/ops/ec_t.py:896",
                                 "gnark_icicle_tpu/ops/ec_t.py:649")}
           if fp2 else {})}
    for q, curve, fp2 in ((bn254.P, "bn254", True), (bls12_381.P, "bls12_381", True),
                          (bls12_377.P, "bls12_377", True), (bw6_761.P, "bw6_761", False))
}


class _TCurveBase:
    NP = 1     # planes per coordinate
    GROUP = ""  # "g1" or "g2": the kernel family

    def __init__(self, F: Field, b3_host: list, curve: DevCurve):
        self.F = F
        self.W = F.n32                          # words per Fp element
        self.curve = curve                      # the plain version
        # Montgomery b3, NP*W words
        self._b3_words = [w for c in b3_host for w in self._words(c)]
        self._b3: dict = {}
        self._kernels = EC_KERNELS.get(F.modulus, {}).get(self.GROUP)
        self.planes = 3 * self.NP
        self.row = 2 * self.W * self.NP

    def _words(self, c: int) -> list:
        m = c % self.F.modulus * self.F.R % self.F.modulus
        return [(m >> (32 * i)) & 0xFFFFFFFF for i in range(self.W)]

    def _rows(self, coords: list, n: int, device) -> torch.Tensor:
        """Host Fp ints, row by row -> (n, row) Montgomery table."""
        q, R = self.F.modulus, self.F.R
        rows = ints_to_limbs32([c % q * R % q for c in coords],
                               self.W).reshape(n, self.row)
        return torch.from_numpy(rows.view("<i4")).to(device)

    # -- constants and constructors -------------------------------------------
    def b3_row(self, device) -> torch.Tensor:
        key = torch.device(device)
        if key not in self._b3:
            w = torch.tensor(self._b3_words, dtype=torch.int64)
            self._b3[key] = torch.where(w >= 1 << 31, w - (1 << 32), w).to(
                torch.int32).to(key)
        return self._b3[key]

    def identity(self, n: int, device) -> torch.Tensor:
        P = torch.zeros((self.planes, self.W, n), dtype=torch.int32, device=device)
        P[self.NP] = self.F.const(1, device)  # y (its c0 plane for G2)
        return P

    def select(self, mask, P, Q):
        """mask: (n,) bool — P where true."""
        return torch.where(mask, P, Q)

    # -- plain-version plumbing ----------------------------------------------
    def _coords(self, P):
        """(planes, W, n) int32 -> DevCurve coordinates of (2W, n) int64."""
        planes = [to16(P[i]) for i in range(P.shape[0])]
        if self.NP == 1:
            return tuple(planes)
        return tuple((planes[2 * i], planes[2 * i + 1])
                     for i in range(len(planes) // 2))

    def _stack(self, coords):
        flat = []
        for c in coords:
            flat.extend(c if isinstance(c, tuple) else (c,))
        return torch.stack([to32(c) for c in flat])

    def _check_points(self, *Ps):
        for P in Ps:
            require(P.dtype == torch.int32 and P.dim() == 3
                    and P.shape[0] == self.planes and P.shape[1] == self.W,
                    f"expected ({self.planes}, {self.W}, n) int32 point planes")

    @staticmethod
    def _lanes(P):
        """P itself if its planes are (W, ld) rows of unit stride, else a
        contiguous copy (e.g. one lane picked out of a wider batch)."""
        ok = P.stride(2) == 1 and P.stride(0) == P.shape[1] * P.stride(1)
        return P if ok else P.contiguous()

    def _kernel(self, i: int) -> Kernel:
        """Entry i of (add_mixed_masked, add, double); raises for a curve
        whose kernels are not built."""
        if self._kernels is None:
            raise NotImplementedError(
                f"no {self.GROUP} kernels are built for the base field "
                f"{self.F.modulus:#x}")
        return self._kernels[i]

    # -- the MSM wave step ---------------------------------------------------
    def add_mixed_masked_plain(self, acc, S, table, idx, sign=None, mask=None):
        """The plain version of ``add_mixed_masked``: the same update, computed
        on the unmasked lanes only (the kernel's masked lanes return early)."""
        lanes = (torch.arange(S, device=acc.device) if mask is None
                 else torch.nonzero(mask != 0).flatten())
        k = lanes.shape[0]
        if k == 0:
            return
        x, y = self._coords(
            table[idx[lanes].long()].T.reshape(2 * self.NP, self.W, k))
        if sign is not None:
            y = self.curve.f.select(sign[lanes] != 0, self.curve.f.neg(y), y)
        sub = acc[:, :, lanes]
        acc[:, :, lanes] = self._stack(
            self.curve.add_mixed(self._coords(sub), (x, y)))

    def add_mixed_masked(self, acc, S: int, table, idx, sign=None, mask=None):
        """acc[..., :S] += (−1)^sign · table[idx] where mask, in place.

        acc: (planes, W, L) projective accumulators, L ≥ S; table: (M, row)
        affine rows (real points on every unmasked lane); idx, sign, mask:
        (S,) int32 (sign and mask may be None: all 0, all 1)."""
        if not is_cuda(acc, table, idx, sign, mask):
            return self.add_mixed_masked_plain(acc, S, table, idx, sign, mask)
        kernel = self._kernel(0)
        self._check_points(acc)
        require(acc.is_contiguous() and S <= acc.shape[2],
                "acc must be a contiguous (planes, W, L) tensor with L >= S")
        require(table.dtype == torch.int32 and table.is_contiguous()
                and table.dim() == 2 and table.shape[1] == self.row,
                f"table must be contiguous (M, {self.row}) int32 rows")
        for t in (idx, sign, mask):
            require(t is None or (t.dtype == torch.int32 and t.is_contiguous()
                                  and t.shape == (S,)),
                    "idx, sign and mask must be contiguous (S,) int32")
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        kernel.launch(acc.data_ptr(), acc.stride(1), S, table.data_ptr(),
                      idx.data_ptr(), ptr(sign), ptr(mask),
                      self.b3_row(acc.device).data_ptr(), stream(acc))

    # -- complete add and double ---------------------------------------------
    def add(self, P, Q):
        if not is_cuda(P, Q):
            return self._stack(self.curve.add(self._coords(P), self._coords(Q)))
        kernel = self._kernel(1)
        self._check_points(P, Q)
        P, Q = self._lanes(P), self._lanes(Q)
        n = P.shape[2]
        require(Q.shape[2] == n, "add takes two batches of one width")
        out = torch.empty((self.planes, self.W, n), dtype=torch.int32,
                          device=P.device)
        kernel.launch(P.data_ptr(), P.stride(1), Q.data_ptr(), Q.stride(1),
                      out.data_ptr(), n, n, self.b3_row(P.device).data_ptr(),
                      stream(P))
        return out

    def double(self, P):
        if not is_cuda(P):
            return self._stack(self.curve.double(self._coords(P)))
        kernel = self._kernel(2)
        self._check_points(P)
        P = self._lanes(P)
        n = P.shape[2]
        out = torch.empty((self.planes, self.W, n), dtype=torch.int32,
                          device=P.device)
        kernel.launch(P.data_ptr(), P.stride(1), out.data_ptr(), n, n,
                      self.b3_row(P.device).data_ptr(), stream(P))
        return out

    # -- host decode ---------------------------------------------------------
    def to_affine_host(self, P) -> list:
        """(planes, W, n) projective -> host affine points (None = infinity);
        G2 coordinates come back as (c0, c1) pairs of ints."""
        return self.curve.to_affine_host(self._coords(P), self.F.modulus)


class TCurve(_TCurveBase):
    """An a=0 curve over Fp, points (3, W, n): G1, and BW6-761's G2."""

    NP = 1
    GROUP = "g1"

    def __init__(self, F: Field, b3_host: int):
        super().__init__(F, [b3_host], DevCurve(DevField(F), b3_host))

    def table(self, points, device):
        """Host affine points (no infinity) -> (N, 2W) Montgomery rows."""
        return self._rows([c for p in points for c in p], len(points), device)


class TCurve2(_TCurveBase):
    """G2: a=0 curve over Fp2 = Fp[u]/(u² − β), points (6, W, n)."""

    NP = 2
    GROUP = "g2"

    def __init__(self, F: Field, beta: int, b3_host):
        if beta not in (-1, -5):
            raise NotImplementedError("the G2 kernels are built for u² = −1 and u² = −5")
        c0, c1 = (b3_host.c0, b3_host.c1) if hasattr(b3_host, "c0") else b3_host
        super().__init__(F, [c0, c1], DevCurve(DevField2(F, beta), (c0, c1)))

    def table(self, points, device):
        """Host affine G2 points (Fp2 coordinates) -> (N, 4W) rows."""
        return self._rows([c for p in points for co in p for c in (co.c0, co.c1)],
                          len(points), device)
