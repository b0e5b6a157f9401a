"""Fr arithmetic on the card, with its plain twins: the Montgomery product,
subtraction and addition, the batch inverse, and PLONK's fused quotient.

Port of gnark_icicle_tpu/ops/field_t.py ``TField`` (:320), whose
``mont_mul`` (:353) is TPU kernel K1. Here it is ``csrc/fr.cu``
``fr_mont_mul``; ``fr_sub`` joins it (PLONK's quotient tables take one
subtraction; computeH's pointwise ``(a·b − c)·den`` now rides the first pass
of its coset INTT, ``ops/ntt.py``), and ``fr_add`` because PLONK's linear
combinations run on the card (gnark_icicle_tpu/backend/plonk/prove.py:223).
The NTT's entry of the same source, ``ntt_pass``, has its wrapper in
``ops/ntt.py``.
``mont_inv`` (LimbField.mont_inv :330, a Fermat power there: 379-554
products over the whole array) is one ``fr_batch_inv`` launch: Montgomery's
trick over ``BATCH_INV_LANES`` lanes a thread, one Fermat inversion each; its plain twin is ``Field.mont_inv``, whose canonical
result is the same limbs. ``plonk_quotient`` is PLONK's row function on the
4n coset (``_quotient_chunk_fn``, backend/plonk/prove.py:165-218), 20
products a row in one launch (:func:`plonk_quotient_plain` is its twin, the
reference's 21 in its order). Operands are
``(W, n)`` int32 Montgomery tensors (``ops/field.py``); ``b`` of ``mont_mul``
may be one ``(W, 1)`` column that broadcasts. The kernels are built for the
scalar fields of BN254, BLS12-381 and BLS12-377 (W = 8) and BW6-761
(W = 12); :class:`TField` picks the entries of its modulus.

On a CPU tensor each method runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..curves import bls12_377, bls12_381, bn254, bw6_761
from .cuda import Kernel, is_cuda, require, stream
from .field import Field

_K1 = "gnark_icicle_tpu/ops/field_t.py:353"
# scalar-field modulus -> {entry: Kernel} of its curve
FR_KERNELS = {
    q: {name: Kernel("fr", curve, name, _K1)
        for name in ("fr_mont_mul", "fr_sub", "fr_add", "plonk_quotient", "ntt_pass",
                     "fr_batch_inv")}
    for q, curve in ((bn254.R, "bn254"), (bls12_381.R, "bls12_381"),
                     (bls12_377.R, "bls12_377"), (bw6_761.R, "bw6_761"))
}
# plonk_quotient's 4n evaluation arrays, in the kernel's order (csrc/fr.cu)
QUOTIENT_INPUTS = ("a", "b", "c", "z", "zw", "qk", "ql", "qr", "qm", "qo",
                   "s1", "s2", "s3")
# the columns of its (W, 7) constant table
QUOTIENT_CONSTS = ("beta", "gamma", "alpha", "beta_k1", "beta_k2", "alpha2", "one")
# products a row of plonk_quotient's kernel (csrc/field.cuh quotient_row,
# the gate factored); the reference's row function has 21
QUOTIENT_PRODUCTS = 20
# fr_batch_inv (csrc/fr.cu): threads a block (BINV_T) and lanes a thread
# (BINV_K), one Fermat chain for each thread's lanes
BATCH_INV_THREADS = 64
BATCH_INV_LANES = 32


def check_lanes(W: int, *ts):
    for t in ts:
        require(t.dtype == torch.int32 and t.dim() == 2 and t.shape[0] == W
                and t.is_contiguous(), f"expected a contiguous ({W}, n) int32 tensor")


def fr_kernels(modulus: int):
    """The Fr kernel entries of a modulus; raises for a field with none."""
    if modulus not in FR_KERNELS:
        raise NotImplementedError(
            f"no Fr kernels are built for the modulus {modulus:#x}")
    return FR_KERNELS[modulus]


class TField:
    """Elementwise Fr arithmetic on ``(W, n)`` tensors (kernel K1's port)."""

    def __init__(self, F: Field):
        self.F = F

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not is_cuda(a, b):
            return self.F.mont_mul(a, b)
        k_mul = fr_kernels(self.F.modulus)["fr_mont_mul"]
        check_lanes(self.F.n32, a, b)
        n = a.shape[1]
        bcast = b.shape[1] == 1 and n != 1
        require(bcast or b.shape[1] == n, "b must be (W, n) or (W, 1)")
        out = torch.empty_like(a)
        k_mul.launch(a.data_ptr(), b.data_ptr(), b.shape[1], int(bcast),
                     out.data_ptr(), n, stream(a))
        return out

    def _elementwise(self, name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        check_lanes(self.F.n32, a, b)
        require(a.shape == b.shape, f"{name} takes two (W, n) tensors")
        out = torch.empty_like(a)
        fr_kernels(self.F.modulus)[name].launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                                a.shape[1], stream(a))
        return out

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not is_cuda(a, b):
            return self.F.sub(a, b)
        return self._elementwise("fr_sub", a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not is_cuda(a, b):
            return self.F.add(a, b)
        return self._elementwise("fr_add", a, b)

    def mont_inv(self, a: torch.Tensor) -> torch.Tensor:
        """The elementwise inverse of a (W, n) Montgomery array, 0 mapping to
        0 (LimbField.mont_inv :330): on the card one ``fr_batch_inv``
        launch, Montgomery's trick over BATCH_INV_LANES lanes a thread; on
        the CPU the Fermat power ``Field.mont_inv``."""
        if not is_cuda(a):
            return self.F.mont_inv(a)
        check_lanes(self.F.n32, a)
        out = torch.empty_like(a)
        fr_kernels(self.F.modulus)["fr_batch_inv"].launch(
            a.data_ptr(), out.data_ptr(), a.shape[1], stream(a))
        return out

    def plonk_quotient(self, evals, xs, l1, zh_inv, consts) -> torch.Tensor:
        """PLONK's quotient numerator over Z_H on the 4n coset, row by row.

        evals: the 13 (W, m) arrays of QUOTIENT_INPUTS; xs, l1: (W, m) coset
        points and L1 there; zh_inv: (W, 4) the cycle of 1/Z_H (row i takes
        column i mod 4); consts: (W, 7), the columns of QUOTIENT_CONSTS, on
        the CPU or on the arrays' device (the kernel takes them by value: a
        CPU table spares a copy back from the card). All Montgomery; returns
        (W, m)."""
        ins = list(evals) + [xs, l1]
        if not is_cuda(*ins, zh_inv):
            return plonk_quotient_plain(self.F, evals, xs, l1, zh_inv, consts)
        W = self.F.n32
        consts = consts.cpu()
        check_lanes(W, *ins, zh_inv, consts)
        m = xs.shape[1]
        require(len(evals) == len(QUOTIENT_INPUTS)
                and all(t.shape[1] == m for t in ins)
                and zh_inv.shape[1] == 4 and consts.shape[1] == len(QUOTIENT_CONSTS),
                "plonk_quotient takes 15 (W, m) arrays, a (W, 4) and a (W, 7) table")
        out = torch.empty_like(xs)
        ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
        fr_kernels(self.F.modulus)["plonk_quotient"].launch(
            ctypes.addressof(ptrs), consts.data_ptr(), zh_inv.data_ptr(),
            out.data_ptr(), m, stream(xs))
        return out

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(x, self.F.plain_const(self.F.R2, x.device))

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(x, self.F.plain_const(1, x.device))


def plonk_quotient_plain(F: Field, evals, xs, l1, zh_inv, consts) -> torch.Tensor:
    """The plain version of ``plonk_quotient``: the reference's row function
    (gnark_icicle_tpu/backend/plonk/prove.py:186-217), op for op."""
    A, B, C, z, zw, qk, ql, qr, qm, qo, s1, s2, s3 = evals
    beta, gamma, alpha, bk1, bk2, alpha2, one = (consts[:, i:i + 1]
                                                  for i in range(len(QUOTIENT_CONSTS)))
    mul, add = F.mont_mul, F.add
    gate = mul(ql, A)
    gate = add(gate, mul(qr, B))
    gate = add(gate, mul(mul(qm, A), B))
    gate = add(gate, mul(qo, C))
    gate = add(gate, qk)
    lhs = add(add(A, mul(beta, xs)), gamma)
    lhs = mul(lhs, add(add(B, mul(bk1, xs)), gamma))
    lhs = mul(lhs, add(add(C, mul(bk2, xs)), gamma))
    lhs = mul(lhs, z)
    rhs = add(add(A, mul(beta, s1)), gamma)
    rhs = mul(rhs, add(add(B, mul(beta, s2)), gamma))
    rhs = mul(rhs, add(add(C, mul(beta, s3)), gamma))
    rhs = mul(rhs, zw)
    perm = F.sub(rhs, lhs)
    start = mul(l1, F.sub(z, one))
    num = add(gate, add(mul(alpha, perm), mul(alpha2, start)))
    rows = torch.arange(xs.shape[1], device=xs.device) % 4
    return mul(num, zh_inv[:, rows])
