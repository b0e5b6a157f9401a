"""Fr Montgomery product and subtraction on the card, with their plain twins.

Port of gnark_icicle_tpu/ops/field_t.py ``TField`` (:320), whose
``mont_mul`` (:353) is TPU kernel K1. Here it is ``csrc/fr.cu``
``fr_mont_mul``; ``fr_sub`` joins it because computeH's pointwise
``(a·b − c)·den`` runs on the card too. Operands are ``(W, n)`` int32
Montgomery tensors (``ops/field.py``); ``b`` of ``mont_mul`` may be one
``(W, 1)`` column that broadcasts. The kernels are built for the scalar
fields of BN254, BLS12-381 and BLS12-377 (W = 8) and BW6-761 (W = 12);
:class:`TField` picks the entries of its modulus.

On a CPU tensor each method runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..curves import bls12_377, bls12_381, bn254, bw6_761
from .cuda import Kernel, is_cuda, require, stream
from .field import Field

_K1 = "gnark_icicle_tpu/ops/field_t.py:353"
# scalar-field modulus -> (fr_mont_mul, fr_sub) of its curve
FR_KERNELS = {
    q: (Kernel("fr", curve, "fr_mont_mul", _K1), Kernel("fr", curve, "fr_sub", _K1))
    for q, curve in ((bn254.R, "bn254"), (bls12_381.R, "bls12_381"),
                     (bls12_377.R, "bls12_377"), (bw6_761.R, "bw6_761"))
}


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
        k_mul, _ = fr_kernels(self.F.modulus)
        check_lanes(self.F.n32, a, b)
        n = a.shape[1]
        bcast = b.shape[1] == 1 and n != 1
        require(bcast or b.shape[1] == n, "b must be (W, n) or (W, 1)")
        out = torch.empty_like(a)
        k_mul.launch(a.data_ptr(), b.data_ptr(), b.shape[1], int(bcast),
                     out.data_ptr(), n, stream(a))
        return out

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not is_cuda(a, b):
            return self.F.sub(a, b)
        _, k_sub = fr_kernels(self.F.modulus)
        check_lanes(self.F.n32, a, b)
        require(a.shape == b.shape, "fr_sub takes two (W, n) tensors")
        out = torch.empty_like(a)
        k_sub.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1],
                     stream(a))
        return out

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(x, self.F.plain_const(self.F.R2, x.device))

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(x, self.F.plain_const(1, x.device))
