"""Batched fixed-base scalar multiplication on the card (Groth16 setup).

Port of gnark_icicle_tpu/ops/fixed_base.py (``FixedBaseMul`` :23,
``batch_scalar_mul_host`` :118). The ladder 2^i·G is computed once on the
host; the product of every scalar is then a masked mixed-add ladder of one
step per scalar bit (254 for BN254 r, 255 for BLS12-381 r, 253 for
BLS12-377 r, 377 for BW6-761 r) over all scalars at once: step i adds ladder point i on the lanes whose
scalar has bit i set. Each step is one launch of the group's
``add_mixed_masked`` kernel with mask = bit and no sign, which is where the
role of TPU kernel K6 (ops/ec_pallas.py:440, reached through DevCurve for
batches of 2048 or more) lands on the card.
"""

from __future__ import annotations

import torch

from .ec_t import _TCurveBase
from .field import ints_to_limbs32, to_lanes


class FixedBaseMul:
    """scalars × one base point, batched over the scalars."""

    def __init__(self, tc: _TCurveBase, host_group, base, scalar_bits: int,
                 device):
        self.tc = tc
        self.bits = scalar_bits
        self.device = torch.device(device)
        pows = []
        cur = base  # prime order: no infinity on the ladder
        for _ in range(scalar_bits):
            pows.append(cur)
            cur = host_group.add(cur, cur)
        self.ladder = tc.table(pows, self.device)  # (bits, row)

    def mul(self, scalars: torch.Tensor) -> torch.Tensor:
        """(Wr, N) plain 32-bit limbs -> (planes, W, N) projective products."""
        n = scalars.shape[1]
        acc = self.tc.identity(n, self.device)
        idx = torch.zeros(n, dtype=torch.int32, device=self.device)
        for i in range(self.bits):
            bit = (scalars[i // 32] >> (i % 32)) & 1
            self.tc.add_mixed_masked(acc, n, self.ladder[i:i + 1], idx,
                                     None, bit.contiguous())
        return acc


def batch_scalar_mul_host(tc: _TCurveBase, host_group, base, scalars,
                          scalar_bits: int, device, chunk: int = 1 << 18):
    """Host ints -> host affine points (None for a zero scalar).

    Work is cut into chunks of at most ``chunk`` scalars to bound device
    memory; one chunk of 2^18 G2 accumulators is 24W·2^18 bytes over Fp2
    (50 MB for BN254, 75 MB for BLS12-381 and BLS12-377) and 12W·2^18 bytes
    over Fp (75 MB for BW6-761's G1 and G2 at W = 24)."""
    fb = FixedBaseMul(tc, host_group, base, scalar_bits, device)
    out = []
    n_words = -(-scalar_bits // 32)
    for lo in range(0, len(scalars), chunk):
        part = ints_to_limbs32([int(s) for s in scalars[lo:lo + chunk]], n_words)
        out.extend(tc.to_affine_host(fb.mul(to_lanes(part, device))))
    return out
