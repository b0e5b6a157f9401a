"""Multi-scalar multiplication (Pippenger) on the card.

Port of gnark_icicle_tpu/ops/msm.py ``MSMKernel.msm`` (:521) on its
transposed path: signed c-bit digits (:82), one payload sort per window,
``searchsorted`` bucket runs, the staged waves over count-sorted
(window, bucket) lanes (:570-594, ``_wave_accumulate_t`` :187), the
weighted bucket reduction (``_bucket_reduce_t``/``_weighted_chunked_t``
:399-469) and Horner over the windows. ``pick_window`` (:51) is copied; the
windows follow the scalar field's bits as in the reference (254 bits for
BN254 r, 255 for BLS12-381 r, 253 for BLS12-377 r: 17 windows of 16 bits;
377 for BW6-761 r: 25 windows of 16 bits, 36 of the 11 bits that about 46k
points get).

The reference's wave schedule is kept: one launch of the group's
``add_mixed_masked`` kernel (``ops/ec_t.py``) per wave, which gathers each
lane's point by index and folds in the digit's sign and the lane's mask.
The ≤128-point scan path and the affine wave are not ported: a small MSM
takes the same Pippenger path and gives the same affine point.

Inputs: an affine point table of rows (``TCurve.table``), an ``(N,)`` bool
infinity mask (those lanes go to the trash bucket B, as at :540-542), and
the scalars as plain-form ``(Wr, N)`` int32 32-bit limbs (Wr words of the
scalar field: 8, or 12 for BW6-761 r). The result is one projective point,
``(planes, W, 1)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda import resolve_device
from .ec_t import _TCurveBase
from .field import ints_to_limbs32, to_lanes, words_for


def pick_window(n: int) -> int:
    """Window size c (bits): minimizes W·(N + bucket/reduction overhead)."""
    if n >= (1 << 17):
        return 16
    log = max(int(n).bit_length() - 1, 1)
    return max(2, min(16, log // 2 + 4))


class MSMKernel:
    """Pippenger MSM over one curve's group-law kernels."""

    def __init__(self, tc: _TCurveBase, scalar_bits: int):
        self.tc = tc
        self.scalar_bits = scalar_bits

    # -- phase 1: signed digits ------------------------------------------------
    def _signed_digits(self, scalars: torch.Tensor, c: int) -> torch.Tensor:
        """(Wr, N) plain 32-bit limbs -> (W, N) int64 digits in
        [-2^(c-1), 2^(c-1)]; W = ceil(bits/c) + 1 absorbs the last carry.
        A window may straddle two words; every word is read."""
        n_windows = -(-self.scalar_bits // c) + 1
        limbs = scalars.to(torch.int64) & 0xFFFFFFFF
        n_limbs = limbs.shape[0]
        half = 1 << (c - 1)
        digits = []
        carry = torch.zeros_like(limbs[0])
        for w in range(n_windows):
            li, off = divmod(c * w, 32)
            d = torch.zeros_like(limbs[0])
            if li < n_limbs:
                d = (limbs[li] >> off) & ((1 << c) - 1)
            if off + c > 32 and li + 1 < n_limbs:
                take = off + c - 32
                d = d | ((limbs[li + 1] & ((1 << take) - 1)) << (32 - off))
            d = d + carry
            wrap = d > half  # +half stays positive: buckets 1..2^(c-1)
            carry = wrap.to(torch.int64)
            digits.append(torch.where(wrap, d - (1 << c), d))
        return torch.stack(digits)

    # -- phase 3 primitives: scans along the last axis -----------------------
    def _suffix_scan(self, P: torch.Tensor, m: int) -> torch.Tensor:
        """Inclusive suffix sums out_i = Σ_{j≥i} P_j along the last axis of
        (planes, W, ..., m), as log₂(m) rounds of roll + add + select."""
        if m == 1:
            return P
        tc = self.tc
        shape = P.shape
        lane = torch.arange(m, device=P.device)
        for k in range(int(np.ceil(np.log2(m)))):
            shift = 1 << k
            rolled = torch.roll(P, -shift, dims=-1)
            added = tc.add(P.reshape(shape[0], shape[1], -1),
                           rolled.reshape(shape[0], shape[1], -1)).reshape(shape)
            P = torch.where((lane + shift) < m, added, P)
        return P

    def _weighted_chunked(self, P: torch.Tensor, m: int,
                          chunk: int = 2048) -> torch.Tensor:
        """Σ_{i<m} (i+1)·P_i along the last axis (m ≥ 2, a power of two),
        work-efficient: i = v·M + j with V lanes and M serial steps of the
        running/acc recurrence, then Σ (vM+j+1)·P = Σ_v acc_v + M·Σ_v v·T_v.

        V is ``chunk`` for m above it, as in the reference; for m ≤ chunk the
        split is square (V = 2^⌈log₂m/2⌉) where the reference runs a double
        suffix scan over all m lanes (ops/msm.py:421), which costs
        2·m·log₂m lane-adds against about 5·m here. Σ_v v·T_v is read at
        lane 1 of the second suffix scan (Σ_{v≥1} of the suffix sums); the
        reference forms it as Σ_v (v+1)·T_v − Σ_v T_v (ops/msm.py:450-454).
        Same point either way, no negation and one add fewer."""
        V = chunk if m > chunk else 1 << -(-(m.bit_length() - 1) // 2)
        M = m // V
        assert V * M == m and M & (M - 1) == 0 and V >= 2, \
            "m, chunk must be powers of 2"
        tc = self.tc
        planes, W, lead = P.shape[0], P.shape[1], P.shape[2:-1]
        g = P.reshape((planes, W) + lead + (V, M))
        width = g[..., 0].numel() // (planes * W)
        running = tc.identity(width, P.device)
        acc = tc.identity(width, P.device)
        for j in range(M - 1, -1, -1):  # running_v = T_v, acc_v = Σ_j (j+1)·P_vj
            running = tc.add(running, g[..., j].reshape(planes, W, width))
            acc = tc.add(acc, running)
        shp = (planes, W) + lead + (V,)
        sum_a = self._suffix_scan(acc.reshape(shp), V)[..., 0]
        s1 = self._suffix_scan(running.reshape(shp), V)
        hi = self._suffix_scan(s1, V)[..., 1]
        hi = hi.reshape(planes, W, -1)
        for _ in range(M.bit_length() - 1):
            hi = tc.double(hi)
        out = tc.add(hi, sum_a.reshape(planes, W, -1))
        return out.reshape((planes, W) + lead)

    def _bucket_reduce(self, buckets: torch.Tensor, W: int, B: int):
        """Σ_b (b+1)·bucket[w, b] per window: (planes, K, W·B) -> (planes, K, W)
        (K words per coordinate plane)."""
        grid = buckets.reshape(buckets.shape[0], buckets.shape[1], W, B)
        return self._weighted_chunked(grid, B)

    # -- phase 2: staged waves ---------------------------------------------------
    def _wave_accumulate(self, table, order_flat, sign_flat, starts_p,
                         counts_p, win_of_lane, stage_sizes, n, L):
        """Bucket sums, (planes, W, L), in count-sorted lane order. Wave t adds
        sorted point starts[l] + t to every lane l of the stage's prefix that
        still has points; each stage runs until every lane outside the next
        prefix is done."""
        tc = self.tc
        acc = tc.identity(L, table.device)
        stops = [stage_sizes[si + 1] for si in range(len(stage_sizes) - 1)] + [0]
        t_stops = counts_p[torch.tensor(stops, device=counts_p.device)].tolist()
        t = 0
        for S, t_stop in zip(stage_sizes, t_stops):
            starts_s, counts_s = starts_p[:S], counts_p[:S]
            base = win_of_lane[:S] * n
            while t < t_stop:
                flat_idx = base + torch.clamp(starts_s + t, 0, n - 1)
                tc.add_mixed_masked(
                    acc, S, table,
                    order_flat[flat_idx].to(torch.int32),
                    sign_flat[flat_idx].to(torch.int32),
                    (counts_s > t).to(torch.int32))
                t += 1
        return acc

    # -- the MSM ---------------------------------------------------------------
    def msm(self, table: torch.Tensor, inf_mask: torch.Tensor,
            scalars: torch.Tensor, c: int) -> torch.Tensor:
        """Σ_i s_i·P_i -> (planes, W, 1) projective."""
        tc = self.tc
        dev = scalars.device
        n = scalars.shape[1]
        B = 1 << (c - 1)
        digits = self._signed_digits(scalars, c)                  # (W, n)
        W = digits.shape[0]
        sign = (digits < 0).to(torch.int64)
        mag = digits.abs()
        bucket_id = torch.where((mag == 0) | inf_mask[None, :],
                                torch.full_like(mag, B), mag - 1)

        # one payload sort: the sign rides in the key's low bit, the point
        # index is the payload (the order inside a bucket does not matter)
        key = (bucket_id << 1) | sign
        sorted_key, order = torch.sort(key, dim=1, stable=True)
        sorted_bid = (sorted_key >> 1).contiguous()
        sorted_sign = sorted_key & 1

        bvals = torch.arange(B, device=dev).expand(W, B).contiguous()
        starts = torch.searchsorted(sorted_bid, bvals, right=False)
        counts = torch.searchsorted(sorted_bid, bvals, right=True) - starts

        # staged waves over lanes sorted by run length, descending
        L = W * B
        counts_f = counts.reshape(L)
        lane_order = torch.argsort(-counts_f, stable=True)
        inv_order = torch.argsort(lane_order)
        counts_p = counts_f[lane_order]
        starts_p = starts.reshape(L)[lane_order]
        win_of_lane = (torch.arange(L, device=dev) // B)[lane_order]

        stage_sizes = []
        s = L
        while s >= 1024 and len(stage_sizes) < 4:
            stage_sizes.append(s)
            s //= 4
        if not stage_sizes:
            stage_sizes = [L]

        acc = self._wave_accumulate(table, order.reshape(-1),
                                    sorted_sign.reshape(-1), starts_p, counts_p,
                                    win_of_lane, stage_sizes, n, L)
        per_window = self._bucket_reduce(acc[..., inv_order], W, B)  # (pl, K, W)

        # Horner over windows, top-down: acc = acc·2^c + S_w
        res = per_window[..., W - 1:W]
        for w in range(W - 2, -1, -1):
            for _ in range(c):
                res = tc.double(res)
            res = tc.add(res, per_window[..., w:w + 1])
        return res


def msm_host(tc: _TCurveBase, scalar_field, points_host, scalars_host,
             device=None, c: int | None = None):
    """Host points and ints -> host affine result (None = identity), on
    ``device`` (None: the first CUDA card).

    Port of gnark_icicle_tpu/ops/msm.py:924 for tests and small callers:
    infinity points are replaced by a real point and masked out."""
    device = resolve_device(device)
    n = len(points_host)
    assert n == len(scalars_host) and n > 0
    dummy = next((p for p in points_host if p is not None), None)
    if dummy is None:
        return None
    inf = torch.tensor([p is None for p in points_host], device=device)
    table = tc.table([p if p is not None else dummy for p in points_host],
                     device)
    q = scalar_field.modulus
    scal = to_lanes(ints_to_limbs32([int(s) % q for s in scalars_host],
                                    words_for(q)), device)
    kern = MSMKernel(tc, scalar_bits=q.bit_length())
    res = kern.msm(table, inf, scal, c or pick_window(n))
    return tc.to_affine_host(res)[0]
