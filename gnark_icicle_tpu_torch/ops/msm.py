"""Multi-scalar multiplication (Pippenger) on the card.

Port of gnark_icicle_tpu/ops/msm.py ``MSMKernel.msm`` (:521) on its
transposed path: signed c-bit digits (:82), one payload sort per window,
``searchsorted`` bucket runs, the weighted bucket reduction
(``_bucket_reduce_t``/``_weighted_chunked_t`` :399-469) and Horner over the
windows (:637-642). ``pick_window`` (:51) is copied; the windows follow the scalar
field's bits as in the reference (254 bits for BN254 r, 255 for BLS12-381 r,
253 for BLS12-377 r: 17 windows of 16 bits; 377 for BW6-761 r: 25 windows of
16 bits, 36 of the 11 bits that about 46k points get).

The bucket sums are redesigned for the card. The reference runs staged
waves over count-sorted (window, bucket) lanes (:570-594,
``_wave_accumulate_t`` :187): one launch of the group's mixed add per point
of the longest run, driven from the host. Here one launch of the group's
``bucket_accumulate`` kernel (``ops/ec_t.py``) per MSM walks every lane's
run in a loop. A run longer than ``segment_length`` points (a skewed
window: the top window of BW6-761's 377-bit scalars holds 3 bits at c = 11,
and the 2-chain's bit-valued wires pile into digit 1) is cut into segments
of at most that many points, one lane each, whose sums are folded pairwise
afterwards, so that no lane's serial chain outgrows the rest. Without a
split each bucket's points are added in the reference's order, so the
bucket sums equal the reference's limb for limb; with one the affine result
is the same point. The ≤128-point scan path and the affine wave are not
ported: a small MSM takes the same Pippenger path and gives the same
affine point.

The reduction and Horner are redesigned too. The reference runs the
running sums over V = 2,048 chunks as one scan step per bucket of a chunk,
three log-depth suffix scans over the chunks and Horner's doublings, each
round a launch of the group's add or double (342 launches per Chain MSM).
Here ``bucket_reduce`` (``ops/ec_t.py``) takes two launches: the running
sums, one thread per (window, chunk), V from ``reduce_chunks`` so that the
W·V threads fill the card, and the combine Σ_v A_v + M·Σ_v v·T_v (the
reference's identity, :410) in one block per window with O(V) adds; then
``horner`` is one launch. The order of the adds differs from the
reference's, so the projective limbs do too; the affine point is the same.

``msm_batch`` (the reference's :710-912) runs M equal-size MSMs as one
launch set: each problem's W windows stack into M·W global windows,
problem-major (:760-763), so the bucket sums are one accumulation over
M·W·B runs (point indices lifted by m·N where each problem has a table of
its own, :790-797), the reduction one over M·W windows and Horner one
launch of M warps. ``msm`` is ``msm_batch`` of one problem. The ≤128-point
path is not ported.

Inputs: an affine point table of rows (``TCurve.table``), an ``(N,)`` bool
infinity mask (those lanes go to the trash bucket B, as at :540-542), and
the scalars as plain-form ``(Wr, N)`` int32 32-bit limbs (Wr words of the
scalar field: 8, or 12 for BW6-761 r). The result is one projective point,
``(planes, W, 1)``; ``msm_batch`` takes an ``(M, N)`` mask and ``(M, Wr,
N)`` scalars and gives ``(planes, W, M)``.
"""

from __future__ import annotations

import torch

from .cuda import require, resolve_device
from .ec_t import _TCurveBase, resident_lanes
from .field import ints_to_limbs32, to_lanes, words_for


def pick_window(n: int) -> int:
    """Window size c (bits): minimizes W·(N + bucket/reduction overhead)."""
    if n >= (1 << 17):
        return 16
    log = max(int(n).bit_length() - 1, 1)
    return max(2, min(16, log // 2 + 4))


def reduce_chunks(W: int, B: int, lanes: int) -> int:
    """Chunks V per window of the bucket reduction's running sums: the
    smallest power of two with W·V ≥ lanes (the card's resident lanes,
    ``ops/ec_t.py`` ``resident_lanes``), at most B. On an H100 (33,792
    lanes) the Chain's 17 windows of 2^15 buckets get V = 2,048 (M = 16
    buckets a chunk), BW6-761's 33 windows of 2^11 get 1,024 (M = 2) and its
    36 windows of 2^10 get 1,024 (M = 1: the chunks are the buckets)."""
    need = -(-lanes // W)
    return min(B, 1 << (need - 1).bit_length())


def segment_length(n: int, c: int, scalar_bits: int, lanes: int) -> int:
    """The most points one lane of the bucket accumulation adds: the
    smallest power of two ≥ max(64, ⌈W·n / lanes⌉), with W = ⌈scalar_bits
    / c⌉ + 1 windows and lanes the card's resident lanes
    (``ops/ec_t.py`` ``resident_lanes``: 33,792 on an H100).

    The launch adds W·n points with about `lanes` threads at once, so it
    takes at least W·n / lanes adds in a row however the runs are cut. A
    run much longer than that sets the launch's time alone (the top window
    of BW6-761's 377-bit scalars holds 3 bits at c = 11: 8 buckets of about
    4,500 points); cut at seg, it becomes lanes that run side by side, plus
    ⌈log₂ segments⌉ fold rounds. Shorter segments would only add folds; the
    floor of 64 keeps small MSMs unfolded. On an H100 the 2^17 Chain MSMs
    (c = 16, 17 windows) get 128 at 2^17 points and 256 at 2^18, above
    their fullest runs on random scalars (BLS12-377's top window reaches
    only 4,780 of its buckets: about 28 and 55 points a bucket), so they
    keep the reference's per-bucket order, limb for limb; BW6-761's outer
    MSMs get 64."""
    windows = -(-scalar_bits // c) + 1
    work = -(-windows * n // lanes)
    return 1 << max(6, (work - 1).bit_length())


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

    # -- phase 2: bucket sums -----------------------------------------------
    def _runs(self, inf_mask: torch.Tensor, scalars: torch.Tensor, c: int):
        """``_runs_batch`` of one MSM: inf_mask (n,), scalars (Wr, n)."""
        return self._runs_batch(inf_mask[None], scalars[None], c, True)

    def _runs_batch(self, inf_mask: torch.Tensor, scalars: torch.Tensor, c: int,
                    shared: bool):
        """The (window, bucket) runs of M MSMs over M·W global windows,
        problem-major (problem m's windows are rows m·W .. m·W + W − 1): (order,
        sign, starts, counts, W, B) with order and sign the (M·W·n,) int32
        point index and digit sign by flat sorted position, starts and counts
        (M·W·B,) int64, W the windows of one problem. inf_mask: (M, n);
        scalars: (M, Wr, n). With ``shared`` False the table holds each
        problem's n points in turn, and problem m's indices are lifted by
        m·n (gnark_icicle_tpu/ops/msm.py:790-797)."""
        dev = scalars.device
        M, Wr, n = scalars.shape
        B = 1 << (c - 1)
        digits = self._signed_digits(scalars.permute(1, 0, 2).reshape(Wr, M * n), c)
        W = digits.shape[0]
        digits = digits.reshape(W, M, n).transpose(0, 1)          # (M, W, n)
        sign = (digits < 0).to(torch.int64)
        mag = digits.abs()
        bucket_id = torch.where((mag == 0) | inf_mask[:, None, :],
                                torch.full_like(mag, B), mag - 1)

        # one payload sort: the sign rides in the key's low bit, the point
        # index is the payload (the order inside a bucket does not matter)
        key = ((bucket_id << 1) | sign).reshape(M * W, n)
        sorted_key, order = torch.sort(key, dim=1, stable=True)
        sorted_bid = (sorted_key >> 1).contiguous()
        sorted_sign = sorted_key & 1
        if not shared and M > 1:
            order = order + (torch.arange(M, device=dev) * n).repeat_interleave(W)[:, None]

        rows = M * W
        bvals = torch.arange(B, device=dev).expand(rows, B).contiguous()
        starts = torch.searchsorted(sorted_bid, bvals, right=False)
        counts = torch.searchsorted(sorted_bid, bvals, right=True) - starts
        starts = starts + (torch.arange(rows, device=dev) * n)[:, None]
        return (order.reshape(-1).to(torch.int32), sorted_sign.reshape(-1).to(torch.int32),
                starts.reshape(-1), counts.reshape(-1), W, B)

    @staticmethod
    def _segments(starts: torch.Tensor, counts: torch.Tensor, seg: int):
        """Runs -> lanes of at most seg points: (start (int64), count
        (int32)) sorted by count descending, the permutation that puts the
        lanes back in segment order, and the segments per run (None when no
        run is longer than seg: then a lane is a run)."""
        dev = counts.device
        L = counts.shape[0]
        nseg = torch.clamp((counts + seg - 1) // seg, min=1)   # empty: 1
        total = int(nseg.sum().item())
        if total == L:
            seg_start, seg_count, nseg = starts, counts, None
        else:
            run = torch.repeat_interleave(torch.arange(L, device=dev), nseg)
            first = torch.cumsum(nseg, 0) - nseg
            j = torch.arange(total, device=dev) - first[run]
            seg_start = starts[run] + j * seg
            seg_count = torch.clamp(counts[run] - j * seg, max=seg)
        lane_order = torch.argsort(-seg_count, stable=True)
        return (seg_start[lane_order].contiguous(),
                seg_count[lane_order].to(torch.int32).contiguous(),
                torch.argsort(lane_order), nseg)

    def _accumulate(self, table, order, sign, starts, counts, seg: int):
        """Bucket sums, (planes, K, L), of the L = W·B runs: runs longer
        than seg points cut into segments (the last shorter), one lane
        each; all lanes through one bucket_accumulate launch; then each
        run's segment sums folded pairwise in segment order."""
        start, count, back, nseg = self._segments(starts, counts, seg)
        acc = self.tc.identity(count.shape[0], table.device)
        self.tc.bucket_accumulate(acc, table, order, sign, start, count)
        acc = acc[..., back]                                      # segment order
        return acc if nseg is None else self._fold_segments(acc, nseg)

    def _fold_segments(self, P: torch.Tensor, nseg: torch.Tensor) -> torch.Tensor:
        """(planes, K, Σ nseg) segment sums, each bucket's nseg[b] in a row
        -> (planes, K, len(nseg)) bucket sums: rounds of pairwise adds
        (segments 2i and 2i + 1 of a bucket), an odd last segment carried,
        until one sum is left per bucket."""
        tc = self.tc
        dev = P.device
        while int(nseg.max().item()) > 1:
            half = (nseg + 1) // 2
            first = torch.cumsum(nseg, 0) - nseg
            new_first = torch.cumsum(half, 0) - half
            bucket = torch.repeat_interleave(torch.arange(nseg.shape[0], device=dev), half)
            j = torch.arange(bucket.shape[0], device=dev) - new_first[bucket]
            left = first[bucket] + 2 * j
            pair = torch.nonzero(2 * j + 1 < nseg[bucket]).flatten()
            out = P[..., left]
            out[..., pair] = tc.add(P[..., left[pair]], P[..., left[pair] + 1])
            P, nseg = out, half
        return P

    # -- the MSM ---------------------------------------------------------------
    def msm(self, table: torch.Tensor, inf_mask: torch.Tensor,
            scalars: torch.Tensor, c: int) -> torch.Tensor:
        """Σ_i s_i·P_i -> (planes, W, 1) projective: ``msm_batch`` of one
        problem."""
        return self.msm_batch(table, inf_mask[None], scalars[None], c)

    def msm_batch(self, table: torch.Tensor, inf_mask: torch.Tensor,
                  scalars: torch.Tensor, c: int) -> torch.Tensor:
        """M equal-size MSMs as one launch set (gnark_icicle_tpu/ops/msm.py
        :710 ``msm_batch``): table (M·N, row), problem m's points at rows
        m·N .. m·N + N − 1, or any other height ≥ N, shared by every
        problem (KZG's SRS);
        inf_mask (M, N); scalars (M, Wr, N) -> (planes, W, M), column m =
        Σ_i s[m, i]·P[m, i]."""
        M, n = inf_mask.shape
        return self._msm_batch(table, inf_mask, scalars, c,
                               segment_length(M * n, c, self.scalar_bits,
                                              resident_lanes(table.device)))

    def _msm(self, table, inf_mask, scalars, c: int, seg: int) -> torch.Tensor:
        """msm with lanes of at most seg points (tests split small MSMs)."""
        return self._msm_batch(table, inf_mask[None], scalars[None], c, seg)

    def _msm_batch(self, table, inf_mask, scalars, c: int, seg: int) -> torch.Tensor:
        """msm_batch with lanes of at most seg points: the M problems' W
        windows stack into M·W global windows, so the bucket sums are one
        accumulation over M·W·B runs (one ``bucket_accumulate`` launch),
        then Σ_b (b+1)·S_{w,b} per global window (``bucket_reduce``: at most
        two launches over M·W windows) and Σ_w 2^(c·w)·S_w per problem
        (``horner``: one launch of M warps)."""
        tc = self.tc
        M, n = inf_mask.shape
        require(scalars.dim() == 3 and scalars.shape[0] == M and scalars.shape[2] == n,
                "scalars must be (M, Wr, N) beside an (M, N) infinity mask")
        shared = M == 1 or table.shape[0] != M * n
        require(table.shape[0] >= n, "the table holds fewer than N points")
        order, sign, starts, counts, W, B = self._runs_batch(inf_mask, scalars, c, shared)
        buckets = self._accumulate(table, order, sign, starts, counts, seg)
        V = reduce_chunks(M * W, B, resident_lanes(table.device))
        per_window = tc.bucket_reduce(buckets, M * W, V)          # (pl, K, M·W)
        return tc.horner(per_window, c, M)


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
