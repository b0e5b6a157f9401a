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

Kernels (``csrc/g1.cu``, ``csrc/g2.cu``; the reduction and Horner in
``csrc/g1_reduce.cu``, ``csrc/g2_reduce.cu``):

* ``bucket_accumulate`` — K4/K5 (ops/ec_t.py:529, :896) in their MSM role,
  redesigned for the card: one launch per MSM, each lane adding its whole
  run of sorted points (gathered by index, signed) in a loop, where the
  reference launches one wave step per point of the longest run;
* ``add_mixed_masked`` — K4/K5 as one wave step: acc += (±)table[idx] where
  mask, in place, with the gather, sign and mask inside the kernel (no
  caller on the path since setup's batches run the comb);
* ``fixed_base`` — K6 (ops/ec_pallas.py:440) in its role in setup and the
  SRS, redesigned for the card: the fixed-base product of every lane's
  scalar through a comb table, one launch of the bucket accumulation's
  kernel, where the reference launches one masked mixed add per scalar bit;
* ``normalize`` — the JAX package's ``batch_normalize`` (ops/fixed_base.py:95):
  projective to affine plain words and an infinity flag, Montgomery's trick
  over k lanes a thread, one launch;
* ``bucket_reduce`` and ``horner`` — K2/K3 (ops/ec_t.py:266, :649) in their
  MSM role, redesigned for the card: the weighted bucket reduction
  Σ_b (b+1)·S_{w,b} per window in two launches (``reduce_runs``, the running
  sums over chunks of M buckets; ``reduce_combine``, one block a window) and
  Horner Σ_w 2^(c·w)·S_w in one (a warp's lanes take each round's
  independent products; one warp a problem over the M problems of
  ``msm_batch``), where the reference launches one add or double per round
  of its scans and Horner loop;
* ``add`` and ``double`` — the complete RCB16 add and double, the products
  of K2/K3 fused per call (the MSM's fold of split buckets; the double has
  no caller on the path).

The mixed-add, reduction and Horner entries are built for the b3 of their
curve's groups, each in its own form (``csrc/field.cuh``: an add chain where
b3 is a small integer); the wrapper passes which group its b3 is
(``group_flag``: 0 G1, 1 G2) and launches nothing for a b3 of neither.

For CPU tensors each method runs the plain version, ``ops/ec.py``
``DevCurve`` (a few lanes on Python ints: ``IntField``, the same canonical
values); for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..curves import bls12_377, bls12_381, bn254, bw6_761
from .cuda import Kernel, is_cuda, require, stream
from .ec import DevCurve, DevField, DevField2, IntField, IntField2
from .field import Field, from_lanes, ints_to_limbs32, limbs32_to_ints, to16, to32, to_lanes


# entries of one group, in the order of _group_kernels; all but B3_FREE
# use the b3 form of a group (group_flag)
ENTRIES = ("add_mixed_masked", "add", "double", "bucket_accumulate", "bucket_reduce",
           "reduce_combine", "horner", "fixed_base", "normalize")
B3_FREE = ("add", "double", "normalize")
REDUCTION = ("bucket_reduce", "reduce_combine", "horner")


def _group_kernels(curve: str, g: str, k_mixed: str, k_mul: str):
    """The ENTRIES of one group of one curve: the mixed adds replace
    k_mixed, the comb K6 (setup's fixed-base ladders) and the normalization
    the JAX package's batch_normalize, the others (the complete add and
    double, and the reduction and Horner that run them) k_mul; the
    reduction and Horner entries are built from ``<g>_reduce.cu``, the
    others from ``<g>.cu``."""
    replaces = {"add_mixed_masked": k_mixed, "bucket_accumulate": k_mixed,
                "fixed_base": "gnark_icicle_tpu/ops/ec_pallas.py:440",
                "normalize": "gnark_icicle_tpu/ops/fixed_base.py:95"}
    return tuple(Kernel(f"{g}_reduce" if e in REDUCTION else g, curve, f"{g}_{e}",
                        replaces.get(e, k_mul)) for e in ENTRIES)


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


def _b3_ints(c) -> list:
    """3b of a group as base-field ints: [b3] over Fp, [c0, c1] over Fp2."""
    b3 = c.b * 3
    return [b3.c0, b3.c1] if hasattr(b3, "c0") else [b3]


# base-field modulus -> (G1's b3, G2's b3) of its curve, reduced mod p
_GROUP_B3 = {c.fp.modulus: tuple([v % c.fp.modulus for v in _b3_ints(g)] for g in (c.g1, c.g2))
             for c in (bn254.BN254, bls12_381.BLS12_381, bls12_377.BLS12_377, bw6_761.BW6_761)}

# threads of a combine block at most (csrc/field.cuh COMBINE_T)
COMBINE_THREADS = 128

# the batch normalization (csrc/field.cuh k_normalize): threads a block
# (NORM_T) and lanes a thread, the k of its Montgomery's trick. A thread's
# chain of products runs alone, so the launch wants many threads: on an H100
# k = 16 was the fastest of 16, 32 and 64 on the G2 and BW6-761 batches and
# 0.1-1.1 ms behind the best on the 656,677-lane G1 batches, whose comb takes
# 24-76 ms (fixed_base_ab.py, PERF.md §6)
NORMALIZE_THREADS = 64
NORMALIZE_LANES = 16


def comb_digits(scalars: torch.Tensor, w: int, bits: int) -> torch.Tensor:
    """(Wr, n) plain int32 scalar words -> (J, n) int64 digits of the comb,
    J = ⌈bits / w⌉: digit j is the w bits from bit w·j (the top window only
    those below ``bits``), as csrc/field.cuh ``fb_digit`` reads them."""
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    out = []
    for j in range(-(-bits // w)):
        k, sh = divmod(w * j, 32)
        d = v[k] >> sh
        if sh + w > 32 and k + 1 < v.shape[0]:
            d = d | (v[k + 1] << (32 - sh))
        out.append(d & ((1 << min(w, bits - w * j)) - 1))
    return torch.stack(out)

# the launch of k_mixed_accumulate (csrc/field.cuh Stage<E>): T threads a
# block, at least MIN_BLOCKS blocks an SM (its shared memory and at most 255
# registers a thread allow that many)
MIXED_THREADS = 128
MIXED_MIN_BLOCKS = 2
H100_SMS = 132


def resident_lanes(device) -> int:
    """Lanes of the bucket accumulation the card runs at once, at least: its
    SMs × MIXED_MIN_BLOCKS × MIXED_THREADS (an 8-word G1 lane, at fewer
    registers, may get more blocks). The CPU, which runs the plain version,
    counts the H100's 132 SMs, so that it splits runs as the card does."""
    device = torch.device(device)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    return sms * MIXED_MIN_BLOCKS * MIXED_THREADS


def _ptr(t):
    return None if t is None else t.data_ptr()


class _TCurveBase:
    NP = 1     # planes per coordinate
    GROUP = ""  # "g1" or "g2": the kernel family

    def __init__(self, F: Field, b3_host: list, curve: DevCurve):
        self.F = F
        self.W = F.n32                          # words per Fp element
        self.curve = curve                      # the plain version
        # Montgomery b3, NP*W words
        self._b3_words = [w for c in b3_host for w in self._words(c)]
        # which of its curve's groups b3 is 3b of (None: neither)
        b3 = [c % F.modulus for c in b3_host]
        g1_b3, g2_b3 = _GROUP_B3.get(F.modulus, (None, None))
        self.group_flag = 0 if b3 == g1_b3 else 1 if b3 == g2_b3 else None
        self._b3: dict = {}
        self._icurve = None
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

    def _check_table(self, table) -> None:
        """The kernels copy a table row in 16-byte chunks (cp.async)."""
        require(table.dtype == torch.int32 and table.is_contiguous()
                and table.dim() == 2 and table.shape[1] == self.row
                and table.data_ptr() % 16 == 0,
                f"table must be contiguous, 16-byte aligned (M, {self.row}) int32 rows")

    def _kernel(self, i: int) -> Kernel:
        """Entry i of ENTRIES; raises for a curve whose kernels are not
        built, and for an entry with a b3 form (all but B3_FREE) whose b3 is
        neither of its curve's groups'."""
        if self._kernels is None:
            raise NotImplementedError(
                f"no {self.GROUP} kernels are built for the base field "
                f"{self.F.modulus:#x}")
        if ENTRIES[i] not in B3_FREE and self.group_flag is None:
            raise NotImplementedError(
                "the mixed-add, reduction and Horner kernels are built for their "
                "curve's G1 and G2 b3 (csrc/field.cuh); this b3 is neither")
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
        Q = table[idx[lanes].long()].T.reshape(2 * self.NP, self.W, k)
        if sign is not None:
            y = Q[self.NP:]
            neg = torch.stack([self.F.neg(c) for c in y])
            Q = torch.cat([Q[:self.NP], torch.where(sign[lanes] != 0, neg, y)])
        acc[:, :, lanes] = self._plain("add_mixed", acc[:, :, lanes], Q)

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
        self._check_table(table)
        for t in (idx, sign, mask):
            require(t is None or (t.dtype == torch.int32 and t.is_contiguous()
                                  and t.shape == (S,)),
                    "idx, sign and mask must be contiguous (S,) int32")
        kernel.launch(acc.data_ptr(), acc.stride(1), S, table.data_ptr(),
                      idx.data_ptr(), _ptr(sign), _ptr(mask),
                      self.b3_row(acc.device).data_ptr(), self.group_flag, stream(acc))

    # -- the MSM's bucket accumulation ---------------------------------------
    def bucket_accumulate_plain(self, acc, table, order, sign, start, count):
        """The plain version of ``bucket_accumulate``: the reference's wave
        schedule (gnark_icicle_tpu/ops/msm.py:187), wave t adding point
        start[l] + t of every lane that still has one."""
        L = acc.shape[2]
        count = count.long()
        top = int(count.max().item()) if L else 0
        last = max(order.shape[0] - 1, 0)
        for t in range(top):
            pos = torch.clamp(start + t, max=last)
            self.add_mixed_masked_plain(
                acc, L, table, order[pos],
                None if sign is None else sign[pos], (count > t).to(torch.int32))

    def bucket_accumulate(self, acc, table, order, sign, start, count):
        """acc[..., l] += Σ_{t < count[l]} (−1)^sign[s] · table[order[s]] with
        s = start[l] + t, in place: every lane's run of sorted points at once.

        acc: contiguous (planes, W, L) projective accumulators; table: (M, row)
        affine rows; order, sign: (n,) int32 point index and sign by sorted
        position (sign may be None: all positive); start: (L,) int64 and
        count: (L,) int32, each lane's run. The kernel adds a lane's points in
        their order, so the result equals the plain version's limb for limb;
        lanes sorted by count, descending, keep a warp's loops even."""
        if not is_cuda(acc, table, order, sign, start, count):
            return self.bucket_accumulate_plain(acc, table, order, sign, start, count)
        kernel = self._kernel(3)
        self._check_points(acc)
        L = acc.shape[2]
        require(acc.is_contiguous(), "acc must be a contiguous (planes, W, L) tensor")
        self._check_table(table)
        for t in (order, sign):
            require(t is None or (t.dtype == torch.int32 and t.is_contiguous()
                                  and t.dim() == 1),
                    "order and sign must be contiguous (n,) int32")
        require(start.dtype == torch.int64 and count.dtype == torch.int32
                and start.shape == (L,) and count.shape == (L,)
                and start.is_contiguous() and count.is_contiguous(),
                "start must be (L,) int64 and count (L,) int32, contiguous")
        kernel.launch(acc.data_ptr(), L, table.data_ptr(), order.data_ptr(),
                      _ptr(sign), start.data_ptr(), count.data_ptr(),
                      self.b3_row(acc.device).data_ptr(), self.group_flag, stream(acc))

    # -- setup's fixed-base comb and batch normalization --------------------
    def fixed_base_plain(self, scalars, table, w: int, bits: int):
        """The plain version of ``fixed_base``: from the identity, window j
        upwards, the masked mixed add of row j·(2^w − 1) + d_j − 1 on the
        lanes whose digit d_j is nonzero."""
        n = scalars.shape[1]
        acc = self.identity(n, scalars.device)
        rows = (1 << w) - 1
        for j, d in enumerate(comb_digits(scalars, w, bits)):
            self.add_mixed_masked_plain(acc, n, table, (j * rows + d - 1).to(torch.int32),
                                        None, (d != 0).to(torch.int32))
        return acc

    def fixed_base(self, scalars, table, w: int, bits: int):
        """Σ_j table[j·(2^w − 1) + d_j − 1] over the nonzero w-bit digits d_j
        of each lane's scalar (``comb_digits``), j upwards, from the identity:
        the fixed-base product s·G through its comb table (ops/fixed_base.py
        ``comb_table``: row (j, d) is d·2^(w·j)·G).

        scalars: (Wr, n) int32 plain words of at most ``bits`` bits; table:
        (⌈bits / w⌉·(2^w − 1), row) affine rows; 1 ≤ w ≤ 16. Returns (planes,
        W, n) projective points, the identity where s = 0. One launch of
        the mixed-add kernel in its comb mode, which first writes each
        lane's rows to a scratch of ⌈bits / w⌉ int32 a lane and then walks
        them as the MSM walks a bucket; equal to the plain version limb
        for limb."""
        require(1 <= w <= 16 and scalars.dim() == 2 and 1 <= bits <= 32 * scalars.shape[0]
                and table.shape[0] >= -(-bits // w) * ((1 << w) - 1),
                "fixed_base takes 1 <= w <= 16, (Wr, n) scalars of at most 32·Wr bits "
                "and a table of ⌈bits / w⌉·(2^w − 1) rows")
        if not is_cuda(scalars, table):
            return self.fixed_base_plain(scalars, table, w, bits)
        kernel = self._kernel(7)
        self._check_table(table)
        require(scalars.dtype == torch.int32 and scalars.is_contiguous(),
                "scalars must be contiguous (Wr, n) int32")
        n = scalars.shape[1]
        out = self.identity(n, scalars.device)
        rows = torch.empty(n * -(-bits // w), dtype=torch.int32, device=scalars.device)
        kernel.launch(out.data_ptr(), n, scalars.data_ptr(), scalars.shape[0], bits, w,
                      table.data_ptr(), rows.data_ptr(), self.b3_row(out.device).data_ptr(),
                      self.group_flag, stream(out))
        return out

    def _trick_value(self, Z):
        """What the normalization's Montgomery trick inverts (csrc/field.cuh
        ``trick_value``): Z over Fp, z0² − β·z1² over Fp2; (W, n) words."""
        F = self.F
        if self.NP == 1:
            return Z[0]
        z0, z1 = (to16(z) for z in Z)
        m1 = F.mont_mul16(z1, z1)
        return to32(F.add16(F.mont_mul16(z0, z0), self.curve.f._beta_term(m1)))

    def normalize_plain(self, P, k: int = NORMALIZE_LANES):
        """The plain version of ``normalize``: the kernel's Montgomery trick,
        thread by thread as lanes of one batch (thread t of block b takes
        lanes b·T·k + i·T + t, i < k): the running products of the trick
        values (the word 1 where Z = 0 and past the last lane), one
        inversion, each lane's inverse from the product before it, all
        times R⁻¹ (a product with the word 1), so that X·z⁻¹ comes out plain."""
        F, NP, W = self.F, self.NP, self.W
        n = P.shape[2]
        T = NORMALIZE_THREADS
        groups = -(-n // (T * k)) * T
        Z = P[2 * NP:3 * NP]
        zero = (Z == 0).all(dim=1).all(dim=0)
        word1 = F.plain_const(1, P.device)
        v = torch.where(zero, word1, self._trick_value(Z))
        v = torch.cat([v, word1.expand(W, groups * k - n)], 1)
        v = v.reshape(W, -1, k, T).transpose(1, 2).reshape(W, k, groups)  # [:, i]: step i
        run = [v[:, 0]]
        for i in range(1, k):
            run.append(F.mont_mul(run[-1], v[:, i]))
        d = F.mont_mul(F.mont_inv(run[-1]), word1)
        inv = [None] * k
        for i in range(k - 1, -1, -1):
            inv[i] = d if i == 0 else F.mont_mul(d, run[i - 1])
            if i > 0:
                d = F.mont_mul(d, v[:, i])
        di = torch.stack(inv, 1).reshape(W, k, -1, T).transpose(1, 2).reshape(W, -1)[:, :n]
        if NP == 1:
            zi = di
            x, y = F.mont_mul(P[0], zi), F.mont_mul(P[1], zi)
        else:
            zi = (to16(F.mont_mul(Z[0], di)), to16(F.neg(F.mont_mul(Z[1], di))))
            x, y = (torch.stack([to32(c) for c in self.curve.f.mul(self._coords(P[i:i + 2])[0], zi)])
                    for i in (0, 2))
        xy = torch.cat([x.reshape(NP, W, n), y.reshape(NP, W, n)])
        return torch.where(zero, 0, xy), zero.to(torch.int32)

    def normalize(self, P, k: int = NORMALIZE_LANES):
        """Projective (planes, W, n), Z canonical -> (xy, inf): the affine x
        and y as canonical PLAIN words (2·NP, W, n) (x0, x1, y0, y1 over Fp2)
        and inf (n,) int32, 1 where Z = 0 (x = y = 0 there). The port of the
        JAX package's batch_normalize, whose Montgomery (x, y) are these
        words times R: one launch, Montgomery's trick over k lanes a thread
        (one Fermat inversion each), the result left plain for the host."""
        require(k >= 1, "normalize takes k >= 1 lanes a thread")
        if not is_cuda(P):
            return self.normalize_plain(P, k)
        kernel = self._kernel(8)
        self._check_lanes(P)
        n = P.shape[2]
        xy = torch.empty((2 * self.NP, self.W, n), dtype=torch.int32, device=P.device)
        inf = torch.empty(n, dtype=torch.int32, device=P.device)
        kernel.launch(P.data_ptr(), n, xy.data_ptr(), inf.data_ptr(), k, stream(P))
        return xy, inf

    # -- the MSM's bucket reduction and Horner ------------------------------
    # a CPU batch of at most this many lanes runs the plain group law on
    # Python ints (ops/ec.py IntField): the same canonical values
    SMALL_LANES = 4096

    def _int_curve(self) -> DevCurve:
        if self._icurve is None:
            f = (IntField(self.F) if self.NP == 1
                 else IntField2(self.F, self.curve.f.beta))
            self._icurve = DevCurve(f, self.curve.b3_host)
        return self._icurve

    def _plain(self, op: str, *Ps):
        """DevCurve's ``op`` ("add", "add_mixed" or "double") of (planes,
        W, ...) batches (an affine operand: 2·NP planes). A few canonical
        lanes on the CPU run it on Python ints, decoded once a call, in the
        same order of operations."""
        shape = Ps[0].shape
        flat = [P.reshape(P.shape[0], self.W, -1) for P in Ps]
        n = flat[0].shape[2]
        if flat[0].device.type == "cpu" and 0 < n <= self.SMALL_LANES:
            planes = [[limbs32_to_ints(from_lanes(c)) for c in P] for P in flat]
            q = self.F.modulus
            if all(v < q for pl in planes for c in pl for v in c):
                k = self.NP
                pts = [tuple(pl) if k == 1 else
                       tuple(tuple(pl[i:i + 2]) for i in range(0, len(pl), 2)) for pl in planes]
                out = getattr(self._int_curve(), op)(*pts)
                out = [x for co in out for x in ((co,) if k == 1 else co)]
                return torch.stack([to_lanes(ints_to_limbs32(v, self.W), "cpu")
                                    for v in out]).reshape(shape)
        return self._stack(getattr(self.curve, op)(*[self._coords(P) for P in flat])
                           ).reshape(shape)

    def _padd(self, P, Q):
        """DevCurve's add of two (planes, W, ...) batches."""
        return self._plain("add", P, Q)

    def _pdouble(self, P):
        return self._plain("double", P)

    def _check_lanes(self, *Ps):
        self._check_points(*Ps)
        for P in Ps:
            require(P.stride(2) == 1 and P.stride(1) == P.shape[2]
                    and P.stride(0) == P.shape[1] * P.shape[2],
                    "point planes must be contiguous (planes, W, n)")

    def reduce_runs_plain(self, S, M: int):
        """The plain version of ``reduce_runs``: lane l's chunk S_{lM+j},
        j < M, from j = M − 1 down: running += S_j, acc += running."""
        g = S.reshape(self.planes, self.W, -1, M)
        run = acc = g[..., M - 1]
        for j in range(M - 2, -1, -1):
            run = self._padd(run, g[..., j])
            acc = self._padd(acc, run)
        return torch.cat([run, acc]).contiguous()

    def reduce_runs(self, S, M: int):
        """Running sums of L = n / M chunks of M points: S (planes, W, n)
        -> (2·planes, W, L), the planes of T_l = Σ_j S_{lM+j} followed by
        those of A_l = Σ_j (j+1)·S_{lM+j}."""
        if not is_cuda(S):
            return self.reduce_runs_plain(S, M)
        kernel = self._kernel(4)
        self._check_lanes(S)
        require(M >= 1 and S.shape[2] % M == 0, "the points must be whole chunks of M")
        L = S.shape[2] // M
        out = torch.empty((2 * self.planes, self.W, L), dtype=torch.int32, device=S.device)
        kernel.launch(S.data_ptr(), L, M, out.data_ptr(), self.b3_row(S.device).data_ptr(),
                      self.group_flag, stream(S))
        return out

    def reduce_combine_plain(self, T, A, W: int, V: int, M: int):
        """The plain version of ``reduce_combine``: the kernel's threads
        (ct = min(V, COMBINE_THREADS) a window, r = V / ct chunks each) as
        lanes, in its order: the serial runs (T_t, A_t and G_t =
        Σ_i i·T_{tr+i}), the suffix scan U_t = Σ_{u≥t} T_u over the threads,
        Y_t = A_t + M·(G_t + r·U_t) (no U_0) and the tree Σ_t Y_t."""
        pl, K = self.planes, self.W
        ct = min(V, COMBINE_THREADS)
        r = V // ct
        t = T.reshape(pl, K, W, ct, r)
        a = A.reshape(pl, K, W, ct, r)
        Tt, At = t[..., r - 1], a[..., r - 1]
        G = Tt if r > 1 else None
        for i in range(r - 2, 0, -1):
            Tt = self._padd(Tt, t[..., i])
            G = self._padd(G, Tt)
        for i in range(r - 2, -1, -1):
            At = self._padd(At, a[..., i])
        if r > 1:
            Tt = self._padd(Tt, t[..., 0])
        h = 1
        while h < ct:               # thread t += thread t + h, from before the round
            Tt = torch.cat([self._padd(Tt[..., :ct - h], Tt[..., h:]), Tt[..., ct - h:]], -1)
            h *= 2
        first = 0                   # the first thread with a G term
        if ct > 1:
            U = Tt[..., 1:]         # threads 1 .. ct − 1
            for _ in range(r.bit_length() - 1):
                U = self._pdouble(U)
            first = 0 if G is not None else 1
            G = U if G is None else torch.cat([G[..., :1], self._padd(G[..., 1:], U)], -1)
        if G is not None:
            for _ in range(M.bit_length() - 1):
                G = self._pdouble(G)
            At = torch.cat([At[..., :first], self._padd(At[..., first:], G)], -1)
        while At.shape[-1] > 1:     # the tree: pairs 2i, 2i + 1
            At = self._padd(At[..., 0::2], At[..., 1::2])
        return At.reshape(pl, K, W).contiguous()

    def reduce_combine(self, T, A, W: int, V: int, M: int):
        """S_w = Σ_v A_v + M·Σ_v v·T_v per window: T, A (planes, W, W·V),
        window w's chunks at lanes wV .. wV + V − 1 (V and M powers of two)
        -> (planes, W, W)."""
        require(V >= 1 and V & (V - 1) == 0 and M >= 1 and M & (M - 1) == 0,
                "V and M must be powers of two")
        if not is_cuda(T, A):
            return self.reduce_combine_plain(T, A, W, V, M)
        kernel = self._kernel(5)
        for X in (T, A):
            self._check_points(X)
            require(X.shape[2] == W * V and X.stride(2) == 1
                    and X.stride(0) == X.shape[1] * X.stride(1) and X.stride(1) == W * V,
                    "T and A must be (planes, W, W·V) with unit lane stride")
        out = torch.empty((self.planes, self.W, W), dtype=torch.int32, device=T.device)
        kernel.launch(T.data_ptr(), A.data_ptr(), W * V, W, V, M.bit_length() - 1,
                      out.data_ptr(), self.b3_row(T.device).data_ptr(), self.group_flag,
                      stream(T))
        return out

    def bucket_reduce(self, buckets, W: int, V: int):
        """Σ_b (b+1)·S_{w,b} per window: buckets (planes, W, W·B) -> (planes,
        W, W), the B = V·M buckets of each window in V chunks of M. With M =
        1 the chunks are the buckets (T = A = S) and only the combine runs."""
        M = buckets.shape[2] // (W * V)
        if M == 1:
            return self.reduce_combine(buckets, buckets, W, V, 1)
        TA = self.reduce_runs(buckets, M)
        return self.reduce_combine(TA[:self.planes], TA[self.planes:], W, V, M)

    def horner_plain(self, S, c: int, M: int = 1):
        """The plain version of ``horner``: per problem m, res = S_{W−1};
        per window from W − 2 down, c doubles and res += S_w (the M
        problems side by side as lanes)."""
        g = S.reshape(self.planes, self.W, M, S.shape[2] // M)
        W = g.shape[3]
        res = g[..., W - 1]
        for w in range(W - 2, -1, -1):
            for _ in range(c):
                res = self._pdouble(res)
            res = self._padd(res, g[..., w])
        return res.contiguous()

    def horner(self, S, c: int, M: int = 1):
        """Σ_w 2^(c·w)·S_w of each of M problems' window sums: S (planes,
        W, M·Wn), problem m's Wn windows at lanes m·Wn .. m·Wn + Wn − 1 ->
        (planes, W, M). One launch of M warps, one a problem, each round's
        independent products on lanes of their own."""
        require(M >= 1 and S.shape[2] >= M and S.shape[2] % M == 0,
                "Horner takes at least one window a problem, M problems of equal width")
        if not is_cuda(S):
            return self.horner_plain(S, c, M)
        kernel = self._kernel(6)
        self._check_lanes(S)
        out = torch.empty((self.planes, self.W, M), dtype=torch.int32, device=S.device)
        kernel.launch(S.data_ptr(), S.shape[2] // M, M, c, out.data_ptr(),
                      self.b3_row(S.device).data_ptr(), self.group_flag, stream(S))
        return out

    # -- complete add and double ---------------------------------------------
    def add(self, P, Q):
        if not is_cuda(P, Q):
            return self._padd(P, Q)
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
            return self._pdouble(P)
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

    def affine_host(self, xy, inf) -> list:
        """``normalize``'s (xy, inf) -> host affine points (None = infinity),
        in ``to_affine_host``'s form; each coordinate plane is decoded to
        ints in one vectorised pass."""
        cols = [limbs32_to_ints(from_lanes(c)) for c in xy]
        pts = (zip(cols[0], cols[1]) if self.NP == 1
               else zip(zip(cols[0], cols[1]), zip(cols[2], cols[3])))
        return [None if f else pt for pt, f in zip(pts, inf.tolist())]


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
