"""The MSM's bucket reduction and Horner (gnark_icicle_tpu_torch/ops/ec_t.py
``bucket_reduce``, ``horner``), their plain versions on the CPU, against the
host oracle: Σ_b (b+1)·S_{w,b} per window and Σ_w 2^(c·w)·T_w, in affine
form, for BN254 G1 and G2 and BW6-761 G1 (24-word Fp) at small W and B, with
the edges M = 1 (the chunks are the buckets), V = 1 (one chunk a window),
r > 1 (more chunks than combine threads), identity buckets and an empty
window. The BN254 G1 reduction is also held to the JAX package's
``MSMKernel._bucket_reduce_t`` on the same bucket sums, in both of its
branches: the double suffix scan (B ≤ 2,048) and the chunked running sums
that the Chain's B = 2^15 takes.

The bucket sums are multiples k·G of the generator in projective form with
a random Z, so that each oracle is one host scalar product.
"""

import random

import numpy as np
import pytest
import torch

from gnark_icicle_tpu_torch.ops.ec_t import COMBINE_THREADS, TCurve, TCurve2
from gnark_icicle_tpu_torch.ops.field import field_for
from gnark_icicle_tpu_torch.ops.msm import reduce_chunks

from test_torch_common import CURVES, g2_over_fp2


def _group(name, group):
    curve = CURVES[name]
    p = curve.fp.modulus
    grp = curve.g1 if group == "g1" else curve.g2
    if group == "g2" and g2_over_fp2(curve):
        return curve, grp, TCurve2(field_for(p), curve.tower.beta, grp.b * 3)
    return curve, grp, TCurve(field_for(p), 3 * grp.b % p)


def _projective(curve, grp, tc, ks, seed, pts=None):
    """(planes, W, n) projective planes of k·G for each k (k = 0: the
    identity (0 : 1 : 0)), each with a random Z; pts: the affine points
    k·G where the caller has them (None for the identity)."""
    p = curve.fp.modulus
    rng = random.Random(seed)
    planes = [[] for _ in range(tc.planes)]
    if pts is None:
        pts = [grp.scalar_mul(grp.generator, k) if k else None for k in ks]
    for pt in pts:
        if pt is None:
            coords = [0] * tc.NP + [1] + [0] * (tc.NP - 1) + [0] * tc.NP
        else:
            z = rng.randrange(1, p)
            xy = [c for co in pt for c in ((co.c0, co.c1) if tc.NP == 2 else (co,))]
            coords = [c * z % p for c in xy] + [z] + [0] * (tc.NP - 1)
        for i, c in enumerate(coords):
            planes[i].append(c)
    return torch.stack([tc.F.encode(vals, "cpu") for vals in planes])


def _affine(grp, tc, k):
    pt = grp.scalar_mul(grp.generator, k % grp.order) if k % grp.order else None
    if pt is None or tc.NP == 1:
        return pt
    return ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))


@pytest.mark.parametrize("name, group, W, B, V", [
    ("bn254", "g1", 3, 8, 2),      # M = 4, window 1 empty
    ("bn254", "g1", 2, 8, 1),      # V = 1: one chunk, one combine thread
    ("bn254", "g1", 2, 4, 4),      # M = 1: the chunks are the buckets
    ("bn254", "g1", 1, 2 * 2 * COMBINE_THREADS, 2 * COMBINE_THREADS),  # r = 2
    ("bn254", "g2", 2, 8, 2),
    ("bw6_761", "g1", 2, 4, 2),
])
def test_bucket_reduce_matches_host_oracle(name, group, W, B, V):
    curve, grp, tc = _group(name, group)
    rng = np.random.default_rng(W * 1000 + B + V)
    ks = [int(k) for k in rng.integers(1, 1 << 30, size=W * B)]
    for i in range(0, W * B, 5):   # identity buckets
        ks[i] = 0
    if W >= 3:
        ks[B:2 * B] = [0] * B      # an empty window
    S = _projective(curve, grp, tc, ks, seed=W + B)
    got = tc.to_affine_host(tc.bucket_reduce(S, W, V))
    want = [_affine(grp, tc, sum((b + 1) * ks[w * B + b] for b in range(B))) for w in range(W)]
    assert got == want


@pytest.mark.parametrize("name, group, W, c", [
    ("bn254", "g1", 4, 3), ("bn254", "g1", 1, 5), ("bn254", "g2", 3, 2),
    ("bw6_761", "g1", 3, 2),
])
def test_horner_matches_host_oracle(name, group, W, c):
    curve, grp, tc = _group(name, group)
    rng = np.random.default_rng(W * 10 + c)
    ks = [int(k) for k in rng.integers(1, 1 << 30, size=W)]
    if W > 2:
        ks[1] = 0                  # an identity window sum
    S = _projective(curve, grp, tc, ks, seed=c)
    got = tc.to_affine_host(tc.horner(S, c))
    assert got == [_affine(grp, tc, sum(k << (c * w) for w, k in enumerate(ks)))]


def test_reduce_chunks_fill_the_card():
    """V: the smallest power of two with W·V ≥ the H100's resident lanes,
    at most B (ops/msm.py)."""
    lanes = 132 * 2 * 128
    assert reduce_chunks(17, 1 << 15, lanes) == 2048            # the Chain: M = 16
    assert reduce_chunks(33, 1 << 11, lanes) == 1024            # BW6-761, c = 12: M = 2
    assert reduce_chunks(36, 1 << 10, lanes) == 1024            # c = 11: M = 1
    assert reduce_chunks(33, 1 << 7, lanes) == 1 << 7           # small MSMs: V = B


@pytest.mark.parametrize("W, B, chunk, Vs", [
    (2, 2, 2048, (1, 2)),   # the reference's double suffix scan (B ≤ chunk)
    (2, 16, 4, (1, 4)),     # its chunked running sums (B > chunk)
])
def test_bucket_reduce_matches_jax_reference(W, B, chunk, Vs):
    """BN254 G1: the JAX package's bucket reduction on the same bucket
    sums, every 5th the identity, in both of its branches: at B ≤ chunk
    (``_bucket_reduce_t``, chunk 2,048) its double suffix scan, the port at
    V = 1 (M = 2) and V = 2 (M = 1); at B > chunk the chunked running sums
    with the suffix-scan combine (``_weighted_chunked_t``, the branch the
    Chain's B = 2^15 takes with chunks of 2,048), here B = 16 in chunks of
    4, the port at V = 1 (M = 16) and V = 4 (M = 4). The reference runs on
    the transposed planes. Its add and double: in the first branch the JAX
    package's DevCurve, run eagerly (its TCurve's XLA:CPU compile takes
    minutes, and the JAX package's tests hold the two equal); in the
    chunked branch, whose five ``lax.scan`` calls take 15-35 s on a CPU
    with that DevCurve, eager or compiled, the port's plain add and double
    on the same Montgomery words (R = 2^256 in both), which
    tests/test_torch_ec.py holds to that DevCurve limb for limb. The
    bucket sums are k_b·G with k_b = k_0 + b·d, made by host additions."""
    import jax
    import jax.numpy as jnp

    from gnark_icicle_tpu.ops.ec import DevCurve, DevField
    from gnark_icicle_tpu.ops.field import field_for as ref_field_for
    from gnark_icicle_tpu.ops.msm import MSMKernel

    curve, grp, tc = _group("bn254", "g1")
    p, r = curve.fp.modulus, grp.order
    ks, pts = [], []
    step, cur = grp.scalar_mul(grp.generator, 678), grp.scalar_mul(grp.generator, 12345)
    for b in range(W * B):
        ks.append(0 if b % 5 == 1 else (12345 + 678 * b) % r)
        pts.append(None if b % 5 == 1 else cur)
        cur = grp.add(cur, step)
    S = _projective(curve, grp, tc, ks, seed=5, pts=pts)

    F = ref_field_for(p)
    dev = DevCurve(DevField(F), 3 * grp.b % p)

    def tr(P):
        return tuple(a.T for a in P)

    def to_port(P):
        """(K, n) 16-bit limbs of each coordinate -> (3, K/2, n) words"""
        a = np.stack([np.asarray(x) for x in P]).astype(np.int64)
        return torch.from_numpy((a[:, 0::2] | a[:, 1::2] << 16).astype(np.uint32).view(np.int32))

    def from_port(T):
        a = T.contiguous().numpy().view(np.uint32).astype(np.int64)
        limbs = np.empty((a.shape[0], 2 * a.shape[1], a.shape[2]), np.int32)
        limbs[:, 0::2], limbs[:, 1::2] = a & 0xFFFF, a >> 16
        return tuple(jnp.asarray(x) for x in limbs)

    class TransposedPlanes:
        """The group law on the reference's transposed (K, n) planes."""

        def add(self, P, Q):
            if B <= chunk:
                return tr(dev.add(tr(P), tr(Q)))
            return from_port(tc._padd(to_port(P), to_port(Q)))

        def double(self, P):
            if B <= chunk:
                return tr(dev.double(tr(P)))
            return from_port(tc._pdouble(to_port(P)))

        def neg_point(self, P):
            return tr(dev.neg(tr(P)))

        def identity(self, n):
            return tr(dev.identity_like(jnp.asarray(F.encode([0] * n))))

    R = 1 << (32 * tc.W)
    rinv = pow(R, -1, p)
    coords = [[sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(col)) * rinv % p
               for col in S[k].T.tolist()] for k in range(3)]
    buckets_t = tuple(jnp.asarray(F.encode(vals)).T for vals in coords)
    kern = MSMKernel(dev, p.bit_length())
    with jax.disable_jit():
        if B <= chunk:
            ref = kern._bucket_reduce_t(TransposedPlanes(), buckets_t, W, B)
        else:   # _bucket_reduce_t's own steps, with the smaller chunk
            grid = tuple(a.reshape(a.shape[0], W, B) for a in buckets_t)
            ref = tuple(a.T for a in kern._weighted_chunked_t(TransposedPlanes(), grid, B,
                                                               chunk=chunk))
    want = dev.to_affine_host(ref, p)
    assert want == [_affine(grp, tc, sum((b + 1) * ks[w * B + b] for b in range(B)))
                    for w in range(W)]
    for V in Vs:
        assert tc.to_affine_host(tc.bucket_reduce(S, W, V)) == want
