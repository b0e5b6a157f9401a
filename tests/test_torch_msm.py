"""Port MSM (gnark_icicle_tpu_torch/ops/msm.py) against the host MSM of the
JAX package (backend/groth16/host_compute.msm_host), in affine form, for G1
and G2 at N ∈ {1, 100, 300} for BN254, and at 64 G1 and 16 G2 points for
BLS12-381 (Fp at 12 words, 255-bit scalars), with infinity points, zero
scalars and r − 1 (``rand_ints`` leads every scalar list with 0, 1 and
r − 1). Also the signed digits and the window choice against ops/msm.py;
the bucket accumulation against the reference's wave schedule (projective
limbs); split and folded runs against unsplit ones; and a skewed MSM whose
digit-1 run is split.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_icicle_tpu.backend.groth16.host_compute import msm_host as host_msm
from gnark_icicle_tpu.ops.ec import DevCurve as RefCurve, DevField as RefField
from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu.ops.msm import MSMKernel as RefMSM
from gnark_icicle_tpu.ops.msm import pick_window as ref_pick_window
from gnark_icicle_tpu.ops.msm import scalars_to_limbs
from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2, resident_lanes
from gnark_icicle_tpu_torch.ops.field import field_for, ints_to_limbs32, to_lanes
from gnark_icicle_tpu_torch.ops.msm import MSMKernel, msm_host, pick_window, segment_length

from test_torch_common import CURVE, CURVES, P, R, lanes_to_ref, rand_ints, ref_curve

G1, G2 = CURVE.g1, CURVE.g2


def _points(group, seed, n):
    """n distinct host points by repeated addition of a random step, with
    every 7th one at infinity."""
    k0, dk = rand_ints(seed, group.order, 2, edge=False)
    cur = group.scalar_mul(group.generator, k0)
    step = group.scalar_mul(group.generator, dk)
    out = []
    for i in range(n):
        out.append(None if i % 7 == 3 else cur)
        cur = group.add(cur, step)
    return out


def _pair(p):
    return None if p is None else ((p[0].c0, p[0].c1), (p[1].c0, p[1].c1))


def test_pick_window_matches_reference():
    for n in (1, 2, 3, 100, 300, 4096, 1 << 16, (1 << 17) - 1, 1 << 17, 1 << 18):
        assert pick_window(n) == ref_pick_window(n)


@pytest.mark.parametrize("c", [4, 8, 13, 16])
def test_signed_digits_match_reference(c):
    scal = rand_ints(200 + c, R, 64)
    ref = RefMSM(RefCurve(RefField(ref_field_for(P)), 9), R.bit_length())
    want = np.asarray(ref._signed_digits(jnp.asarray(scalars_to_limbs(scal, 16)), c))
    port = MSMKernel(TCurve(field_for(P), 9), R.bit_length())
    got = port._signed_digits(to_lanes(ints_to_limbs32(scal, 8), "cpu"), c)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [4, 13, 16])
def test_signed_digits_match_reference_bls12_381(c):
    """255-bit scalars: the top window takes bit 254 and the last carry."""
    bls = CURVES["bls12_381"]
    r, p = bls.fr.modulus, bls.fp.modulus
    scal = rand_ints(230 + c, r, 64)
    ref = RefMSM(RefCurve(RefField(ref_field_for(p)), 12), r.bit_length())
    want = np.asarray(ref._signed_digits(jnp.asarray(scalars_to_limbs(scal, 16)), c))
    port = MSMKernel(TCurve(field_for(p), 12), r.bit_length())
    got = port._signed_digits(to_lanes(ints_to_limbs32(scal, 8), "cpu"), c)
    assert got.shape[0] == -(-255 // c) + 1
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 100, 300])
def test_g1_msm_matches_host(n):
    pts, scal = _points(G1, 300 + n, n), rand_ints(310 + n, R, n)
    tc = TCurve(field_for(P), 3 * G1.b % P)
    got = msm_host(tc, CURVE.fr, pts, scal, "cpu")
    assert got == host_msm(G1, pts, scal)


@pytest.mark.parametrize("n", [1, 100, 300])
def test_g2_msm_matches_host(n):
    pts, scal = _points(G2, 400 + n, n), rand_ints(410 + n, R, n)
    tc = TCurve2(field_for(P), CURVE.tower.beta, G2.b * 3)
    got = msm_host(tc, CURVE.fr, pts, scal, "cpu")
    assert got == _pair(host_msm(G2, pts, scal))


def test_msm_window_does_not_change_the_point():
    """Any window gives the same affine point (here c = 3 and c = 9)."""
    pts, scal = _points(G1, 500, 40), rand_ints(510, R, 40)
    tc = TCurve(field_for(P), 3 * G1.b % P)
    want = host_msm(G1, pts, scal)
    for c in (3, 9):
        assert msm_host(tc, CURVE.fr, pts, scal, "cpu", c=c) == want


@pytest.mark.parametrize("group, n", [("g1", 64), ("g2", 16)])
def test_msm_matches_host_bls12_381(group, n):
    """The JAX package's host MSM over its own BLS12-381 points is the
    oracle; the port gets the same points and scalars."""
    bls, ref = CURVES["bls12_381"], ref_curve("bls12_381")
    p = bls.fp.modulus
    ref_grp = getattr(ref, group)
    pts = _points(ref_grp, 600 + n, n)
    scal = rand_ints(610 + n, bls.fr.modulus, n)
    tc = (TCurve(field_for(p), 3 * bls.g1.b % p) if group == "g1"
          else TCurve2(field_for(p), bls.tower.beta, bls.g2.b * 3))
    want = host_msm(ref_grp, pts, scal)
    got = msm_host(tc, bls.fr, pts, scal, "cpu")
    assert got == (want if group == "g1" else _pair(want))


def _runs(seed, L, M, top):
    """L random runs (lengths up to top, sorted descending, one of each
    length top, top − 1 and 0) over M table rows: (order, sign, start,
    count) as bucket_accumulate takes them."""
    rng = np.random.default_rng(seed)
    count = np.sort(rng.integers(0, top, size=L))[::-1].copy()
    count[:3] = [top, top - 1, 0]
    count = np.sort(count)[::-1].copy()
    start = np.cumsum(count) - count
    n = int(count.sum())
    return (torch.from_numpy(rng.integers(0, M, size=n).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 2, size=n).astype(np.int32)),
            torch.from_numpy(start.astype(np.int64)),
            torch.from_numpy(count.astype(np.int32)))


def test_bucket_accumulate_matches_reference_waves():
    """Each lane's run added in order is the reference's wave schedule
    (ops/msm.py:187: wave t adds point start + t, signed, where t < count)
    run here with the JAX package's DevCurve: equal projective limbs."""
    pts = _points(G1, 700, 24)
    pts = [p if p is not None else G1.generator for p in pts]
    order, sign, start, count = _runs(701, 12, len(pts), 5)
    tc = TCurve(field_for(P), 3 * G1.b % P)
    got = tc.identity(12, "cpu")
    tc.bucket_accumulate(got, tc.table(pts, "cpu"), order, sign, start, count)

    ref = RefCurve(RefField(ref_field_for(P)), 3 * G1.b % P)
    F = ref_field_for(P)
    acc = (jnp.asarray(F.encode([0] * 12)), jnp.asarray(F.encode([1] * 12)),
           jnp.asarray(F.encode([0] * 12)))
    for t in range(int(count.max())):
        pos = np.minimum(start.numpy() + t, len(order) - 1)
        idx = order.numpy()[pos]
        qx = jnp.asarray(F.encode([pts[i][0] for i in idx]))
        qy = jnp.asarray(F.encode([pts[i][1] for i in idx]))
        gy = ref.f.select(jnp.asarray(sign.numpy()[pos] != 0), ref.f.neg(qy), qy)
        acc = ref.select(jnp.asarray(count.numpy() > t), ref.add_mixed(acc, (qx, gy)), acc)
    for i in range(3):
        np.testing.assert_array_equal(lanes_to_ref(got[i]), np.asarray(acc[i]))


def test_split_runs_fold_to_the_unsplit_sums():
    """Runs cut into segments of 4 points and folded give the unsplit
    runs' points (affine); with segments no shorter than the longest run
    nothing is split and the limbs are the unsplit ones."""
    pts = _points(G1, 710, 40)
    pts = [p if p is not None else G1.generator for p in pts]
    order, sign, starts, counts = _runs(711, 10, len(pts), 13)
    tc = TCurve(field_for(P), 3 * G1.b % P)
    kern = MSMKernel(tc, R.bit_length())
    table = tc.table(pts, "cpu")
    whole = tc.identity(10, "cpu")
    tc.bucket_accumulate(whole, table, order, sign, starts, counts)
    split = kern._accumulate(table, order, sign, starts, counts.long(), 4)
    assert kern._segments(starts, counts.long(), 4)[3].max() == 4
    assert tc.to_affine_host(split) == tc.to_affine_host(whole)
    assert torch.equal(kern._accumulate(table, order, sign, starts, counts.long(), 13), whole)


def test_skewed_msm_splits_and_matches_host():
    """112 points, scalars 1 but for every 8th (r − 1) and every 8th + 3
    (0): window 0's digit-1 run holds more points than a lane takes
    (segment_length), so the MSM splits and folds it."""
    n = 112
    pts = _points(G1, 720, n)
    scal = [(R - 1) if i % 8 == 0 else 0 if i % 8 == 3 else 1 for i in range(n)]
    ones = sum(1 for s, p in zip(scal, pts) if s == 1 and p is not None)
    assert ones > segment_length(n, pick_window(n), R.bit_length(), resident_lanes("cpu"))
    tc = TCurve(field_for(P), 3 * G1.b % P)
    assert msm_host(tc, CURVE.fr, pts, scal, "cpu") == host_msm(G1, pts, scal)


@pytest.mark.parametrize("name, n", [("bls12_377", (1 << 17) + 2), ("bls12_377", 1 << 18),
                                     ("bw6_761", 35856)])
def test_segment_length_splits_only_skewed_runs(name, n):
    """Random scalars at the paths' MSM sizes: the Chain cells (BLS12-377's
    13-bit top window is its fullest) split no run, so they keep the
    reference's per-bucket order; BW6-761's 3-bit top window at c = 11 is
    split."""
    r = CURVES[name].fr.modulus
    words = -(-r.bit_length() // 32)
    rng = np.random.default_rng(730)
    limbs = rng.integers(0, 1 << 32, size=(words, n), dtype=np.uint64)
    limbs[-1] %= r >> (32 * (words - 1))                    # every scalar < r
    scalars = torch.from_numpy(limbs.astype(np.uint32).view(np.int32))
    c = pick_window(n)
    kern = MSMKernel(None, r.bit_length())
    counts = kern._runs(torch.zeros(n, dtype=torch.bool), scalars, c)[3]
    seg = segment_length(n, c, r.bit_length(), resident_lanes("cpu"))
    assert (int(counts.max()) > seg) == (name == "bw6_761")


@pytest.mark.parametrize("n, c, name, seg", [((1 << 17) + 2, 16, "bls12_377", 128),
                                             (1 << 18, 16, "bn254", 256),
                                             (35856, 11, "bw6_761", 64),
                                             (65536, 12, "bw6_761", 64)])
def test_segment_length_at_the_h100_resident_lanes(n, c, name, seg):
    """The CPU counts the H100's lanes (132 SMs × 2 blocks × 128 threads of
    the bucket accumulation), so it cuts the paths' MSMs as the card does."""
    assert resident_lanes("cpu") == 132 * 2 * 128
    r = CURVES[name].fr.modulus
    assert segment_length(n, c, r.bit_length(), resident_lanes("cpu")) == seg


@pytest.mark.parametrize("name", sorted(CURVES))
def test_mixed_add_group_flag(name):
    """Each curve's G1 and G2 b3 name their group for the mixed-add entries
    (0, 1), which use that group's b3 form; any other b3 has no kernel."""
    curve = CURVES[name]
    p = curve.fp.modulus
    F = field_for(p)
    g1 = TCurve(F, 3 * curve.g1.b % p)
    g2 = (TCurve2(F, curve.tower.beta, curve.g2.b * 3) if hasattr(curve.g2.b, "c0")
          else TCurve(F, 3 * curve.g2.b % p))
    assert (g1.group_flag, g2.group_flag) == (0, 1)
    other = TCurve(F, 5)
    assert other.group_flag is None
    with pytest.raises(NotImplementedError):
        other._kernel(0)
