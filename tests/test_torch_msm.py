"""Port MSM (gnark_icicle_tpu_torch/ops/msm.py) against the host MSM of the
JAX package (backend/groth16/host_compute.msm_host), in affine form, for G1
and G2 at N ∈ {1, 100, 300} for BN254, and at 64 G1 and 16 G2 points for
BLS12-381 (Fp at 12 words, 255-bit scalars), with infinity points, zero
scalars and r − 1 (``rand_ints`` leads every scalar list with 0, 1 and
r − 1). Also the signed digits and the window choice against ops/msm.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gnark_icicle_tpu.backend.groth16.host_compute import msm_host as host_msm
from gnark_icicle_tpu.ops.ec import DevCurve as RefCurve, DevField as RefField
from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu.ops.msm import MSMKernel as RefMSM
from gnark_icicle_tpu.ops.msm import pick_window as ref_pick_window
from gnark_icicle_tpu.ops.msm import scalars_to_limbs
from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2
from gnark_icicle_tpu_torch.ops.field import field_for, ints_to_limbs32, to_lanes
from gnark_icicle_tpu_torch.ops.msm import MSMKernel, msm_host, pick_window

from test_torch_common import CURVE, CURVES, P, R, rand_ints, ref_curve

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
