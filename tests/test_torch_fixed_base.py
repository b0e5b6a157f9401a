"""Setup's fixed-base product (gnark_icicle_tpu_torch/ops/fixed_base.py) and
the batch normalization (ops/ec_t.py normalize) against the JAX package.

The normalization's plain version against gnark_icicle_tpu's
``batch_normalize`` limb for limb (the port's plain words taken to
Montgomery form), infinity mask included; the comb against the JAX
``FixedBaseMul.mul`` + ``batch_normalize`` for BN254 G1, and against the
JAX package's host ``scalar_mul`` for the other curves and groups (XLA:CPU
compiles of their larger EC graphs run for hours); the comb table's rows
against the host's d·2^(w·j)·G, and its cache. Scalars come from numpy
seeds, led by 0, 1, r − 1, powers of two and all-ones windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_icicle_tpu.ops.ec import DevCurve as RefCurve, DevField as RefField
from gnark_icicle_tpu.ops.ec import DevField2 as RefField2
from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu.ops.fixed_base import FixedBaseMul as RefFixedBaseMul
from gnark_icicle_tpu.ops.fixed_base import batch_normalize
from gnark_icicle_tpu_torch.ops import fixed_base
from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2
from gnark_icicle_tpu_torch.ops.field import field_for, ints_to_limbs32, to_lanes

from test_torch_common import (
    CURVES, edge_scalars, g2_over_fp2, lanes_to_ref, rand_ints, ref_curve,
)


def _tc(name, group):
    """The port's group law of a curve's group (BW6-761's G2: over Fp)."""
    curve = CURVES[name]
    p = curve.fp.modulus
    F = field_for(p)
    G = curve.g1 if group == "g1" else curve.g2
    if group == "g2" and g2_over_fp2(curve):
        return TCurve2(F, curve.tower.beta, G.b * 3), G
    return TCurve(F, 3 * G.b % p), G


def _host(tc, pt):
    """A host point in affine_host's form (Fp2 coordinates as int pairs)."""
    if pt is None or tc.NP == 1:
        return pt
    return ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))


def _ref_coords(tc, P):
    """(planes, W, n) port planes -> the JAX DevCurve's (X, Y, Z) limbs."""
    planes = [jnp.asarray(lanes_to_ref(P[i])) for i in range(P.shape[0])]
    if tc.NP == 1:
        return tuple(planes)
    return tuple((planes[2 * i], planes[2 * i + 1]) for i in range(3))


def _to_mont(tc, xy):
    """normalize's plain words -> Montgomery words, plane by plane."""
    return torch.stack([tc.F.to_mont(c) for c in xy])


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_normalize_matches_batch_normalize(name, group):
    """normalize_plain at 2^6 lanes (Z = 0 on four, (0, z1) on one for Fp2,
    random projective scalings of curve points elsewhere) against the JAX
    batch_normalize (β = −1 on both curves, as its norm z0² + z1² takes),
    and the host points."""
    tc, G = _tc(name, group)
    p = tc.F.modulus
    n = 64
    ks = rand_ints(51, CURVES[name].fr.modulus, n, edge=False)
    zs = rand_ints(52, p, 2 * n, edge=False)
    pts = [G.scalar_mul(G.generator, k) for k in ks]
    zero = {0, 17, 40, n - 1}
    planes = [[] for _ in range(tc.planes)]
    for i, pt in enumerate(pts):
        if tc.NP == 1:
            z = 0 if i in zero else zs[i]
            coords = [pt[0] * z % p, pt[1] * z % p, z]
        else:
            z = type(pt[0])(CURVES[name].tower, *((0, 0) if i in zero else
                                                  (0 if i == 5 else zs[i], zs[n + i])))
            coords = [c for v in (pt[0] * z, pt[1] * z, z) for c in (v.c0, v.c1)]
        if i in zero:       # the identity (0 : 1 : 0)
            coords = [0] * tc.NP + [1] + [0] * (2 * tc.NP - 1)
        for k, c in enumerate(coords):
            planes[k].append(c)
    P = torch.stack([tc.F.encode(v, "cpu") for v in planes])
    xy, inf = tc.normalize_plain(P)

    F = ref_field_for(p)
    fops = RefField(F) if tc.NP == 1 else RefField2(F, CURVES[name].tower.beta)
    ref = RefCurve(fops, 0)
    (rx, ry), rinf = batch_normalize(ref, _ref_coords(tc, P))
    assert np.asarray(rinf).tolist() == inf.bool().tolist() == [i in zero for i in range(n)]
    want = [rx, ry] if tc.NP == 1 else [rx[0], rx[1], ry[0], ry[1]]
    got = _to_mont(tc, xy)
    for k, w in enumerate(want):
        np.testing.assert_array_equal(lanes_to_ref(got[k]), np.asarray(w))
    assert tc.affine_host(xy, inf) == [None if i in zero else _host(tc, pt)
                                       for i, pt in enumerate(pts)]


def test_fixed_base_matches_jax_bn254_g1():
    """The port's comb (FixedBaseMul on the CPU) + normalize against the JAX
    FixedBaseMul.mul + batch_normalize at 2^8 lanes: the same affine limbs
    and infinity lanes."""
    curve, ref = CURVES["bn254"], ref_curve("bn254")
    r, p = curve.fr.modulus, curve.fp.modulus
    bits = r.bit_length()
    scalars = edge_scalars(r, 256, 53)
    tc, G = _tc("bn254", "g1")
    fb = fixed_base.FixedBaseMul(tc, G, G.generator, bits, "cpu")
    xy, inf = tc.normalize(fb.mul(to_lanes(ints_to_limbs32(scalars, 8), "cpu")))

    dev = RefCurve(RefField(ref_field_for(p)), 3 * ref.g1.b % p)
    proj = RefFixedBaseMul(dev, ref.g1, ref.g1.generator, bits).mul(
        ref_field_for(r).encode_plain(scalars))
    (rx, ry), rinf = batch_normalize(dev, proj)
    assert np.asarray(rinf).tolist() == inf.bool().tolist()
    assert inf.tolist() == [int(s == 0) for s in scalars]
    got = _to_mont(tc, xy)
    np.testing.assert_array_equal(lanes_to_ref(got[0]), np.asarray(rx))
    np.testing.assert_array_equal(lanes_to_ref(got[1]), np.asarray(ry))


CASES = [("bn254", "g2"), ("bls12_381", "g1"), ("bls12_381", "g2"), ("bls12_377", "g1"),
         ("bls12_377", "g2"), ("bw6_761", "g1"), ("bw6_761", "g2")]


@pytest.mark.parametrize("name,group", CASES)
def test_batch_scalar_mul_matches_host(name, group):
    """batch_scalar_mul_host on the CPU (the comb at WINDOW, normalize, the
    host decode) against the JAX package's host scalar_mul, 24 edge and
    random scalars (digits across words at w = 5: test_torch_field_cuh.py
    and, on the card, test_torch_cuda.py)."""
    tc, G = _tc(name, group)
    r = CURVES[name].fr.modulus
    bits = r.bit_length()
    scalars = edge_scalars(r, 24, 54)
    RG = getattr(ref_curve(name), group)
    want = [_host(tc, RG.scalar_mul(RG.generator, s)) for s in scalars]
    times = {}
    got = fixed_base.batch_scalar_mul_host(tc, G, G.generator, scalars, bits, "cpu",
                                           times=times)
    assert got == want
    assert set(times) == {"table", "encode", "comb", "normalize", "decode"}


def test_comb_table_rows_and_cache():
    """Row j·(2^w − 1) + d − 1 is d·2^(w·j)·G (first, middle and top window,
    d = 1, 2 and 2^w − 1), and a second FixedBaseMul builds no table."""
    name = "bls12_377"
    tc, G = _tc(name, "g2")
    bits = CURVES[name].fr.modulus.bit_length()
    w = 5
    fb = fixed_base.FixedBaseMul(tc, G, G.generator, bits, "cpu", w=w)
    J = -(-bits // w)
    assert fb.table.shape == (J * ((1 << w) - 1), tc.row)
    p, R = tc.F.modulus, tc.F.R
    rinv = pow(R, -1, p)
    for j in (0, J // 2, J - 1):
        for d in (1, 2, (1 << w) - 1):
            row = fb.table[j * ((1 << w) - 1) + d - 1].reshape(-1, tc.W)
            v = [sum((int(x) & 0xFFFFFFFF) << (32 * i) for i, x in enumerate(c.tolist()))
                 * rinv % p for c in row]
            assert ((v[0], v[1]), (v[2], v[3])) == _host(tc, G.scalar_mul(G.generator,
                                                                         d << (w * j)))
    built = len(fixed_base._TABLES)
    again = fixed_base.FixedBaseMul(_tc(name, "g2")[0], G, G.generator, bits, "cpu", w=w)
    assert again.table is fb.table and len(fixed_base._TABLES) == built
