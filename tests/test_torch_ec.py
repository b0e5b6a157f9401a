"""Port group law (gnark_icicle_tpu_torch/ops/ec.py, ec_t.py).

G1 against the JAX package's DevCurve (gnark_icicle_tpu/ops/ec.py) in
projective limbs at n = 8; the masked, signed mixed add against the
reference's own wave step composed of DevCurve ops (ops/msm.py:658-662).
G2 against the curves/ host oracle in affine form. Tolerance zero. Each test
takes the curve as an argument that defaults to BN254; its ``_bls12_381``
twin runs it for BLS12-381 (Fp at 12 words, b3 = 12 and 12(1 + u)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_icicle_tpu.ops.ec import DevCurve as RefCurve, DevField as RefField
from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2
from gnark_icicle_tpu_torch.ops.field import field_for, to16

from test_torch_common import (
    CURVES, lanes_to_ref, rand_ints, ref_to_lanes,
)

N = 8
BLS = "bls12_381"


def _g1_points(seed, n, curve="bn254"):
    """n host G1 points: a multiple of G, its double, its negation, more."""
    G1 = CURVES[curve].g1
    ks = rand_ints(seed, CURVES[curve].fr.modulus, n, edge=False)
    pts = [G1.scalar_mul(G1.generator, k) for k in ks]
    pts[1] = pts[0]
    pts[2] = G1.neg(pts[0])
    return pts


def _g1_proj(pts, seed):
    """Host affine points -> reference (X, Y, Z) limb arrays with random Z;
    lane 3 is the identity (0 : 1 : 0)."""
    P = _curve_of(pts).fp.modulus
    zs = rand_ints(seed, P, len(pts), edge=False)
    X, Y, Z = [], [], []
    for i, (p, z) in enumerate(zip(pts, zs)):
        if i == 3:
            X.append(0), Y.append(1), Z.append(0)
            continue
        X.append(p[0] * z % P), Y.append(p[1] * z % P), Z.append(z)
    F = ref_field_for(P)
    return tuple(F.encode(c) for c in (X, Y, Z))


def _curve_of(pts):
    """The curve whose G1 holds these points."""
    return next(c for c in CURVES.values() if c.g1.is_on_curve(pts[0]))


def _to16(c):
    """Reference (N, 16) limbs -> the plain group law's (16, N) int64."""
    return to16(ref_to_lanes(c))


def _to_port(coords):
    return torch.stack([ref_to_lanes(c) for c in coords])


def _assert_same(port_pt, ref_pt):
    for i in range(3):
        np.testing.assert_array_equal(lanes_to_ref(port_pt[i]),
                                      np.asarray(ref_pt[i]))


def _g1(curve):
    c = CURVES[curve]
    P = c.fp.modulus
    ref = RefCurve(RefField(ref_field_for(P)), 3 * c.g1.b % P)
    port = TCurve(field_for(P), 3 * c.g1.b % P)
    return ref, port, curve


@pytest.fixture(scope="module")
def g1():
    return _g1("bn254")


@pytest.fixture(scope="module")
def g1_bls12_381():
    return _g1(BLS)


def test_g1_add_matches_devcurve(g1):
    ref, port = g1[:2]
    pts = _g1_points(100, N, g1[2])
    A, B = _g1_proj(pts, 101), _g1_proj(pts[::-1], 102)
    want = ref.add(tuple(map(jnp.asarray, A)), tuple(map(jnp.asarray, B)))
    _assert_same(port.add(_to_port(A), _to_port(B)), want)


def test_g1_add_matches_devcurve_bls12_381(g1_bls12_381):
    test_g1_add_matches_devcurve(g1_bls12_381)


def test_g1_double_matches_devcurve(g1):
    ref, port = g1[:2]
    A = _g1_proj(_g1_points(110, N, g1[2]), 111)
    want = ref.double(tuple(map(jnp.asarray, A)))
    _assert_same(port.double(_to_port(A)), want)


def test_g1_double_matches_devcurve_bls12_381(g1_bls12_381):
    test_g1_double_matches_devcurve(g1_bls12_381)


def test_g1_add_mixed_masked_matches_reference_wave(g1):
    ref, port = g1[:2]
    pts = _g1_points(120, N, g1[2])
    A = _g1_proj(pts, 121)
    rng = np.random.default_rng(122)
    idx = rng.integers(0, N, size=N).astype(np.int32)
    sign = rng.integers(0, 2, size=N).astype(np.int32)
    mask = rng.integers(0, 2, size=N).astype(np.int32)
    mask[:4] = 1  # doubling, inverse and identity lanes take the add
    F = ref_field_for(port.F.modulus)
    qx = F.encode([pts[i][0] for i in idx])
    qy = F.encode([pts[i][1] for i in idx])
    # the reference's wave step (ops/msm.py:658-662)
    f = ref.f
    gy = f.select(jnp.asarray(sign != 0), f.neg(jnp.asarray(qy)), jnp.asarray(qy))
    acc = tuple(map(jnp.asarray, A))
    new = ref.add_mixed(acc, (jnp.asarray(qx), gy))
    want = ref.select(jnp.asarray(mask != 0), new, acc)
    got = _to_port(A)
    port.add_mixed_masked(got, N, port.table(pts, "cpu"), torch.from_numpy(idx),
                          torch.from_numpy(sign), torch.from_numpy(mask))
    _assert_same(got, want)


def test_g1_add_mixed_masked_matches_reference_wave_bls12_381(g1_bls12_381):
    test_g1_add_mixed_masked_matches_reference_wave(g1_bls12_381)


def test_g1_from_affine_and_identity_match_devcurve(g1):
    ref, port = g1[:2]
    pts = _g1_points(125, N, g1[2])
    F = ref_field_for(port.F.modulus)
    x, y = F.encode([p[0] for p in pts]), F.encode([p[1] for p in pts])
    inf = np.arange(N) % 3 == 0
    want = ref.from_affine(jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf))
    got = port.curve.from_affine(_to16(x), _to16(y), torch.from_numpy(inf))
    _assert_same(port._stack(got), want)
    _assert_same(port.identity(N, "cpu"),
                 ref.identity_like(jnp.asarray(x)))
    A = _g1_proj(pts, 126)
    sel = np.arange(N) % 2 == 0
    _assert_same(port.select(torch.from_numpy(sel), _to_port(A),
                             port.identity(N, "cpu")),
                 ref.select(jnp.asarray(sel), tuple(map(jnp.asarray, A)),
                            ref.identity_like(jnp.asarray(x))))


def test_g1_from_affine_and_identity_match_devcurve_bls12_381(g1_bls12_381):
    test_g1_from_affine_and_identity_match_devcurve(g1_bls12_381)


def test_g1_to_affine_host(g1):
    port = g1[1]
    pts = _g1_points(130, N, g1[2])
    got = port.to_affine_host(_to_port(_g1_proj(pts, 131)))
    assert got == [None if i == 3 else p for i, p in enumerate(pts)]


def test_g1_to_affine_host_bls12_381(g1_bls12_381):
    test_g1_to_affine_host(g1_bls12_381)


# -- G2 against the host oracle ----------------------------------------------

def _g2_points(seed, n, curve="bn254"):
    G2 = CURVES[curve].g2
    ks = rand_ints(seed, CURVES[curve].fr.modulus, n, edge=False)
    pts = [G2.scalar_mul(G2.generator, k) for k in ks]
    pts[1] = pts[0]
    pts[2] = G2.neg(pts[0])
    return pts


def _pair(p):
    return None if p is None else ((p[0].c0, p[0].c1), (p[1].c0, p[1].c1))


def _g2(curve):
    c = CURVES[curve]
    port = TCurve2(field_for(c.fp.modulus), c.tower.beta, c.g2.b * 3)
    pts = _g2_points(140, N, curve)
    table = port.table(pts, "cpu")
    proj = port.identity(N, "cpu")
    port.add_mixed_masked(proj, N, table, torch.arange(N, dtype=torch.int32))
    proj[:, :, 3] = port.identity(1, "cpu")[:, :, 0]
    return port, pts, table, proj, c.g2


@pytest.fixture(scope="module")
def g2():
    return _g2("bn254")


@pytest.fixture(scope="module")
def g2_bls12_381():
    return _g2(BLS)


def test_g2_from_table_is_affine(g2):
    port, pts, _, proj, _ = g2
    want = [_pair(p) for p in pts]
    want[3] = None
    assert port.to_affine_host(proj) == want


def test_g2_from_table_is_affine_bls12_381(g2_bls12_381):
    test_g2_from_table_is_affine(g2_bls12_381)


def test_g2_add_and_double_match_host(g2):
    port, pts, _, proj, G2 = g2
    rev = proj.flip(-1).contiguous()
    host = [None if i == 3 else p for i, p in enumerate(pts)]
    sums = [G2.add(a, b) for a, b in zip(host, host[::-1])]
    assert port.to_affine_host(port.add(proj, rev)) == [_pair(s) for s in sums]
    dbl = [None if p is None else G2.add(p, p) for p in host]
    assert port.to_affine_host(port.double(proj)) == [_pair(s) for s in dbl]


def test_g2_add_and_double_match_host_bls12_381(g2_bls12_381):
    test_g2_add_and_double_match_host(g2_bls12_381)


def test_g2_add_mixed_masked_matches_host(g2):
    port, pts, table, proj, G2 = g2
    rng = np.random.default_rng(150)
    idx = rng.integers(0, N, size=N).astype(np.int32)
    sign = rng.integers(0, 2, size=N).astype(np.int32)
    mask = rng.integers(0, 2, size=N).astype(np.int32)
    mask[:4] = 1
    acc = proj.clone()
    port.add_mixed_masked(acc, N, table, torch.from_numpy(idx),
                          torch.from_numpy(sign), torch.from_numpy(mask))
    host = [None if i == 3 else p for i, p in enumerate(pts)]
    want = []
    for i in range(N):
        q = pts[idx[i]] if not sign[i] else G2.neg(pts[idx[i]])
        want.append(_pair(G2.add(host[i], q) if mask[i] else host[i]))
    assert port.to_affine_host(acc) == want


def test_g2_add_mixed_masked_matches_host_bls12_381(g2_bls12_381):
    test_g2_add_mixed_masked_matches_host(g2_bls12_381)


def test_kernel_shapes_follow_the_base_field(g1_bls12_381, g2_bls12_381):
    """BLS12-381 points are 12-word planes; table rows are 24 and 48 words."""
    g1, g2 = g1_bls12_381[1], g2_bls12_381[0]
    assert g1.identity(3, "cpu").shape == (3, 12, 3)
    assert g2.identity(3, "cpu").shape == (6, 12, 3)
    assert (g1.row, g2.row) == (24, 48)
    assert g2_bls12_381[2].shape == (N, 48)
