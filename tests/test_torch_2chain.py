"""The port's modules at the widths of the 2-chain, on the CPU: BLS12-377
(Fp at 12 words with u² = −5, Fr at 8) and BW6-761 (Fp at 24 words, Fr at
12, G2 over Fp).

Field and NTT against the JAX package's LimbField and Domain (bit-identical
16-bit limbs); the group law and the MSM against the host curves (affine
points), since XLA:CPU compiles of the reference's EC graphs at these widths
take hours. The plain versions run here; tests/test_torch_cuda.py holds the
kernels to them on the card. Tolerance zero throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_icicle_tpu.backend.groth16.host_compute import msm_host as host_msm
from gnark_icicle_tpu.ops.ec import DevCurve as RefCurve, DevField as RefField
from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu.ops.msm import MSMKernel as RefMSM
from gnark_icicle_tpu.ops.msm import scalars_to_limbs
from gnark_icicle_tpu.ops.ntt import domain_for as ref_domain_for
from gnark_icicle_tpu_torch.device import DeviceCtx
from gnark_icicle_tpu_torch.ops import field as pf
from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2
from gnark_icicle_tpu_torch.ops.msm import MSMKernel, msm_host
from gnark_icicle_tpu_torch.ops.ntt import domain_for

from test_torch_common import (
    CURVES, g2_over_fp2, lanes_to_ref, rand_ints, ref_curve, ref_to_lanes,
)

NAMES = ["bls12_377", "bw6_761"]
FIELDS = [(c, f) for c in NAMES for f in ("fr", "fp")]
N = 32


def _modulus(curve, name):
    c = CURVES[curve]
    return (c.fr if name == "fr" else c.fp).modulus


def test_words_per_field():
    assert [pf.words_for(_modulus(c, f)) for c, f in FIELDS] == [8, 12, 12, 24]
    # the 2-chain: BW6-761's scalar field is BLS12-377's base field
    assert _modulus("bw6_761", "fr") == _modulus("bls12_377", "fp")


@pytest.mark.parametrize("curve, name", FIELDS)
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_field_op_matches_limbfield(curve, name, op):
    q = _modulus(curve, name)
    ref = ref_field_for(q)
    xs = rand_ints(20, q, N)
    ys = rand_ints(21, q, N, edge=False)
    ys[:3] = [q - 1, 0, q - 2]
    a, b = ref.encode(xs), ref.encode(ys)
    want = np.asarray(getattr(ref, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(pf.field_for(q), op)(ref_to_lanes(a), ref_to_lanes(b))
    np.testing.assert_array_equal(lanes_to_ref(got), want)


@pytest.mark.parametrize("curve, name", FIELDS)
def test_products_near_the_top_of_the_field(curve, name):
    """p − 1, p − 2 and (R − 1) mod p against Python ints (the CIOS top word)."""
    q = _modulus(curve, name)
    F = pf.field_for(q)
    vals = [0, 1, q - 1, q - 2, (F.R - 1) % q, F.R % q, q // 2 + 1]
    a = F.encode([x for x in vals for _ in vals], "cpu")
    b = F.encode([y for _ in vals for y in vals], "cpu")
    pairs = [(x, y) for x in vals for y in vals]
    assert F.decode(F.mont_mul(a, b)) == [x * y % q for x, y in pairs]
    assert F.decode(F.sub(a, b)) == [(x - y) % q for x, y in pairs]


def test_ntt_transforms_match_reference():
    """The three computeH transforms, ntt and intt over BW6-761's 12-word Fr
    at log_n = 5 (BLS12-377's 8-word Fr goes through them in
    tests/test_torch_groth16.py's computeH check)."""
    curve = "bw6_761"
    q = CURVES[curve].fr.modulus
    ref = ref_domain_for(ref_field_for(q), ref_curve(curve).fr, 5, coset=True)
    port = domain_for(pf.field_for(q), CURVES[curve].fr, 5, "cpu", coset=True)
    for i, name in enumerate(["intt_nat_to_rev", "coset_ntt_rev_in",
                              "coset_intt_nat_to_rev", "ntt", "intt"]):
        x = ref_field_for(q).encode(rand_ints(70 + i, q, port.n))
        want = np.asarray(getattr(ref, name)(jnp.array(x)))
        np.testing.assert_array_equal(lanes_to_ref(getattr(port, name)(ref_to_lanes(x))),
                                      want, err_msg=name)


def _group(curve, group):
    """The DeviceCtx group of a curve on the CPU: BW6-761's G2 is a TCurve."""
    ctx = DeviceCtx(CURVES[curve], "cpu")
    return getattr(ctx, group), getattr(CURVES[curve], group)


def _host(tc, pt):
    """A host affine point in to_affine_host's form (Fp2 as int pairs)."""
    if pt is None or not isinstance(tc, TCurve2):
        return pt
    return ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))


@pytest.mark.parametrize("curve", NAMES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_group_law_matches_host(curve, group):
    """Mixed add (signed, masked), add and double against the host group."""
    tc, grp = _group(curve, group)
    assert isinstance(tc, TCurve2) == (group == "g2" and g2_over_fp2(CURVES[curve]))
    ks = rand_ints(140, grp.order, 6, edge=False)
    pts = [grp.scalar_mul(grp.generator, k) for k in ks]
    pts[1] = pts[0]            # doubling through the add
    pts[2] = grp.neg(pts[0])   # P + (−P)
    n = len(pts)
    table = tc.table(pts, "cpu")
    acc = tc.identity(n, "cpu")
    idx = torch.arange(n, dtype=torch.int32)
    tc.add_mixed_masked(acc, n, table, idx)             # acc = pts
    assert tc.to_affine_host(acc) == [_host(tc, p) for p in pts]
    rev = acc.flip(-1).contiguous()
    sums = [grp.add(a, b) for a, b in zip(pts, pts[::-1])]
    assert tc.to_affine_host(tc.add(acc, rev)) == [_host(tc, s) for s in sums]
    assert tc.to_affine_host(tc.double(acc)) == [_host(tc, grp.add(p, p)) for p in pts]
    sign = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.int32)
    mask = torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.int32)
    tc.add_mixed_masked(acc, n, table, idx.flip(0).contiguous(), sign, mask)
    want = [grp.add(p, grp.neg(q) if s else q) if m else p
            for p, q, s, m in zip(pts, pts[::-1], sign.tolist(), mask.tolist())]
    assert tc.to_affine_host(acc) == [_host(tc, w) for w in want]


@pytest.mark.parametrize("c", [11, 16])
def test_signed_digits_read_all_scalar_words(c):
    """BW6-761's 377-bit scalars in 12 words: the reference's digits, and a
    top window that takes the last word's bits and the final carry."""
    p, r = CURVES["bw6_761"].fp.modulus, CURVES["bw6_761"].fr.modulus
    scal = rand_ints(230 + c, r, 64)
    ref = RefMSM(RefCurve(RefField(ref_field_for(p)), 12), r.bit_length())
    want = np.asarray(ref._signed_digits(jnp.asarray(scalars_to_limbs(scal, 24)), c))
    port = MSMKernel(TCurve(pf.field_for(p), 12), r.bit_length())
    got = port._signed_digits(pf.to_lanes(pf.ints_to_limbs32(scal, 12), "cpu"), c)
    assert got.shape[0] == -(-377 // c) + 1
    np.testing.assert_array_equal(got.numpy(), want)
    # the digits recompose to the scalars
    for i in (0, 2, 5, 63):
        assert sum(int(d) << (c * w) for w, d in enumerate(got[:, i])) == scal[i]


@pytest.mark.parametrize("curve, group, n", [("bls12_377", "g1", 48), ("bls12_377", "g2", 16),
                                             ("bw6_761", "g1", 16), ("bw6_761", "g2", 16)])
def test_msm_matches_host(curve, group, n):
    """The JAX package's host MSM over its own points is the oracle; every
    7th point is at infinity, the scalars lead with 0, 1 and r − 1."""
    tc, _ = _group(curve, group)
    ref_grp = getattr(ref_curve(curve), group)
    k0, dk = rand_ints(600 + n, ref_grp.order, 2, edge=False)
    cur, step = ref_grp.scalar_mul(ref_grp.generator, k0), ref_grp.scalar_mul(ref_grp.generator, dk)
    pts = []
    for i in range(n):
        pts.append(None if i % 7 == 3 else cur)
        cur = ref_grp.add(cur, step)
    scal = rand_ints(610 + n, CURVES[curve].fr.modulus, n)
    want = host_msm(ref_grp, pts, scal)
    assert msm_host(tc, CURVES[curve].fr, pts, scal, "cpu") == _host(tc, want)


def test_skewed_msm_splits_and_matches_host():
    """BW6-761 G1 at 32 points, scalars mostly 0 and 1 with a few random:
    runs split into segments of 4 points and folded (the 2-chain's
    bit-valued wires do this at scale), against the JAX package's host MSM."""
    tc, _ = _group("bw6_761", "g1")
    ref_grp = ref_curve("bw6_761").g1
    r = CURVES["bw6_761"].fr.modulus
    pts = [ref_grp.scalar_mul(ref_grp.generator, k) for k in rand_ints(620, r, 32, edge=False)]
    pts[5] = None
    scal = [v if i % 8 == 0 else i % 3 % 2 for i, v in enumerate(rand_ints(621, r, 32))]
    kern = MSMKernel(tc, r.bit_length())
    table = tc.table([p or ref_grp.generator for p in pts], "cpu")
    inf = torch.tensor([p is None for p in pts])
    scalars = pf.to_lanes(pf.ints_to_limbs32(scal, 12), "cpu")
    got = tc.to_affine_host(kern._msm(table, inf, scalars, 3, 4))[0]
    assert got == host_msm(ref_grp, pts, scal)


def test_g2_kernels_take_both_betas():
    """TCurve2 takes u² = −1 and u² = −5 and refuses any other β."""
    F = pf.field_for(CURVES["bls12_377"].fp.modulus)
    assert TCurve2(F, -5, (0, 1)).curve.f.beta == -5
    with pytest.raises(NotImplementedError):
        TCurve2(F, -2, (0, 1))
