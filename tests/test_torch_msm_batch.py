"""The port's ``MSMKernel.msm_batch`` (M equal-size MSMs as one launch set:
one bucket accumulation over the M·W global windows, one reduction, one
Horner of M warps) and the batched KZG commits, on the CPU, where every
kernel wrapper runs its plain version.

msm_batch is held to M separate port ``msm`` calls and to the JAX package's
host MSM (``backend/groth16/host_compute.py`` ``msm_host``), in affine form,
for G1 on the four curves and G2 on BN254 and BLS12-381, with a table shared
by the problems and one a problem. The scalars have 24 bits (an MSMKernel of
24 scalar bits) and the windows 4 (8 buckets), so that the plain reduction
and Horner stay short;
the card runs the full widths (tests/test_torch_cuda.py, chip_smoke.py).
The proofs made with ``batch_msm=True`` are held to the JAX host engine's in
tests/test_torch_bsb22.py.
"""

import random

import pytest
import torch

from gnark_icicle_tpu.backend.groth16.host_compute import msm_host as host_msm
from gnark_icicle_tpu_torch.backend.kzg import KZG, unsafe_srs
from gnark_icicle_tpu_torch.device import DeviceCtx
from gnark_icicle_tpu_torch.ops import field as pf
from gnark_icicle_tpu_torch.ops.ec_t import TCurve2
from gnark_icicle_tpu_torch.ops.field_t import TField
from gnark_icicle_tpu_torch.ops.msm import MSMKernel

from test_torch_common import CURVES, rand_ints, ref_curve

BITS = 24          # scalar bits of the test kernels
M, N = 3, 40       # problems, points a problem
CASES = [(c, "g1") for c in sorted(CURVES)] + [("bls12_381", "g2"), ("bn254", "g2")]


def _host(tc, pt):
    """A host affine point in to_affine_host's form (Fp2 as int pairs)."""
    if pt is None or not isinstance(tc, TCurve2):
        return pt
    return ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))


def _problems(curve, group, seed):
    """M problems of N points (JAX host points (k0 + i·dk)·G; every 9th at
    infinity, three equal points at 10-12) and scalars below 2^BITS: random ones led by 0,
    1 and 2^BITS − 1, all zero, and skewed (mostly 1 and 2^BITS − 1, so
    that their buckets outgrow a forced short segment)."""
    grp = getattr(ref_curve(curve), group)
    r = CURVES[curve].fr.modulus
    k0, dk = rand_ints(seed, r, 2, edge=False)
    cur, step = grp.scalar_mul(grp.generator, k0), grp.scalar_mul(grp.generator, dk)
    pts = []
    for i in range(M * N):                    # k0·G + i·dk·G
        pts.append(None if i % 9 == 4 else cur)
        cur = grp.add(cur, step)
    for m in range(M):
        pts[m * N + 11] = pts[m * N + 12] = pts[m * N + 10]
    top = (1 << BITS) - 1
    rnd = [v & top for v in rand_ints(seed + 1, r, N, edge=False)]
    rnd[:3] = [0, 1, top]
    scal = [rnd, [0] * N, [v if i % 6 == 0 else (1, top, 1)[i % 3] for i, v in enumerate(rnd)]]
    return grp, pts, scal


@pytest.mark.parametrize("curve, group", CASES)
@pytest.mark.parametrize("table", ["shared", "per_problem"])
def test_msm_batch_matches_separate_msms_and_host(curve, group, table):
    ctx = DeviceCtx(CURVES[curve], "cpu")
    tc = getattr(ctx, group)
    grp, pts, scal = _problems(curve, group, 900 if table == "shared" else 910)
    if table == "shared":
        pts = pts[:N] * M
    rows = pts if table == "per_problem" else pts[:N]
    tab = tc.table([p or grp.generator for p in rows], "cpu")
    inf = torch.tensor([p is None for p in pts]).reshape(M, N)
    words = pf.words_for(CURVES[curve].fr.modulus)
    sc = torch.stack([pf.to_lanes(pf.ints_to_limbs32(v, words), "cpu") for v in scal])
    kern = MSMKernel(tc, BITS)
    c = 4
    got = tc.to_affine_host(kern.msm_batch(tab, inf, sc, c))
    split = tc.to_affine_host(kern._msm_batch(tab, inf, sc, c, 4))
    for m in range(M):
        t_m = tab[m * N:(m + 1) * N] if table == "per_problem" else tab
        want = _host(tc, host_msm(grp, pts[m * N:(m + 1) * N], scal[m]))
        assert got[m] == split[m] == want
        assert tc.to_affine_host(kern.msm(t_m, inf[m], sc[m], c))[0] == want
    assert got[1] is None                         # the all-zero problem


@pytest.mark.parametrize("curve, group", [(c, "g1") for c in sorted(CURVES)] + [("bn254", "g2")])
def test_horner_plain_of_m_problems_equals_m_calls(curve, group):
    """horner_plain at M = 3 (W = 4, c = 3; identity windows, a problem all
    identity) equals three calls at M = 1, limb for limb."""
    tc = getattr(DeviceCtx(CURVES[curve], "cpu"), group)
    p = tc.F.modulus
    W = 4
    S = torch.stack([tc.F.encode(rand_ints(920 + i, p, M * W), "cpu")
                     for i in range(tc.planes)])
    S[..., 2::5] = tc.identity(S[..., 2::5].shape[2], "cpu")
    S[..., W:2 * W] = tc.identity(W, "cpu")
    got = tc.horner(S, 3, M)
    assert got.shape == (tc.planes, tc.W, M)
    for m in range(M):
        assert torch.equal(got[..., m:m + 1], tc.horner_plain(S[..., m * W:(m + 1) * W], 3))


def test_kzg_commit_batch_matches_commit():
    """BN254: commit_batch and commit_mont_batch of two polynomials equal
    commit of each; unequal lengths are refused."""
    curve = CURVES["bn254"]
    q = curve.fr.modulus
    srs = unsafe_srs(curve, 8, rng=random.Random(930), device="cpu")
    kzg = KZG(curve, srs, "cpu")
    polys = [rand_ints(931, q, 6), rand_ints(932, q, 6, edge=False)]
    want = [kzg.commit(p) for p in polys]
    assert kzg.commit_batch(polys) == want
    tf = TField(kzg.ctx.fr)
    mont = [tf.to_mont(kzg.ctx.fr_plain(p)) for p in polys]
    assert kzg.commit_mont_batch(mont) == want
    with pytest.raises(AssertionError):
        kzg.commit_batch([polys[0], polys[1][:5]])
