"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and skips
inside the ``cuda_device`` fixture where torch sees none. The file imports
nothing of JAX and nothing of the JAX package, so it also runs on a machine
without them. There, tests/conftest.py (which configures JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The CPU tests hold the plain versions to the JAX package; these hold the
kernels to the plain versions, bit for bit, for BN254 (8-word Fp),
BLS12-381 and BLS12-377 (12-word Fp; BLS12-377's Fp2 has u² = −5) and BW6-761
(24-word Fp, 12-word Fr, G2 over Fp), and the whole slice on the card to the
same slice on the CPU.
"""

import dataclasses
import random

import pytest
import torch

from gnark_icicle_tpu_torch.backend import groth16, plonk
from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret, compile_circuit
from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2
from gnark_icicle_tpu_torch.ops.field import field_for
from gnark_icicle_tpu_torch.ops.field_t import (
    BATCH_INV_LANES, BATCH_INV_THREADS, QUOTIENT_INPUTS, TField, plonk_quotient_plain,
)
from gnark_icicle_tpu_torch.ops.msm import msm_host
from gnark_icicle_tpu_torch.ops.ntt import (
    Domain, domain_for, ntt_pass, ntt_pass_plain, pass_split, split_stages,
)

from test_torch_common import (  # noqa: F401
    CURVES, cuda_device, edge_scalars, g2_over_fp2, rand_ints,
)

pytestmark = pytest.mark.cuda
NAMES = sorted(CURVES)


def _group(curve, group):
    """The port's TCurve/TCurve2 of a host curve (BW6-761's G2: a TCurve)."""
    F = field_for(curve.fp.modulus)
    if group == "g1" or not g2_over_fp2(curve):
        grp = curve.g1 if group == "g1" else curve.g2
        return TCurve(F, 3 * grp.b % curve.fp.modulus)
    return TCurve2(F, curve.tower.beta, curve.g2.b * 3)


@pytest.mark.parametrize("name", NAMES)
def test_fr_kernels_match_plain(cuda_device, name):
    R = CURVES[name].fr.modulus
    F = field_for(R)
    tf = TField(F)
    a = F.encode(rand_ints(60, R, 4096), cuda_device)
    b = F.encode(rand_ints(61, R, 4096), cuda_device)
    c = F.const(rand_ints(62, R, 1, edge=False)[0], cuda_device)
    assert torch.equal(tf.mont_mul(a, b), F.mont_mul(a, b))
    assert torch.equal(tf.mont_mul(a, c), F.mont_mul(a, c))
    assert torch.equal(tf.sub(a, b), F.sub(a, b))
    # operands at p − 1 and products near R: the top-word carries
    edge = F.encode([R - 1, R - 2, (F.R - 1) % R, F.R % R] * 8, cuda_device)
    assert torch.equal(tf.mont_mul(edge, edge.flip(1)), F.mont_mul(edge, edge.flip(1)))


@pytest.mark.parametrize("name", NAMES)
def test_fr_add_quotient_and_inverse_match_plain(cuda_device, name):
    """fr_add, plonk_quotient (inputs led by 0, 1, p − 1, p − 2 and values
    near R in every array) and mont_inv (fr_batch_inv: zeros at the first
    and the last lane of threads, a thread all zeros, a last block of
    threads with fewer than BATCH_INV_LANES lanes) on the card against
    their plain versions."""
    R = CURVES[name].fr.modulus
    F = field_for(R)
    tf = TField(F)
    m = 4096

    def arr(seed):
        vals = rand_ints(seed, R, m)
        vals[3:6] = [R - 2, (F.R - 1) % R, F.R % R]
        return F.encode(vals, cuda_device)

    a, b = arr(63), arr(64)
    assert torch.equal(tf.add(a, b), F.add(a, b))
    assert torch.equal(tf.add(a, a.flip(1)), F.add(a, a.flip(1)))
    evals = [arr(200 + i) for i in range(len(QUOTIENT_INPUTS))]
    xs, l1 = arr(230), arr(231)
    zh = F.encode(rand_ints(232, R, 4, edge=False), cuda_device)
    consts = F.encode(rand_ints(233, R, 6, edge=False) + [1], cuda_device)
    want = plonk_quotient_plain(F, evals, xs, l1, zh, consts)
    assert torch.equal(tf.plonk_quotient(evals, xs, l1, zh, consts), want)
    assert torch.equal(tf.plonk_quotient(evals, xs, l1, zh, consts.cpu()), want)
    T, k = BATCH_INV_THREADS, BATCH_INV_LANES
    z = rand_ints(65, R, 2 * T * k + 37)
    z[3:6] = [R - 2, (F.R - 1) % R, F.R % R]
    for t in (5, T + 2, T - 1):
        z[t] = z[t + (k - 1) * T] = 0
    for i in range(k):
        z[7 + i * T] = 0
    x = F.encode(z, cuda_device)
    assert torch.equal(tf.mont_inv(x), F.mont_inv(x))


def test_fr_chains_never_fall_back(cuda_device, monkeypatch):
    """plonk_quotient and mont_inv on CUDA tensors launch their kernels
    (fr_batch_inv, plonk_quotient) and never their plain versions, which
    raise here."""
    from gnark_icicle_tpu_torch.ops import field_t
    from gnark_icicle_tpu_torch.ops.cuda import KERNELS

    R = CURVES["bn254"].fr.modulus
    F = field_for(R)

    def boom(*args, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(field_t, "plonk_quotient_plain", boom)
    monkeypatch.setattr(F, "mont_inv", boom)
    tf = TField(F)
    xs = F.encode(rand_ints(66, R, 256), cuda_device)
    inv, quot = KERNELS["fr_batch_inv"], KERNELS["plonk_quotient"]
    before = (inv.launches, quot.launches)
    tf.mont_inv(xs)
    tf.plonk_quotient([xs] * len(QUOTIENT_INPUTS), xs, xs, F.encode([1, 2, 3, 4], cuda_device),
                      F.encode(rand_ints(67, R, 6, edge=False) + [1], cuda_device))
    torch.cuda.synchronize()
    assert (inv.launches, quot.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("name", NAMES)
def test_ntt_pass_kernel_matches_plain(cuda_device, name):
    """ntt_pass against ntt_pass_plain at 2^12, DIF and DIT: each pass of
    pass_split (the low pass on groups of contiguous chunks, the upper on
    strided rows) and of a three-pass split (a middle pass), each with
    each fused scaling — none, the coset powers on the load, computeH's
    pointwise (a·b − c)·den, 1/n and a table on the store —, out of place
    and in place."""
    R = CURVES[name].fr.modulus
    F = field_for(R)
    n = 1 << 12
    tws = F.encode(rand_ints(90, R, n), cuda_device)
    x = F.encode(rand_ints(91, R, n), cuda_device)
    tab, tab2 = (F.encode(rand_ints(s, R, n), cuda_device) for s in (92, 93))
    col = F.const(rand_ints(94, R, 1, edge=False)[0], cuda_device)
    scalings = ({}, {"mul": tab}, {"mul": tab, "sub": tab2, "scale": col},
                {"post": col}, {"post": tab})
    passes = pass_split(12) + split_stages(12, 6, 3)
    assert len(passes) == 5
    for p in passes:
        for dif in (True, False):
            for ops in scalings:
                want = ntt_pass_plain(F, x, tws, p, dif, **ops)
                assert torch.equal(ntt_pass(F, x, tws, p, dif, **ops), want)
                y = x.clone()
                assert ntt_pass(F, y, tws, p, dif, **ops, out=y) is y
                assert torch.equal(y, want)


@pytest.mark.parametrize("name", ["bn254", "bw6_761"])
@pytest.mark.parametrize("log_m,blocks", [(9, 128), (12, 16)])
def test_ntt_pass_batched_matches_plain(cuda_device, name, log_m, blocks):
    """ntt_pass over a batch of transforms (the sharded NTT's sub-transforms:
    128 of 2^9, the 2^18 computeH's at four ranks, one pass; 16 of 2^12, two
    passes) against ntt_pass_plain, reading the m-wide table of one
    transform at its own stride, DIF with a table as wide as the batch on
    the store and DIT; then the batched Domain transforms against each
    block transformed alone on the card."""
    fr = CURVES[name].fr
    F = field_for(fr.modulus)
    m = 1 << log_m
    dom = Domain(F, log_m, fr.root_of_unity(log_m), None, cuda_device)
    tws = dom._twiddles("f")
    x = F.encode(rand_ints(95, fr.modulus, m * blocks), cuda_device)
    post = F.encode(rand_ints(96, fr.modulus, m * blocks), cuda_device)
    for p in pass_split(log_m):
        for dif, ops in ((True, {"post": post}), (False, {})):
            want = ntt_pass_plain(F, x, tws, p, dif, **ops)
            assert torch.equal(ntt_pass(F, x, tws, p, dif, **ops), want)
    for method in ("ntt", "intt"):
        got = getattr(dom, method)(x)
        for b in (0, blocks // 2, blocks - 1):
            cut = slice(b * m, (b + 1) * m)
            assert torch.equal(got[:, cut], getattr(dom, method)(x[:, cut].contiguous()))


@pytest.mark.parametrize("checks", ["ntt,msm", "prove"])
def test_sharded_two_ranks_on_card(cuda_device, checks):
    """Two ranks sharing the card over gloo (parallel/dryrun.py): the
    sharded NTT and the sharded G1 and G2 MSMs equal the single card's, and
    the sharded Chain's proof the single card's bytes, verified."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "gnark_icicle_tpu_torch.parallel.dryrun", "2",
                          "--device", "cuda", "--backend", "gloo", "--checks", checks],
                         cwd=repo, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == len(checks.split(","))
    assert all('"device": "cuda:0"' in ln for ln in lines)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("transform", ["intt_nat_to_rev", "coset_ntt_rev_in",
                                       "coset_intt_nat_to_rev", "ntt", "intt"])
def test_domain_transforms_match_cpu(cuda_device, name, transform):
    curve = CURVES[name]
    F = field_for(curve.fr.modulus)
    log_n = 10
    x = F.encode(rand_ints(95, curve.fr.modulus, 1 << log_n), "cpu")
    card = domain_for(F, curve.fr, log_n, cuda_device, coset=True)
    host = domain_for(F, curve.fr, log_n, "cpu", coset=True)
    got = getattr(card, transform)(x.to(cuda_device))
    assert torch.equal(got.cpu(), getattr(host, transform)(x))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("transform", ["coset_ntt_nat", "coset_intt_nat"])
def test_plonk_coset_transforms_match_cpu(cuda_device, name, transform):
    curve = CURVES[name]
    F = field_for(curve.fr.modulus)
    log_n = 12
    x = F.encode(rand_ints(96, curve.fr.modulus, 1 << log_n), "cpu")
    card = domain_for(F, curve.fr, log_n, cuda_device, coset=True)
    host = domain_for(F, curve.fr, log_n, "cpu", coset=True)
    got = getattr(card, transform)(x.to(cuda_device))
    assert torch.equal(got.cpu(), getattr(host, transform)(x))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_group_kernels_match_plain(cuda_device, name, group):
    P = CURVES[name].fp.modulus
    tc = _group(CURVES[name], group)
    F = tc.F
    n = 2048

    def rand_planes(seed, planes, count):
        return torch.stack([F.encode(rand_ints(seed + i, P, count), cuda_device)
                            for i in range(planes)])

    Pt, Qt = rand_planes(160, tc.planes, n), rand_planes(170, tc.planes, n)
    table = rand_planes(180, 2 * tc.NP, 256).reshape(-1, 256).T.contiguous()
    gen = torch.Generator(device="cpu").manual_seed(190)
    idx, sign, mask = (torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32)
                       .to(cuda_device) for hi in (256, 2, 2))
    acc_k, acc_p = Pt.clone(), Pt.clone()
    tc.add_mixed_masked(acc_k, n, table, idx, sign, mask)
    tc.add_mixed_masked_plain(acc_p, n, table, idx, sign, mask)
    assert torch.equal(acc_k, acc_p)
    assert torch.equal(tc.add(Pt, Qt),
                       tc._stack(tc.curve.add(tc._coords(Pt), tc._coords(Qt))))
    assert torch.equal(tc.double(Pt), tc._stack(tc.curve.double(tc._coords(Pt))))
    # a lane prefix of a wider batch is a valid operand (strided planes)
    assert torch.equal(tc.double(Pt[..., :100]), tc.double(Pt)[..., :100])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bucket_accumulate_matches_plain(cuda_device, name, group):
    """One launch over lanes sorted by run length (runs of 0 to 150 points,
    signed, gathered from a 256-row table) against the reference's wave
    schedule, limb for limb; accumulators start at the identity and at
    random points."""
    P = CURVES[name].fp.modulus
    tc = _group(CURVES[name], group)
    F = tc.F
    L, M = 2048, 256
    table = torch.stack([F.encode(rand_ints(300 + i, P, M), cuda_device)
                         for i in range(2 * tc.NP)]).reshape(-1, M).T.contiguous()
    gen = torch.Generator(device="cpu").manual_seed(310)
    counts = torch.randint(0, 9, (L,), generator=gen)
    counts[:4] = torch.tensor([150, 64, 63, 1])
    counts = torch.sort(counts, descending=True).values
    starts = torch.cumsum(counts, 0) - counts
    n = int(counts.sum())
    order = torch.randint(0, M, (n,), generator=gen, dtype=torch.int32)
    sign = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
    acc = tc.identity(L, cuda_device)
    acc[..., L // 2:] = torch.stack([F.encode(rand_ints(320 + i, P, L // 2), cuda_device)
                                     for i in range(tc.planes)])
    args = [t.to(cuda_device) for t in (order, sign, starts, counts.to(torch.int32))]
    acc_k, acc_p = acc.clone(), acc.clone()
    tc.bucket_accumulate(acc_k, table, *args)
    tc.bucket_accumulate_plain(acc_p, table, *args)
    assert torch.equal(acc_k, acc_p)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_and_normalize_match_plain(cuda_device, name, group):
    """The comb (*_fixed_base, at the window of the path and at w = 5) and
    the batch normalization (*_normalize at the path's k and at 3) on the card
    against their plain versions, limb for limb, at 2^12 edge and random
    scalars; a few lanes against the host product. BW6-761's G2 runs the
    g1 entries with G2's b3."""
    from gnark_icicle_tpu_torch.ops.ec_t import NORMALIZE_LANES
    from gnark_icicle_tpu_torch.ops.fixed_base import WINDOW, FixedBaseMul
    from gnark_icicle_tpu_torch.ops.field import ints_to_limbs32, to_lanes

    curve = CURVES[name]
    tc = _group(curve, group)
    G = curve.g1 if group == "g1" else curve.g2
    r = curve.fr.modulus
    bits = r.bit_length()
    scalars = edge_scalars(r, 1 << 12, 330)
    sc = to_lanes(ints_to_limbs32(scalars, field_for(r).n32), cuda_device)
    for i, w in enumerate((WINDOW, 5)):
        fb = FixedBaseMul(tc, G, G.generator, bits, cuda_device, w=w)
        got = fb.mul(sc)
        assert torch.equal(got, tc.fixed_base_plain(sc, fb.table, w, bits))
        for k in ((NORMALIZE_LANES, 3) if i == 0 else (NORMALIZE_LANES,)):
            xy, inf = tc.normalize(got, k)
            want = tc.normalize_plain(got, k)
            assert torch.equal(xy, want[0]) and torch.equal(inf, want[1])
        assert inf.tolist() == [int(s == 0) for s in scalars]
        host = [G.scalar_mul(G.generator, s) for s in scalars[:16]]
        if tc.NP == 2:
            host = [None if q is None else ((q[0].c0, q[0].c1), (q[1].c0, q[1].c1)) for q in host]
        assert tc.affine_host(xy[..., :16], inf[:16]) == host


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_reduction_kernels_match_plain(cuda_device, name, group):
    """The running sums, the combine and Horner against their plain
    versions, limb for limb: random coordinates with identity lanes
    and an identity window; M = 64, 8, 2 and 1 (the combine alone), V = 1,
    8 (fewer chunks than combine threads) and 256, 512 (r = 2, 4 chunks a
    thread); Horner at W = 5, c = 4 and at one window."""
    P = CURVES[name].fp.modulus
    tc = _group(CURVES[name], group)
    F = tc.F

    def rand_planes(seed, count):
        S = torch.stack([F.encode(rand_ints(seed + i, P, count), cuda_device)
                         for i in range(tc.planes)])
        S[..., ::7] = tc.identity(S[..., ::7].shape[2], cuda_device)
        return S

    for W, B, Vs in ((3, 64, (1, 8)), (2, 512, (256, 512))):
        S = rand_planes(400 + B, W * B)
        S[..., :B] = tc.identity(B, cuda_device)   # window 0 empty
        for V in Vs:
            M = B // V
            TA = tc.reduce_runs(S, M)
            assert torch.equal(TA, tc.reduce_runs_plain(S, M))
            T, A = TA[:tc.planes], TA[tc.planes:]
            assert torch.equal(tc.reduce_combine(T, A, W, V, M),
                               tc.reduce_combine_plain(T, A, W, V, M))
            assert torch.equal(tc.bucket_reduce(S, W, V),
                               tc.reduce_combine_plain(T, A, W, V, M) if M > 1
                               else tc.reduce_combine_plain(S, S, W, V, 1))
    for W in (5, 1):
        S = rand_planes(450 + W, W)
        want = tc.horner_plain(S, 4)
        assert torch.equal(tc.horner(S, 4), want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_batched_horner_matches_plain(cuda_device, name, group):
    """Horner over M = 1, 2 and 3 problems (one warp a problem) against its
    plain version, limb for limb, and each problem against a launch of its
    own: random window sums with identity windows and a problem all
    identity; W = 5, c = 4 and the Chain's W = 17, c = 16."""
    P = CURVES[name].fp.modulus
    tc = _group(CURVES[name], group)
    F = tc.F
    for W, c in ((5, 4), (17, 16)):
        for M in (1, 2, 3):
            S = torch.stack([F.encode(rand_ints(470 + 10 * M + i, P, M * W), cuda_device)
                             for i in range(tc.planes)])
            S[..., 1::4] = tc.identity(S[..., 1::4].shape[2], cuda_device)
            if M > 1:
                S[..., W:2 * W] = tc.identity(W, cuda_device)   # problem 1: all identity
            got = tc.horner(S, c, M)
            assert got.shape[2] == M
            assert torch.equal(got, tc.horner_plain(S, c, M))
            for m in range(M):
                one = tc.horner(S[..., m * W:(m + 1) * W].contiguous(), c)
                assert torch.equal(got[..., m:m + 1], one)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("table", ["shared", "per_problem"])
def test_msm_batch_matches_separate_msms(cuda_device, name, group, table):
    """msm_batch of M = 3 problems of 300 points (every 7th at infinity)
    against three msm calls, in affine form: random scalars, a problem all
    zero, and a skewed one (mostly 1 and r − 1) whose buckets are split;
    one table shared by the three or one a problem."""
    from gnark_icicle_tpu_torch.ops.field import ints_to_limbs32, to_lanes
    from gnark_icicle_tpu_torch.ops.msm import MSMKernel, pick_window

    curve = CURVES[name]
    R = curve.fr.modulus
    grp = curve.g1 if group == "g1" else curve.g2
    tc = _group(curve, group)
    n, M = 300, 3
    k0, dk = rand_ints(210, R, 2, edge=False)
    cur, step = grp.scalar_mul(grp.generator, k0), grp.scalar_mul(grp.generator, dk)
    pts = []
    for i in range(M * n):
        pts.append(None if i % 7 == 3 else cur)
        cur = grp.add(cur, step)
    rows = pts if table == "per_problem" else pts[:n]
    filler = next(p for p in rows if p is not None)
    tab = tc.table([p if p is not None else filler for p in rows], cuda_device)
    infs = torch.tensor([p is None for p in rows], device=cuda_device)
    inf = infs.reshape(-1, n).expand(M, n).contiguous()
    scal = [rand_ints(211, R, n), [0] * n,
            [s if i % 10 == 0 else (1, 1, 0, R - 1)[i % 4]
             for i, s in enumerate(rand_ints(212, R, n))]]
    sc = torch.stack([to_lanes(ints_to_limbs32(v, -(-R.bit_length() // 32)), cuda_device)
                      for v in scal])
    kern = MSMKernel(tc, R.bit_length())
    c = pick_window(n)
    got = tc.to_affine_host(kern.msm_batch(tab, inf, sc, c))
    for m in range(M):
        t_m = tab[m * n:(m + 1) * n] if table == "per_problem" else tab
        assert got[m] == tc.to_affine_host(kern.msm(t_m, inf[m], sc[m], c))[0]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("scalars", ["random", "skewed"])
def test_msm_matches_host_oracle(cuda_device, name, group, scalars):
    """300 points, every 7th at infinity. Random scalars lead with 0, 1 and
    r − 1; skewed ones are mostly 1 and r − 1, so that window 0's digit-1
    bucket and every window's bucket of r − 1 hold runs longer than the
    segment length (64 here): the MSM splits them and folds the segments."""
    curve = CURVES[name]
    R = curve.fr.modulus
    grp = curve.g1 if group == "g1" else curve.g2
    tc = _group(curve, group)
    n = 300
    k0, dk = rand_ints(200, R, 2, edge=False)
    cur, step = grp.scalar_mul(grp.generator, k0), grp.scalar_mul(grp.generator, dk)
    pts = []
    for i in range(n):
        pts.append(None if i % 7 == 3 else cur)
        cur = grp.add(cur, step)
    scal = rand_ints(201, R, n)  # leads with 0, 1, r − 1
    if scalars == "skewed":
        scal = [s if i % 10 == 0 else (1, 1, 0, R - 1)[i % 4] for i, s in enumerate(scal)]
    want = grp.msm(scal, pts)
    if isinstance(tc, TCurve2) and want is not None:
        want = ((want[0].c0, want[0].c1), (want[1].c0, want[1].c1))
    assert msm_host(tc, curve.fr, pts, scal, cuda_device) == want


STEPS = 260  # 262 wires: the G2 key products take the ladder too (>= 256)


class Chain(Circuit):
    """x_{i+1} = x_i² + x_i + i (bench.py's benchmark circuit, cut in depth)."""
    x = Secret()
    out = Public()

    def define(self, api):
        v = self.x
        for i in range(STEPS):
            v = api.add(api.mul(v, v), v, i)
        api.assert_is_equal(v, self.out)


PLONK_STEPS = 80  # about 240 gates: a 2^8 domain, whose SRS (261 powers) takes the ladder


class PlonkChain(Chain):
    def define(self, api):
        v = self.x
        for i in range(PLONK_STEPS):
            v = api.add(api.mul(v, v), v, i)
        api.assert_is_equal(v, self.out)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if not f.name.startswith("_")}


@pytest.mark.parametrize("name", NAMES)
def test_groth16_on_card_matches_cpu(cuda_device, name):
    curve = CURVES[name]
    R = curve.fr.modulus
    cs = compile_circuit(R, Chain)
    v = 3
    for i in range(STEPS):
        v = (v * v + v + i) % R
    keys, proofs = {}, {}
    for dev in ("cpu", cuda_device):
        pk, vk = groth16.setup(cs, curve, rng=random.Random(1), device=dev)
        keys[str(dev)] = (pk, vk)
        proofs[str(dev)] = groth16.prove(cs, pk, [v], [3], curve,
                                         rng=random.Random(2), device=dev)
    (pk_c, vk_c), (pk_g, vk_g) = keys.values()
    assert _fields(pk_g) == _fields(pk_c) and _fields(vk_g) == _fields(vk_c)
    proof_c, proof_g = proofs.values()
    assert _fields(proof_g) == _fields(proof_c)
    groth16.verify(proof_g, vk_g, [v], curve)
    assert not groth16.is_valid(proof_g, vk_g, [(v + 1) % R], curve)


def test_entry_points_default_to_the_card(cuda_device):
    """With no device given, setup and prove run on cuda:0 (the launch
    counts of the kernels move)."""
    from gnark_icicle_tpu_torch.device import DeviceCtx
    from gnark_icicle_tpu_torch.ops import cuda as kc

    curve = CURVES["bn254"]
    assert DeviceCtx(curve).device == torch.device("cuda", 0)
    R = curve.fr.modulus
    cs = compile_circuit(R, Chain)
    v = 3
    for i in range(STEPS):
        v = (v * v + v + i) % R
    before = sum(k.launches for k in kc.KERNELS.values())
    pk, vk = groth16.setup(cs, curve, rng=random.Random(1))
    proof = groth16.prove(cs, pk, [v], [3], curve, rng=random.Random(2))
    assert sum(k.launches for k in kc.KERNELS.values()) > before
    groth16.verify(proof, vk, [v], curve)


@pytest.mark.parametrize("name", NAMES)
def test_plonk_on_card_verifies(cuda_device, name):
    """A small PLONK circuit (a 2^8 domain, so that the SRS takes the
    fixed-base ladder) set up and proved on the card; the proof verifies
    and a tampered public input is rejected. On BN254 the card's keys and
    proof equal the CPU's (plain versions) under the same rngs."""
    curve = CURVES[name]
    R = curve.fr.modulus
    cs = compile_circuit(R, PlonkChain, builder="scs")
    assert 128 < cs.nb_gates <= 251
    v = 3
    for i in range(PLONK_STEPS):
        v = (v * v + v + i) % R
    pk, vk = plonk.setup(cs, curve, rng=random.Random(1), device=cuda_device)
    proof = plonk.prove(cs, pk, [v], [3], curve, rng=random.Random(2), device=cuda_device)
    plonk.verify(proof, vk, [v], curve)
    assert not plonk.is_valid(proof, vk, [(v + 1) % R], curve)
    if name == "bn254":
        pk_c, vk_c = plonk.setup(cs, curve, rng=random.Random(1), device="cpu")
        assert _fields(vk_c) == _fields(vk)
        proof_c = plonk.prove(cs, pk_c, [v], [3], curve, rng=random.Random(2), device="cpu")
        assert _fields(proof_c) == _fields(proof)


@pytest.mark.parametrize("name", NAMES)
def test_batched_proves_match_unbatched_on_card(cuda_device, name):
    """Groth16 and PLONK with batch_msm=True on the card give the same proof
    as without it under one rng (the G1 MSMs of one padded size, and
    PLONK's round-1 and round-3 commits, as one msm_batch each)."""
    curve = CURVES[name]
    R = curve.fr.modulus
    for system, circuit, steps, kw in ((groth16, Chain, STEPS, {}),
                                       (plonk, PlonkChain, PLONK_STEPS, {"builder": "scs"})):
        cs = compile_circuit(R, circuit, **kw)
        v = 3
        for i in range(steps):
            v = (v * v + v + i) % R
        pk, vk = system.setup(cs, curve, rng=random.Random(1), device=cuda_device)
        proofs = [system.prove(cs, pk, [v], [3], curve, rng=random.Random(2),
                               device=cuda_device, batch_msm=b) for b in (False, True)]
        assert _fields(proofs[0]) == _fields(proofs[1])
        system.verify(proofs[1], vk, [v], curve)


class CommitChain(Circuit):
    """A short Chain with one BSB22 commitment over the secret input and an
    intermediate value."""
    x = Secret()
    out = Public()

    def define(self, api):
        v = self.x
        for i in range(40):
            v = api.add(api.mul(v, v), v, i)
            if i == 20:
                api.assert_is_different(api.commit(self.x, v), 0)
        api.assert_is_equal(v, self.out)


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_bsb22_proves_on_card(cuda_device, name):
    """A circuit with api.commit through Groth16 and PLONK on the card: the
    proofs verify, equal the CPU's under one rng (the commitment's hiding
    mask fixed), and a tampered commitment is rejected."""
    import secrets

    curve = CURVES[name]
    R = curve.fr.modulus
    v = 3
    for i in range(40):
        v = (v * v + v + i) % R
    mask = secrets.randbelow
    secrets.randbelow = lambda m: 7 % m
    try:
        for system, kw in ((groth16, {}), (plonk, {"builder": "scs"})):
            cs = compile_circuit(R, CommitChain, **kw)
            proofs = {}
            for dev in ("cpu", cuda_device):
                pk, vk = system.setup(cs, curve, rng=random.Random(1), device=dev)
                proofs[str(dev)] = system.prove(cs, pk, [v], [3], curve, rng=random.Random(2),
                                                device=dev)
            p_cpu, p_card = proofs.values()
            assert _fields(p_cpu) == _fields(p_card)
            system.verify(p_card, vk, [v], curve)
            field = "commitments" if system is groth16 else "bsb22_commitments"
            bad = dataclasses.replace(p_card, **{field: [curve.g1.generator]})
            assert not system.is_valid(bad, vk, [v], curve)
    finally:
        secrets.randbelow = mask


# the __global__ function that each entry launches (unprefixed entry, or the
# op of a g1_/g2_ entry): a profiler trace names the launches by it
SYMBOLS = {"fr_mont_mul": "k_fr_mont_mul", "fr_sub": "k_fr_sub", "fr_add": "k_fr_add",
           "plonk_quotient": "k_plonk_quotient", "fr_batch_inv": "k_fr_batch_inv",
           "ntt_pass": "k_ntt_pass", "add": "k_add", "double": "k_double",
           "add_mixed_masked": "k_mixed_accumulate", "bucket_accumulate": "k_mixed_accumulate",
           "fixed_base": "k_mixed_accumulate", "normalize": "k_normalize",
           "bucket_reduce": "k_reduce", "reduce_combine": "k_reduce", "horner": "k_horner"}


@pytest.mark.parametrize("system", ["groth16", "plonk"])
def test_served_request_on_card(cuda_device, tmp_path, system):
    """A resident prover on the card answers a request through the wire
    formats (the system read from gnark's .r1cs/.scs, Groth16's proving key
    and the witness from their bytes): its proof bytes equal the direct
    prove's under one rng, and read back from them it verifies. The request
    runs under profile.device_trace and annotate: the trace holds the
    region and names the function of every kernel entry that ran."""
    import json

    from gnark_icicle_tpu_torch import profile
    from gnark_icicle_tpu_torch.backend.prover_service import Groth16Prover, PlonkProver
    from gnark_icicle_tpu_torch.io import gnark_cs, keys, plonk_serialize, serialize
    from gnark_icicle_tpu_torch.ops import cuda as kc

    curve = CURVES["bn254"]
    R = curve.fr.modulus
    groth = system == "groth16"
    backend, circuit, steps = (groth16, Chain, STEPS) if groth else (plonk, PlonkChain,
                                                                       PLONK_STEPS)
    cs = compile_circuit(R, circuit, builder="r1cs" if groth else "scs")
    v = 3
    for i in range(steps):
        v = (v * v + v + i) % R
    pk, vk = backend.setup(cs, curve, rng=random.Random(1), device=cuda_device)
    if groth:
        served = Groth16Prover(gnark_cs.read_r1cs(gnark_cs.write_r1cs(cs)),
                               keys.pk_from_bytes(curve, keys.pk_to_bytes(curve, pk)), curve,
                               device=cuda_device)
        proof_to, proof_from = serialize.proof_to_bytes, serialize.proof_from_bytes
    else:
        served = PlonkProver(gnark_cs.read_scs(gnark_cs.write_scs(cs)), pk, curve,
                             device=cuda_device)
        proof_to = plonk_serialize.plonk_proof_to_bytes
        proof_from = plonk_serialize.plonk_proof_from_bytes
    pub, sec = serialize.witness_from_bytes(curve, serialize.witness_to_bytes(curve, [v], [3]))
    before = {k.name: k.launches for k in kc.KERNELS.values()}
    with profile.device_trace(str(tmp_path), device=cuda_device) as trace:
        with profile.annotate("request"):
            proof = served.prove(pub, sec, rng=random.Random(2))
    ran = {k.name for k in kc.KERNELS.values() if k.launches > before[k.name]}
    data = proof_to(curve, proof)
    direct = backend.prove(cs, pk, [v], [3], curve, rng=random.Random(2), device=cuda_device)
    assert data == proof_to(curve, direct)
    back, used = proof_from(curve, data)
    assert used == len(data)
    backend.verify(back, vk, [v], curve)

    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "request" and e.get("cat") == "user_annotation"
               for e in events)
    names = {e["name"].removeprefix("void ").split("(")[0].split("<")[0]
             for e in events if e.get("cat") == "kernel"}
    assert ran and "ntt_pass" in ran and "g1_bucket_accumulate" in ran
    for entry in ran:
        g, _, op = entry.partition("_")
        assert SYMBOLS[op if g in ("g1", "g2") else entry] in names, entry
