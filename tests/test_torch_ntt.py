"""Port NTT (gnark_icicle_tpu_torch/ops/ntt.py) against the JAX package's
Domain (gnark_icicle_tpu/ops/ntt.py) at log_n = 4 for BN254 and at
log_n = 6 for BLS12-381 (r: 2-adicity 32, generator 7): the three transforms
computeH uses, plus ntt and intt; at log_n = 6 for BN254 the same and PLONK's
two 4n coset forms cut into three passes of two stages, and computeH at
log_n = 5. Bit-identical limbs, tolerance zero. The pass split, the plain
pass (``ntt_pass_plain``) with each fused scaling against the stage loop,
and the domain cache.

The JAX transforms donate their input, so they get copies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_icicle_tpu.backend.groth16.host_compute import (
    compute_h_host, z_scalars_bitreversed,
)
from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu.ops.ntt import bitrev_indices as ref_bitrev
from gnark_icicle_tpu.ops.ntt import domain_for as ref_domain_for
from gnark_icicle_tpu_torch.backend.groth16.prove import _compute_h
from gnark_icicle_tpu_torch.device import DeviceCtx
from gnark_icicle_tpu_torch.ops import ntt
from gnark_icicle_tpu_torch.ops.field import field_for, ints_to_limbs32
from gnark_icicle_tpu_torch.ops.ntt import (
    NttPass, bitrev_indices, domain_for, ntt_pass_plain, ntt_stage_plain, pass_split,
    split_stages,
)

from test_torch_common import (
    CURVES, lanes_to_ref, rand_ints, ref_curve, ref_to_lanes,
)

LOG_N = 4
LOG_N_BLS = 6
TRANSFORMS = ["intt_nat_to_rev", "coset_ntt_rev_in", "coset_intt_nat_to_rev",
              "ntt", "intt"]


def _domains(curve, log_n):
    q = CURVES[curve].fr.modulus
    ref = ref_domain_for(ref_field_for(q), ref_curve(curve).fr, log_n, coset=True)
    port = domain_for(field_for(q), CURVES[curve].fr, log_n, "cpu", coset=True)
    return ref, port


@pytest.fixture(scope="module")
def domains():
    return _domains("bn254", LOG_N)


@pytest.fixture(scope="module")
def domains_bls12_381():
    return _domains("bls12_381", LOG_N_BLS)


def test_bitrev_matches_reference():
    for n in (1, 2, 16, 1024):
        np.testing.assert_array_equal(bitrev_indices(n), ref_bitrev(n))


def test_tables_match_reference(domains):
    ref, port = domains
    for name in ("tw_fwd", "tw_inv", "coset_pows", "coset_inv_pows"):
        np.testing.assert_array_equal(lanes_to_ref(getattr(port, name)),
                                      np.asarray(getattr(ref, name)))


def test_tables_match_reference_bls12_381(domains_bls12_381):
    test_tables_match_reference(domains_bls12_381)


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_reference(domains, name):
    ref, port = domains
    q = port.F.modulus
    x = ref_field_for(q).encode(rand_ints(70 + TRANSFORMS.index(name), q, port.n))
    want = np.asarray(getattr(ref, name)(jnp.array(x)))
    xin = ref_to_lanes(x)
    got = getattr(port, name)(xin)
    np.testing.assert_array_equal(lanes_to_ref(got), want)
    # the port's transforms leave their argument alone
    np.testing.assert_array_equal(lanes_to_ref(xin), x)


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_reference_bls12_381(domains_bls12_381, name):
    test_transform_matches_reference(domains_bls12_381, name)


def test_forward_inverse_roundtrip(domains):
    _, port = domains
    F = port.F
    xs = rand_ints(80, F.modulus, port.n)
    x = F.encode(xs, "cpu")
    assert F.decode(port.intt(port.ntt(x))) == xs
    # the computeH pairing: coset INTT undoes coset NTT through bit reversal
    assert F.decode(port.coset_intt_nat_to_rev(
        port.coset_ntt_rev_in(port.bit_reverse(x)))) == [
            xs[int(i)] for i in bitrev_indices(port.n)]


def test_forward_inverse_roundtrip_bls12_381(domains_bls12_381):
    test_forward_inverse_roundtrip(domains_bls12_381)


# PLONK's 4n coset forms beside computeH's
TRANSFORMS_4N = TRANSFORMS + ["coset_ntt_nat", "coset_intt_nat"]
SHARED_BYTES = 227 * 1024     # the shared memory a block may use on the card


def _short_passes(monkeypatch, log_tile=3, log_cols=1):
    """Cut every transform into passes of at most two stages on tiles of
    2^3 (2^6: three passes, of two groups, then of two columns)."""
    monkeypatch.setattr(ntt, "pass_split",
                        lambda log_n: split_stages(log_n, log_tile, log_cols))


@pytest.mark.parametrize("words", [8, 12])
def test_pass_split_covers_every_stage_once(words):
    """For 2^1-2^24: every stage in exactly one pass, in order, at most
    three passes (one up to 2^10), each tile within shared memory, its
    columns no more than the stages below it, its groups no more than the
    data holds."""
    for log_n in range(1, 25):
        passes = pass_split(log_n)
        assert [s for p in passes for s in range(p.s_lo, p.s_lo + p.c)] == list(range(log_n))
        assert len(passes) <= 3 and (len(passes) == 1) == (log_n <= 10)
        for p in passes:
            tile = p.log_g + p.c + p.log_t
            assert 4 * words << tile <= SHARED_BYTES and tile <= ntt.LOG_TILE
            assert p.log_t <= p.s_lo and tile <= log_n
            assert p.s_lo == 0 or p.log_t >= 3      # strided rows: 32-byte runs
    assert [tuple(p) for p in pass_split(18)] == [(0, 10, 0, 1), (10, 8, 3, 0)]
    assert [tuple(p) for p in pass_split(19)] == [(0, 11, 0, 0), (11, 8, 3, 0)]


def _stage_loop(F, x, tw, log_n, dif):
    """The transform's radix-2 stages one by one on the natural (W, n/2)
    twiddle table (the per-stage loop that the passes replace)."""
    y = x.clone()
    n = 1 << log_n
    for s in (range(log_n - 1, -1, -1) if dif else range(log_n)):
        ntt_stage_plain(F, y, 1 << s, n >> (s + 1), tw, dif)
    return y


@pytest.mark.parametrize("dif", [True, False])
@pytest.mark.parametrize("scaling", ["none", "mul", "pointwise", "post_column", "post_table"])
def test_plain_passes_match_stage_loop(dif, scaling):
    """ntt_pass_plain in short runs (2 + 2 + 2 stages at 2^6, in the
    transform's order) against the stage loop with its scalings as separate
    products, limb for limb: the coset powers on the load, computeH's
    (a·b − c)·den, 1/n and a table on the store."""
    q = CURVES["bn254"].fr.modulus
    F = field_for(q)
    log_n, n = 6, 64
    dom = domain_for(F, CURVES["bn254"].fr, log_n, "cpu")
    tw, tws = dom.tw_fwd.contiguous(), dom._twiddles("f")
    x, t1, t2 = (F.encode(rand_ints(s, q, n), "cpu") for s in (40, 41, 42))
    col = F.const(rand_ints(43, q, 1, edge=False)[0], "cpu")
    ops = {"none": {}, "mul": {"mul": t1}, "pointwise": {"mul": t1, "sub": t2, "scale": col},
           "post_column": {"post": col}, "post_table": {"post": t1}}[scaling]
    v = x
    if "mul" in ops:
        v = F.mont_mul(v, ops["mul"])
    if "sub" in ops:
        v = F.mont_mul(F.sub(v, ops["sub"]), ops["scale"])
    want = _stage_loop(F, v, tw, log_n, dif)
    if "post" in ops:
        want = F.mont_mul(want, ops["post"])
    passes = [NttPass(0, 2, 0, 1), NttPass(2, 2, 1, 0), NttPass(4, 2, 1, 0)]
    if dif:
        passes = passes[::-1]
    load = {k: t for k, t in ops.items() if k != "post"}
    y = x
    for i, p in enumerate(passes):
        y = ntt_pass_plain(F, y, tws, p, dif, **(load if i == 0 else {}),
                           post=ops.get("post") if i == len(passes) - 1 else None)
    assert torch.equal(y, want)
    assert torch.equal(ntt_pass_plain(F, x, tws, NttPass(0, 0, 0, 0), dif), x)


@pytest.fixture(scope="module")
def domains_bn254_6():
    return _domains("bn254", 6)


@pytest.mark.parametrize("name", TRANSFORMS_4N)
def test_transform_in_passes_matches_reference(domains_bn254_6, monkeypatch, name):
    """Each transform at 2^6 cut into three passes of two stages, the
    scalings fused, against the JAX package's Domain bit for bit."""
    _short_passes(monkeypatch)
    assert len(ntt.pass_split(6)) == 3
    ref, port = domains_bn254_6
    q = port.F.modulus
    x = ref_field_for(q).encode(rand_ints(90 + TRANSFORMS_4N.index(name), q, port.n))
    want = np.asarray(getattr(ref, name)(jnp.array(x)))
    xin = ref_to_lanes(x)
    np.testing.assert_array_equal(lanes_to_ref(getattr(port, name)(xin)), want)
    np.testing.assert_array_equal(lanes_to_ref(xin), x)


@pytest.mark.parametrize("short", [False, True])
def test_compute_h_matches_reference(monkeypatch, short):
    """The port's computeH (the pointwise (a·b − c)·den on the coset INTT's
    first pass) against the JAX package's host computeH on BN254 at
    log_n = 5, with 29 rows of random a, b, c: in one pass a transform, and
    in passes of two stages (three passes a transform)."""
    if short:
        _short_passes(monkeypatch)
    curve = CURVES["bn254"]
    q = curve.fr.modulus
    log_n, rows = 5, 29
    a, b, c = (rand_ints(s, q, rows) for s in (50, 51, 52))
    ctx = DeviceCtx(curve, "cpu")
    h = _compute_h(ctx, *(ints_to_limbs32(v, ctx.fr.n32) for v in (a, b, c)), log_n)
    want = z_scalars_bitreversed(compute_h_host(a, b, c, log_n, ref_curve("bn254").fr),
                                 log_n, 1 << log_n)
    assert ctx.fr.decode_plain(h) == want


def test_domain_is_built_once():
    """domain_for returns one Domain per (modulus, log_n, coset, device),
    whoever asks (two contexts too), and its tables are built once."""
    curve = CURVES["bn254"]
    F = field_for(curve.fr.modulus)
    d = domain_for(F, curve.fr, 3, "cpu", coset=True)
    tws = d._twiddles("i")
    assert domain_for(F, curve.fr, 3, torch.device("cpu"), coset=True) is d
    assert DeviceCtx(curve, "cpu").domain(3, coset=True) is d
    assert DeviceCtx(curve, "cpu").domain(3, coset=True)._twiddles("i") is tws
    assert domain_for(F, curve.fr, 3, "cpu") is not d
    assert domain_for(F, curve.fr, 4, "cpu", coset=True) is not d
