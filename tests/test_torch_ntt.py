"""Port NTT (gnark_icicle_tpu_torch/ops/ntt.py) against the JAX package's
Domain (gnark_icicle_tpu/ops/ntt.py) at log_n = 4 for BN254 and at
log_n = 6 for BLS12-381 (r: 2-adicity 32, generator 7): the three transforms
computeH uses, plus ntt and intt. Bit-identical limbs, tolerance zero.

The JAX transforms donate their input, so they get copies.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu.ops.ntt import bitrev_indices as ref_bitrev
from gnark_icicle_tpu.ops.ntt import domain_for as ref_domain_for
from gnark_icicle_tpu_torch.ops.field import field_for
from gnark_icicle_tpu_torch.ops.ntt import bitrev_indices, domain_for

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
