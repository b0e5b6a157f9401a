"""Port field arithmetic (gnark_icicle_tpu_torch/ops/field.py, field_t.py)
against the JAX package's LimbField (gnark_icicle_tpu/ops/field.py), for
BN254 (8 words per element in both fields) and BLS12-381 (Fp at 12 words,
Fr at 8).

Both sides get the same Montgomery limbs; results must be bit-identical
(tolerance zero: these are integers). Every operand list holds 0, 1 and
p − 1. Each test takes the curve as an argument that defaults to BN254; its
``_bls12_381`` twin runs it for BLS12-381.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnark_icicle_tpu.ops.field import field_for as ref_field_for
from gnark_icicle_tpu_torch.ops import field as pf
from gnark_icicle_tpu_torch.ops.field_t import TField

from test_torch_common import (
    CURVES, lanes_to_ref, rand_ints, ref_to_lanes,
)

N = 64
BLS = "bls12_381"


def _modulus(curve, name):
    c = CURVES[curve]
    return (c.fr if name == "fr" else c.fp).modulus


def _operands(q, seed):
    xs = rand_ints(seed, q, N)
    ys = rand_ints(seed + 1, q, N, edge=False)
    ys[:3] = [q - 1, 0, q - 1]
    ref = ref_field_for(q)
    return ref, ref.encode(xs), ref.encode(ys)


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_constants_match_limbfield(name, curve="bn254"):
    q = _modulus(curve, name)
    ref, port = ref_field_for(q), pf.field_for(q)
    assert (port.R, port.R2, port.nprime) == (ref.R, ref.R2, ref.nprime)
    assert port.n16 == ref.K
    assert port.one_mont == int.from_bytes(
        ref.one_mont_np.astype("<u2").tobytes(), "little")


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_constants_match_limbfield_bls12_381(name):
    test_constants_match_limbfield(name, BLS)


def test_words_per_field():
    assert [pf.words_for(_modulus(c, f)) for c in ("bn254", BLS)
            for f in ("fr", "fp")] == [8, 8, 8, 12]


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_encode_decode_roundtrip(name, curve="bn254"):
    q = _modulus(curve, name)
    ref, port = ref_field_for(q), pf.field_for(q)
    xs = rand_ints(5, q, N)
    enc = port.encode(xs, "cpu")
    assert enc.shape == (port.n32, N)
    assert port.decode(enc) == xs
    np.testing.assert_array_equal(lanes_to_ref(enc), ref.encode(xs))
    assert port.decode_plain(port.encode_plain(xs, "cpu")) == xs


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_encode_decode_roundtrip_bls12_381(name):
    test_encode_decode_roundtrip(name, BLS)


def test_repack_roundtrip():
    rng = np.random.default_rng(11)
    x16 = rng.integers(0, 1 << 16, size=(N, 16)).astype(np.int32)
    x32 = pf.repack16_to_32(x16)
    np.testing.assert_array_equal(pf.repack32_to_16(x32), x16)
    # same integers: 16 16-bit limbs == 8 32-bit limbs
    ref16 = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in x16]
    assert pf.limbs32_to_ints(x32) == ref16
    t = pf.to_lanes(x32, "cpu")
    assert t.shape == (8, N) and t.dtype == torch.int32
    np.testing.assert_array_equal(pf.from_lanes(t), x32)
    # 16-bit int64 view of the words, and back
    np.testing.assert_array_equal(pf.to16(t).numpy().T, x16)
    assert torch.equal(pf.to32(pf.to16(t)), t)


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_op_matches_limbfield(name, op, curve="bn254"):
    q = _modulus(curve, name)
    ref, a, b = _operands(q, 20)
    want = np.asarray(getattr(ref, op)(jnp.asarray(a), jnp.asarray(b)))
    port = pf.field_for(q)
    got = getattr(port, op)(ref_to_lanes(a), ref_to_lanes(b))
    np.testing.assert_array_equal(lanes_to_ref(got), want)


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_op_matches_limbfield_bls12_381(name, op):
    test_binary_op_matches_limbfield(name, op, BLS)


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont"])
def test_unary_op_matches_limbfield(name, op, curve="bn254"):
    q = _modulus(curve, name)
    ref, a, _ = _operands(q, 30)
    want = np.asarray(getattr(ref, op)(jnp.asarray(a)))
    port = pf.field_for(q)
    got = getattr(port, op)(ref_to_lanes(a))
    np.testing.assert_array_equal(lanes_to_ref(got), want)


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont"])
def test_unary_op_matches_limbfield_bls12_381(name, op):
    test_unary_op_matches_limbfield(name, op, BLS)


def test_tfield_cpu_is_plain_and_broadcasts(curve="bn254"):
    """On CPU tensors TField runs the plain version; (8, 1) broadcasts."""
    R = CURVES[curve].fr.modulus
    ref, a, b = _operands(R, 40)
    tf = TField(pf.field_for(R))
    c = ref.encode([rand_ints(41, R, 1, edge=False)[0]])
    want = np.asarray(ref.mont_mul(jnp.asarray(a),
                                   jnp.broadcast_to(jnp.asarray(c), a.shape)))
    got = tf.mont_mul(ref_to_lanes(a), ref_to_lanes(c))
    np.testing.assert_array_equal(lanes_to_ref(got), want)
    want_sub = np.asarray(ref.sub(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        lanes_to_ref(tf.sub(ref_to_lanes(a), ref_to_lanes(b))), want_sub)
    x = pf.field_for(R).encode_plain(rand_ints(42, R, N), "cpu")
    assert torch.equal(tf.from_mont(tf.to_mont(x)), x)


def test_tfield_cpu_is_plain_and_broadcasts_bls12_381():
    test_tfield_cpu_is_plain_and_broadcasts(BLS)


def test_plain_ops_on_stacked_operands(curve="bn254"):
    """The plain ops take (2W, k, N) stacks, as the batched group law does."""
    P = CURVES[curve].fp.modulus
    F = pf.field_for(P)
    xs, ys = rand_ints(50, P, 2 * N), rand_ints(51, P, 2 * N)
    K = F.n16
    a = pf.to16(F.encode(xs, "cpu")).reshape(K, 2, N)
    b = pf.to16(F.encode(ys, "cpu")).reshape(K, 2, N)
    got = pf.to32(F.mont_mul16(a, b).reshape(K, 2 * N))
    assert F.decode(got) == [x * y % P for x, y in zip(xs, ys)]


def test_plain_ops_on_stacked_operands_bls12_381():
    test_plain_ops_on_stacked_operands(BLS)


@pytest.mark.parametrize("curve", ["bn254", BLS])
def test_products_near_the_top_of_the_field(curve):
    """Operands at p − 1, p − 2 and (R − 1) mod p, whose products and sums
    carry into the top word, against Python ints."""
    for q in (CURVES[curve].fr.modulus, CURVES[curve].fp.modulus):
        F = pf.field_for(q)
        vals = [q - 1, q - 2, (F.R - 1) % q, F.R % q, q // 2, q // 2 + 1]
        a = F.encode([x for x in vals for _ in vals], "cpu")
        b = F.encode([y for _ in vals for y in vals], "cpu")
        pairs = [(x, y) for x in vals for y in vals]
        assert F.decode(F.mont_mul(a, b)) == [x * y % q for x, y in pairs]
        assert F.decode(F.add(a, b)) == [(x + y) % q for x, y in pairs]
        assert F.decode(F.sub(a, b)) == [(x - y) % q for x, y in pairs]
