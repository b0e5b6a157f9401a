"""Shared helpers of the port's tests (tests/test_torch_*.py), and their
own checks.

Inputs are made from numpy seeds and handed to both packages; the JAX side
runs on the CPU, as the JAX package's own tests run it. This module imports
only the port at its top: tests/test_torch_cuda.py, which runs on a machine
without JAX, uses it too. The helpers that reach the JAX package import it
where they are called.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnark_icicle_tpu_torch.curves import bls12_377, bls12_381, bn254, bw6_761
from gnark_icicle_tpu_torch.ops.field import (
    repack16_to_32, repack32_to_16, from_lanes, to_lanes,
)

P, R = bn254.P, bn254.R
CURVE = bn254.BN254
# the port's curves by test id; the JAX package's twins come from ref_curve
CURVES = {"bn254": bn254.BN254, "bls12_381": bls12_381.BLS12_381,
          "bls12_377": bls12_377.BLS12_377, "bw6_761": bw6_761.BW6_761}

# The test run shares the machine among several worker processes: one
# intra-op thread keeps the plain PyTorch paths from oversubscribing it.
torch.set_num_threads(1)


def ref_curve(name: str):
    """The JAX package's curve object of a test id."""
    from gnark_icicle_tpu.curves import bls12_377, bls12_381, bn254, bw6_761

    return {"bn254": bn254.BN254, "bls12_381": bls12_381.BLS12_381,
            "bls12_377": bls12_377.BLS12_377, "bw6_761": bw6_761.BW6_761}[name]


def g2_over_fp2(curve) -> bool:
    """True where G2 lies over Fp2; BW6-761's lies over Fp."""
    return hasattr(curve.g2.b, "c0")


def rand_ints(seed: int, q: int, n: int, edge: bool = True) -> list:
    """n field elements from a numpy seed, led by 0, 1 and q − 1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, -(-q.bit_length() // 32)),
                         dtype=np.uint64)
    vals = [int.from_bytes(r.astype("<u4").tobytes(), "little") % q
            for r in words]
    if edge:
        vals[:3] = [0, 1, q - 1][:n]
    return vals


def edge_scalars(r: int, n: int, seed: int) -> list:
    """n scalars below r for the fixed-base comb: 0, 1, r − 1, powers of two
    (the top bit's too), all ones below the top bit, runs of all-ones
    windows of 3-8 bits, then random ones from a numpy seed."""
    bits = r.bit_length()
    vals = [0, 1, r - 1, 2, 1 << 64, 1 << (bits - 1), (1 << (bits - 1)) - 1]
    vals += [((1 << (8 * w)) - 1) << (3 * w) for w in range(3, 9)]
    return vals + rand_ints(seed, r, n - len(vals), edge=False)


def ref_to_lanes(x_n16, device="cpu") -> torch.Tensor:
    """Reference (N, 2W) 16-bit limbs -> the port's (W, N) int32 tensor."""
    return to_lanes(repack16_to_32(np.asarray(x_n16)), device)


def lanes_to_ref(t: torch.Tensor) -> np.ndarray:
    """The port's (W, N) tensor -> reference (N, 2W) int32 16-bit limbs."""
    return repack32_to_16(from_lanes(t))


def public_fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if not f.name.startswith("_")}


def to_reference(obj, ref_curve_obj):
    """A port key or proof as the JAX package's class of the same name, with
    every G2 coordinate as the JAX package's Fp2 (the port's own Fp2 compares
    equal to it, but the JAX verifier should get its own objects). BW6-761's
    G2 coordinates are ints and stay as they are."""
    from gnark_icicle_tpu.backend.groth16 import keys as ref_keys
    from gnark_icicle_tpu.curves.tower import Fp2

    tp = getattr(ref_curve_obj, "tower", None)

    def conv(v):
        if hasattr(v, "c0"):
            return Fp2(tp, v.c0, v.c1)
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    ref_cls = getattr(ref_keys, type(obj).__name__)
    return ref_cls(**{k: conv(v) for k, v in public_fields(obj).items()})


@pytest.fixture
def cuda_device():
    """The first CUDA card; the test skips where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_rand_ints_are_canonical_and_seeded():
    a = rand_ints(3, R, 50)
    assert a == rand_ints(3, R, 50)
    assert a[:3] == [0, 1, R - 1]
    assert all(0 <= v < R for v in a)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_rand_ints_cover_the_modulus_width(name):
    q = CURVES[name].fp.modulus
    a = rand_ints(4, q, 200)
    assert all(0 <= v < q for v in a)
    assert max(a).bit_length() == q.bit_length()
