"""Bit-slice partitioning of a variable.

Role parity: reference std/math/bitslice (partition.go Partition — split v at
bit position `split` into (lower, upper) with both halves range-checked so
v = lower + 2^split · upper holds without overlap).

Copied from gnark_icicle_tpu/std/bitslice.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from ..constraint import hints as hintlib


def _partition_hint(q, inputs):
    """(v, split) -> (lower, upper)."""
    v, split = inputs[0] % q, int(inputs[1])
    return [v & ((1 << split) - 1), v >> split]


PARTITION = hintlib.register_hint(_partition_hint, "bitslice.partition")


def partition(api, v, split: int, nb_digits: int | None = None):
    """(lower, upper) with v == lower + 2^split·upper, lower < 2^split,
    upper < 2^(nb_digits − split) (≙ bitslice.Partition).

    nb_digits defaults to the field bit length − 1 (the widest v for which
    the recomposition cannot wrap).
    """
    if nb_digits is None:
        nb_digits = api.q.bit_length() - 1
    assert 0 <= split <= nb_digits
    if split == 0:
        api.to_binary(v, nb_digits)  # pure range check of upper = v
        return 0, v
    if split == nb_digits:
        api.to_binary(v, nb_digits)
        return v, 0
    lower, upper = api.new_hint(PARTITION, 2, v, static_args=(split,))
    api.to_binary(lower, split)
    api.to_binary(upper, nb_digits - split)
    api.assert_is_equal(
        api.add(lower, api.mul(upper, 1 << split)), v
    )
    return lower, upper
