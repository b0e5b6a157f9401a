"""Selector/mux gadgets (≙ reference std/selector: Mux, Map, Slice helpers).

Copied from gnark_icicle_tpu/std/selector.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations


def mux(api, sel, *values):
    """values[sel], constraining sel ∈ [0, len(values)) (≙ selector.Mux).

    Indicator construction: ind_i = (sel == i) via is_zero; Σ ind_i == 1
    follows from Σ over the complete index range.
    """
    assert values
    indicators = [api.is_zero(api.sub(sel, i)) for i in range(len(values))]
    api.assert_is_equal(api.add(*indicators) if len(indicators) > 1
                        else indicators[0], 1)
    terms = [api.mul(ind, v) for ind, v in zip(indicators, values)]
    return terms[0] if len(terms) == 1 else api.add(*terms)


def map_lookup(api, query, keys, values):
    """Value whose key equals query; constrains exactly one match
    (≙ selector.Map)."""
    assert len(keys) == len(values) and keys
    indicators = [api.is_zero(api.sub(query, k)) for k in keys]
    api.assert_is_equal(api.add(*indicators) if len(indicators) > 1
                        else indicators[0], 1)
    terms = [api.mul(ind, v) for ind, v in zip(indicators, values)]
    return terms[0] if len(terms) == 1 else api.add(*terms)


def step_mask(api, length, max_len: int):
    """Indicator list: out[i] = 1 iff i < length (≙ selector.Partition's
    stepMask). length must be ≤ max_len."""
    n_bits = max(max_len.bit_length() + 2, 2)
    outs = []
    for i in range(max_len):
        gt = api.cmp(length, i, n_bits)  # 1 if length > i
        outs.append(api.is_zero(api.sub(gt, 1)))
    return outs
