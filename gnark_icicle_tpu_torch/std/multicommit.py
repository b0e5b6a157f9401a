"""Commitment expansion: many independent in-circuit randomness draws from
one api.commit.

Role parity: reference std/multicommit (nativecommit.go — collect all
variables callbacks want committed, defer a single Commit over the union,
then hand each callback a distinct power of the master commitment as its
unique randomness).

Copied from gnark_icicle_tpu/std/multicommit.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_emulated.py holds it to the original.
"""

from __future__ import annotations

from ..frontend.compile import defer_circuit


class _Multicommitter:
    def __init__(self):
        self.vars = []
        self.cbs = []
        self.closed = False


def _get(api) -> _Multicommitter:
    mc = getattr(api, "_multicommitter", None)
    if mc is None:
        mc = _Multicommitter()
        api._multicommitter = mc
        defer_circuit(api, _finalize)
    return mc


def _finalize(api):
    mc = api._multicommitter
    mc.closed = True
    if not mc.cbs:
        return
    cmt = api.commit(*mc.vars)
    # derive per-callback randomness as successive powers (≙ nativecommit.go
    # commitAndCall: cmts[i] = cmt^(i+1))
    current = cmt
    for cb in mc.cbs:
        cb(api, current)
        current = api.mul(current, cmt)


def with_commitment(api, callback, *vs):
    """Register callback(api, commitment) to run after define with a unique
    commitment binding (at least) vs (≙ multicommit.WithCommitment)."""
    mc = _get(api)
    if mc.closed:
        raise RuntimeError(
            "multicommit already finalized (WithCommitment after deferred "
            "finalization)"
        )
    mc.vars.extend(vs)
    mc.cbs.append(callback)
