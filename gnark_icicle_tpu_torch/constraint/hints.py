"""Hint registry: named host callables the solver runs mid-solve.

Role parity: gnark's solver hint registry (reference:
constraint/solver/hint_registry.go:22 RegisterHint keyed by an ID derived
from the function name; constraint/solver/hint.go:96 defines
``Hint func(mod *big.Int, inputs, outputs []*big.Int) error``).

A hint is ``fn(q: int, inputs: list[int]) -> list[int]`` — pure host code
computing witness values that the constraint system then *verifies* (hints
are advice, not trusted computation). IDs are stable across processes (FNV-1a
of the qualified name, matching the reference's scheme in spirit) so compiled
circuits serialize/deserialize against the registry.

Copied from gnark_icicle_tpu/constraint/hints.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from typing import Callable

Hint = Callable[[int, list], list]

_REGISTRY: dict[int, Hint] = {}
_NAMES: dict[int, str] = {}


def hint_id(name: str) -> int:
    """FNV-1a 64-bit of the hint name (stable across runs/processes)."""
    h = 0xCBF29CE484222325
    for b in name.encode():
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def register_hint(fn: Hint, name: str | None = None) -> int:
    name = name or f"{fn.__module__}.{fn.__qualname__}"
    hid = hint_id(name)
    if hid in _REGISTRY and _REGISTRY[hid] is not fn:
        raise ValueError(f"hint id collision for {name!r}")
    _REGISTRY[hid] = fn
    _NAMES[hid] = name
    return hid


def get_hint(hid: int) -> Hint:
    if hid not in _REGISTRY:
        raise KeyError(f"hint {hid:#x} ({_NAMES.get(hid, '?')}) not registered")
    return _REGISTRY[hid]


def hint_name(hid: int) -> str:
    return _NAMES.get(hid, f"{hid:#x}")


# ---------------------------------------------------------------------------
# built-in hints (≙ gnark's std/internal hints the core API depends on)
# ---------------------------------------------------------------------------

def inv_or_zero_hint(q: int, inputs: list) -> list:
    """x -> 1/x (0 -> 0). Backs IsZero (reference: frontend/cs/r1cs/api.go
    IsZero uses the inverse hint pattern)."""
    x = inputs[0] % q
    return [0 if x == 0 else pow(x, -1, q)]


def to_bits_hint(q: int, inputs: list) -> list:
    """x, n -> n little-endian bits. Backs ToBinary (≙ bits.NBits hint)."""
    x = inputs[0] % q
    n = inputs[1]
    return [(x >> i) & 1 for i in range(n)]


def div_unchecked_hint(q: int, inputs: list) -> list:
    """(a, b) -> a/b with 0/0 = 0 (≙ the DivUnchecked solver hint)."""
    a, b = inputs[0] % q, inputs[1] % q
    if b == 0:
        return [0]  # the out·b == a check constraint rejects a != 0
    return [a * pow(b, -1, q) % q]


def randomize_hint(q: int, inputs: list) -> list:
    """Fresh random field element — the hiding mask appended to every
    commitment's committed set (≙ hints.Randomize via builder.Commit,
    reference: frontend/cs/r1cs/api.go Commit's mask block)."""
    import secrets

    return [secrets.randbelow(q - 1) + 1]


def bsb22_placeholder_hint(q: int, inputs: list) -> list:
    """Commitment wire placeholder, replaced by the prover's real Pedersen
    commitment at prove time (≙ cs.Bsb22CommitmentComputePlaceholder,
    reference: frontend/cs/commitment.go:15-29).

    Outside Prove (engine runs, solver-only tests) it returns a nonzero
    value derived deterministically from the committed inputs so solving
    succeeds — as the reference does under `go test` — but such a "proof"
    is NOT sound; groth16.prove always overrides this hint.
    """
    from ..backend.hash_to_field import hash_to_fr

    msg = b"".join(int(v % q).to_bytes(32, "big") for v in inputs)
    v = hash_to_fr(msg, b"bsb22-placeholder", q)[0]
    return [v if v != 0 else 1]


INV_OR_ZERO = register_hint(inv_or_zero_hint, "core.inv_or_zero")
TO_BITS = register_hint(to_bits_hint, "core.to_bits")
DIV_UNCHECKED = register_hint(div_unchecked_hint, "core.div_unchecked")
RANDOMIZE = register_hint(randomize_hint, "core.randomize")
BSB22_PLACEHOLDER = register_hint(
    bsb22_placeholder_hint, "core.bsb22_commitment_placeholder"
)
