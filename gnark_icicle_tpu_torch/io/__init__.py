"""Serialization in gnark/gnark-crypto wire formats (≙ reference io/ +
per-curve marshal.go + backend/witness binary protocol).

The exports of gnark_icicle_tpu/io/__init__.py, over the port's copies."""

from .serialize import (
    g1_to_bytes,
    g1_from_bytes,
    g2_to_bytes,
    g2_from_bytes,
    proof_to_bytes,
    proof_from_bytes,
    vk_to_bytes,
    vk_from_bytes,
    witness_to_bytes,
    witness_from_bytes,
)

__all__ = [
    "g1_to_bytes",
    "g1_from_bytes",
    "g2_to_bytes",
    "g2_from_bytes",
    "proof_to_bytes",
    "proof_from_bytes",
    "vk_to_bytes",
    "vk_from_bytes",
    "witness_to_bytes",
    "witness_from_bytes",
]
