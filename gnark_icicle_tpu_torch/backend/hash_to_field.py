"""RFC 9380 hash-to-field over the scalar field (SHA-256 based).

Role parity: gnark-crypto's ``fr.Hash`` / ``hash_to_field`` package as used
by the Groth16 BSB22 commitment scheme (reference:
backend/groth16/bn254/prove.go:66-68 ``hash_to_field.New([]byte(
constraint.CommitmentDst))`` and verify.go:54-56) — expand_message_xmd with
SHA-256, L = 16 + field bytes per element, output reduced mod r.

The default DST is gnark's ``constraint.CommitmentDst`` = "bsb22-commitment"
(reference: constraint/commitment.go:7); the PoK-folding challenge uses
"G16-BSB22" (prove.go:133).

Copied from gnark_icicle_tpu/backend/hash_to_field.py:1, so that the port
imports nothing of the JAX package; tests/test_torch_copies.py holds it to
the original.
"""

from __future__ import annotations

import hashlib

COMMITMENT_DST = b"bsb22-commitment"
G16_FOLD_DST = b"G16-BSB22"
MIMC_COMMITMENT_TAG = b"bsb22-mimc"


def evm_commitment_hash(hash_name: str, modulus: int, point,
                        committed_values) -> int:
    """EVM-friendly BSB22 commitment hash-to-field: the PLAIN digest
    uint256(H(abi.encodePacked(C.x, C.y, committed...))) % r, matching
    what the reference's exported Solidity verifier computes in-contract
    (backend/groth16/bn254/solidity.go:716-724 — `hashFnName(...)  % R`;
    the proof must be produced with the same override, verify.go:154-180
    ExportSolidity's sha256/keccak256 requirement)."""
    import hashlib

    x, y = (0, 0) if point is None else (int(point[0]), int(point[1]))
    data = x.to_bytes(32, "big") + y.to_bytes(32, "big") + b"".join(
        (int(v) % modulus).to_bytes(32, "big") for v in committed_values
    )
    if hash_name == "sha256":
        d = hashlib.sha256(data).digest()
    elif hash_name == "keccak256":
        from ..std.hash.mimc import keccak256

        d = keccak256(data)
    else:
        raise ValueError(f"unsupported EVM hash {hash_name!r}")
    return int.from_bytes(d, "big") % modulus


def mimc_commitment_hash(outer_modulus: int, inner_r: int, inner_fp: int,
                         point, committed_values) -> int:
    """Recursion-friendly BSB22 commitment hash-to-field.

    Role parity: the reference swaps the SHA-based hash for a MiMC "short
    hash" over the OUTER circuit's native field when an inner proof is
    destined for recursion (std/recursion/wrapped_hash.go NewShort(current,
    target) installed via backend.WithProverHashToFieldFunction;
    std/recursion/groth16/verifier.go:632-656 replays it in-circuit).

    This repo's convention (field-element based, mirrored exactly by the
    recursion verifiers — no gnark fixtures exist to pin the byte format):

      MiMC over `outer_modulus` absorbing
        tag("bsb22-mimc"),
        C.x, C.y      — directly when inner Fp fits the outer field
                        (the native 2-chain), else as little-endian
                        64-bit limbs (the emulated point witness's limbs),
        committed v_i — directly when inner r fits, else as 64-bit limbs;
      digest truncated to its low min(|r|, |outer|) − 1 bits so the value
      always fits the inner scalar field (≙ NewShort's byte-short cut).

    `point` is an affine host tuple (None = infinity → absorbed as zeros).
    """
    from ..std.hash.mimc import MiMCHost

    h = MiMCHost(outer_modulus)
    h.write(int.from_bytes(MIMC_COMMITMENT_TAG, "big") % outer_modulus)

    def absorb(value: int, modulus: int):
        if modulus <= outer_modulus:
            h.write(value)
        else:
            k = (modulus.bit_length() + 63) // 64
            v = int(value)
            h.write(*(((v >> (64 * i)) & ((1 << 64) - 1)) for i in range(k)))

    x, y = (0, 0) if point is None else (int(point[0]), int(point[1]))
    absorb(x, inner_fp)
    absorb(y, inner_fp)
    for v in committed_values:
        absorb(int(v) % inner_r, inner_r)
    out_bits = min(inner_r.bit_length(), outer_modulus.bit_length()) - 1
    return h.h & ((1 << out_bits) - 1)


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    h = hashlib.sha256
    b_in_bytes = 32
    r_in_bytes = 64  # sha256 block size
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd: parameters out of range")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(r_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = h(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = h(b0 + b"\x01" + dst_prime).digest()
    uniform = b1
    prev = b1
    for i in range(2, ell + 1):
        prev = h(bytes(x ^ y for x, y in zip(b0, prev))
                 + bytes([i]) + dst_prime).digest()
        uniform += prev
    return uniform[:len_in_bytes]


def hash_to_fr(msg: bytes, dst: bytes, modulus: int, count: int = 1) -> list:
    """count field elements from msg (≙ gnark-crypto fr.Hash).

    L = 16 + ceil(bits/8) bytes per element (128-bit security margin),
    big-endian interpreted and reduced mod the field modulus.
    """
    nb = (modulus.bit_length() + 7) // 8
    L = 16 + nb
    uniform = expand_message_xmd(msg, dst, count * L)
    return [
        int.from_bytes(uniform[i * L:(i + 1) * L], "big") % modulus
        for i in range(count)
    ]


def serialize_commitment(point_bytes: bytes, public_committed: list,
                         field_byte_len: int) -> bytes:
    """point marshal ‖ committed public values, fixed-width big-endian
    (≙ constraint.SerializeCommitment, constraint/commitment.go:77-89)."""
    out = bytearray(point_bytes)
    for v in public_committed:
        out += int(v).to_bytes(field_byte_len, "big")
    return bytes(out)
