"""SHA-3 / Keccak-256 sponge gadgets over the keccak-f[1600] permutation.

Role parity: reference std/hash/sha3 (sha3.go — sponge absorb/pad/squeeze
for the FIPS-202 variants plus LegacyKeccak256, over std/permutation/
keccakf). Bytes are in-circuit values constrained to 8 bits; digests come
out as 8-bit byte variables (≙ the reference's uints.U8 stream).

Copied from gnark_icicle_tpu/std/hash/sha3.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from ..math_bits import UWord
from .keccakf import keccakf


class _Sponge:
    def __init__(self, api, rate_bytes: int, ds_byte: int, out_bytes: int):
        self.api = api
        self.rate = rate_bytes
        self.ds = ds_byte
        self.out_bytes = out_bytes

    def hash(self, data_bytes: list) -> list:
        """data_bytes: circuit vars (each < 256) -> out_bytes digest vars."""
        api = self.api
        # pad10*1 with the domain-separator byte (FIPS-202 §B.2)
        msg = list(data_bytes)
        pad_len = self.rate - (len(msg) % self.rate)
        padding = [0] * pad_len
        padding[0] = self.ds
        padding[-1] = (padding[-1] if pad_len > 1 else self.ds) | 0x80
        if pad_len == 1:
            padding[0] = self.ds | 0x80
        msg = msg + padding

        lanes = [UWord.constant(api, 0, 64) for _ in range(25)]
        for block in range(0, len(msg), self.rate):
            chunk = msg[block : block + self.rate]
            for i in range(self.rate // 8):
                # little-endian byte packing into the lane
                bits = []
                for b in range(8):
                    v = chunk[i * 8 + b]
                    w = (UWord.constant(api, int(v), 8)
                         if isinstance(v, int)
                         else UWord.from_var(api, v, 8))
                    bits.extend(w.bits)
                lanes[i] = lanes[i].xor(UWord(api, bits))
            lanes = keccakf(api, lanes)

        out = []
        produced = 0
        while produced < self.out_bytes:
            take = min(self.rate, self.out_bytes - produced)
            for i in range(take):
                lane = lanes[i // 8]
                byte_bits = lane.bits[(i % 8) * 8 : (i % 8) * 8 + 8]
                acc = api.add(
                    0, *[api.mul(b, 1 << k) for k, b in enumerate(byte_bits)]
                ) if byte_bits else 0
                out.append(acc)
            produced += take
            if produced < self.out_bytes:
                lanes = keccakf(api, lanes)
        return out


def sha3_256(api, data_bytes: list) -> list:
    """FIPS-202 SHA3-256 (rate 136, DS 0x06)."""
    return _Sponge(api, 136, 0x06, 32).hash(data_bytes)


def sha3_512(api, data_bytes: list) -> list:
    return _Sponge(api, 72, 0x06, 64).hash(data_bytes)


def keccak256(api, data_bytes: list) -> list:
    """Pre-FIPS Keccak-256 (DS 0x01) — the EVM hash
    (≙ sha3.NewLegacyKeccak256)."""
    return _Sponge(api, 136, 0x01, 32).hash(data_bytes)
