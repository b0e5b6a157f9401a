"""BN254 (alt_bn128) parameters — the reference's primary curve.

Parity target: gnark-crypto's bn254 package as used throughout the
reference gnark (doc.go:27 lists BN254 first; the ICICLE acceleration is
BN254-only, README.md:163-172).

Copied from gnark_icicle_tpu/curves/bn254.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .field import PrimeField
from .tower import TowerParams, Fp2
from .ec import ECGroup, FpOps, Fp2Ops

# BN parameter x: p = 36x⁴+36x³+24x²+6x+1, r = 36x⁴+36x³+18x²+6x+1
X_SEED = 4965661367192848881

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

FP = PrimeField("bn254.fp", P, two_adicity=1, multiplicative_generator=3)
FR = PrimeField("bn254.fr", R, two_adicity=28, multiplicative_generator=5)

# Tower: Fp2 = Fp[u]/(u²+1); Fp6 = Fp2[v]/(v³-(9+u)); Fp12 = Fp6[w]/(w²-v)
TOWER = TowerParams(p=P, beta=-1, xi=(9, 1))

_fp = FpOps(P)
_fp2 = Fp2Ops(TOWER)

G1_GEN = (1, 2)
G2_GEN = (
    Fp2(
        TOWER,
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    Fp2(
        TOWER,
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

G1 = ECGroup(_fp, 3, G1_GEN, R, name="bn254.g1")
# twist: y² = x³ + 3/(9+u)  (D-twist)
G2_B = Fp2(TOWER, 3, 0) * Fp2(TOWER, 9, 1).inv()
G2 = ECGroup(_fp2, G2_B, G2_GEN, R, name="bn254.g2")


@dataclass(frozen=True)
class CurveBN254:
    name: str = "bn254"
    fp: PrimeField = FP
    fr: PrimeField = FR
    tower: TowerParams = TOWER
    g1: ECGroup = dc_field(default_factory=lambda: G1)
    g2: ECGroup = dc_field(default_factory=lambda: G2)
    x_seed: int = X_SEED

    def pairing(self, pairs):
        from .pairing import pairing_check_bn254

        return pairing_check_bn254(pairs)

    def miller_and_final_exp(self, p_list, q_list):
        from .pairing import multi_pairing_bn254

        return multi_pairing_bn254(p_list, q_list)


BN254 = CurveBN254()
