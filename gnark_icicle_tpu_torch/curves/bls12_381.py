"""BLS12-381 parameters — the second field/curve instantiation.

Parity target: gnark's bls12-381 backend (doc.go:29); used here for the
PLONK+KZG second-curve configuration (BASELINE.md "Second instantiation").

Copied from gnark_icicle_tpu/curves/bls12_381.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .field import PrimeField
from .tower import TowerParams, Fp2
from .ec import ECGroup, FpOps, Fp2Ops

# BLS parameter (negative): |x| below, x < 0
X_SEED = -0xD201000000010000

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

FP = PrimeField("bls12-381.fp", P, two_adicity=1, multiplicative_generator=2)
FR = PrimeField("bls12-381.fr", R, two_adicity=32, multiplicative_generator=7)

# Tower: Fp2 = Fp[u]/(u²+1); Fp6 = Fp2[v]/(v³-(1+u)); Fp12 = Fp6[w]/(w²-v)
TOWER = TowerParams(p=P, beta=-1, xi=(1, 1))

_fp = FpOps(P)
_fp2 = Fp2Ops(TOWER)

G1_GEN = (
    3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
    1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
)
G2_GEN = (
    Fp2(
        TOWER,
        352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
        3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
    ),
    Fp2(
        TOWER,
        1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
        927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
    ),
)

G1 = ECGroup(_fp, 4, G1_GEN, R, name="bls12-381.g1")
# M-twist: y² = x³ + 4(1+u)
G2_B = Fp2(TOWER, 4, 4)
G2 = ECGroup(_fp2, G2_B, G2_GEN, R, name="bls12-381.g2")


@dataclass(frozen=True)
class CurveBLS12381:
    name: str = "bls12-381"
    fp: PrimeField = FP
    fr: PrimeField = FR
    tower: TowerParams = TOWER
    g1: ECGroup = dc_field(default_factory=lambda: G1)
    g2: ECGroup = dc_field(default_factory=lambda: G2)
    x_seed: int = X_SEED

    def pairing(self, pairs):
        from .pairing import pairing_check_bls12_381

        return pairing_check_bls12_381(pairs)

    def miller_and_final_exp(self, p_list, q_list):
        from .pairing import multi_pairing_bls12_381

        return multi_pairing_bls12_381(p_list, q_list)


BLS12_381 = CurveBLS12381()
