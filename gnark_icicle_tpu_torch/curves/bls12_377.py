"""BLS12-377 parameters — the inner curve of the native 2-chain.

Parity target: gnark's bls12-377 backend + std/algebra/native/sw_bls12377
(the curve whose Fp embeds in BW6-761's Fr, making in-circuit verification
of BLS12-377 proofs native-cheap inside a BW6-761 circuit — the reference's
2-chain recursion, std/algebra/native/doc.go).

Every constant here was DERIVED and verified offline by
tools/derive_2chain.py: p/r from the BLS12 polynomial parametrization of
the seed, curve orders from the Frobenius trace, generators checked
on-curve and order-r (they match the canonical gnark-crypto/arkworks
values), and the twist constant b' = 1/u cross-checked against the value
documented in the reference (std/algebra/native/sw_bls12377/pairing2.go:381).

Copied from gnark_icicle_tpu/curves/bls12_377.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .field import PrimeField
from .tower import TowerParams, Fp2
from .ec import ECGroup, FpOps, Fp2Ops

# BLS parameter (positive seed): r = x⁴−x²+1, p = (x−1)²·r/3 + x, t = x+1
X_SEED = 0x8508C00000000001

P = 258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177
R = 8444461749428370424248824938781546531375899335154063827935233455917409239041

assert R == X_SEED**4 - X_SEED**2 + 1
assert P == ((X_SEED - 1) ** 2 * R) // 3 + X_SEED

FP = PrimeField("bls12-377.fp", P, two_adicity=46, multiplicative_generator=15)
FR = PrimeField("bls12-377.fr", R, two_adicity=47, multiplicative_generator=22)

# Tower: Fp2 = Fp[u]/(u²+5); Fp6 = Fp2[v]/(v³−u); Fp12 = Fp6[w]/(w²−v)
TOWER = TowerParams(p=P, beta=-5, xi=(0, 1))

_fp = FpOps(P)
_fp2 = Fp2Ops(TOWER)

# canonical generators (verified on-curve + order r by tools/derive_2chain.py)
G1_GEN = (
    81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
)
G2_GEN = (
    Fp2(
        TOWER,
        233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
        140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118,
    ),
    Fp2(
        TOWER,
        63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
        149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491,
    ),
)

G1 = ECGroup(_fp, 1, G1_GEN, R, name="bls12-377.g1")
# D-twist: y² = x³ + 1/u  (b' = b/ξ, ξ = u; 1/u = −u/5)
G2_B = Fp2(TOWER, 0, (-pow(5, -1, P)) % P)
G2 = ECGroup(_fp2, G2_B, G2_GEN, R, name="bls12-377.g2")

# cofactors (derive_2chain.py: h1 = (p+1−t)/r; h2 = #E'(Fp2)/r)
H1 = (P + 1 - (X_SEED + 1)) // R
assert H1 == 30631250834960419227450344600217059328


@dataclass(frozen=True)
class CurveBLS12377:
    name: str = "bls12-377"
    fp: PrimeField = FP
    fr: PrimeField = FR
    tower: TowerParams = TOWER
    g1: ECGroup = dc_field(default_factory=lambda: G1)
    g2: ECGroup = dc_field(default_factory=lambda: G2)
    x_seed: int = X_SEED

    def pairing(self, pairs):
        from .pairing import pairing_check_bls12_377

        return pairing_check_bls12_377(pairs)

    def miller_and_final_exp(self, p_list, q_list):
        from .pairing import multi_pairing_bls12_377

        return multi_pairing_bls12_377(p_list, q_list)


BLS12_377 = CurveBLS12377()
