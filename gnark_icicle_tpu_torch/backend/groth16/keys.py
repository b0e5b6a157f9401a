"""Groth16 key and proof objects.

Copied from gnark_icicle_tpu/backend/groth16/keys.py (:16-88): that module
cannot be imported without JAX, because its package ``__init__`` imports the
JAX prover. Points are host affine (None = infinity). The proving key's
device staging is cached per device after first use.

``from_reference`` builds a key or proof from any object with the same
public fields (the JAX package's, in the tests), reading them by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields


def _public_fields(cls):
    return [f.name for f in fields(cls) if not f.name.startswith("_")]


class _Carry:
    """from_reference over the public dataclass fields."""

    @classmethod
    def from_reference(cls, obj):
        return cls(**{k: getattr(obj, k) for k in _public_fields(cls)})


@dataclass
class ProvingKey(_Carry):
    # group elements (host affine)
    g1_alpha: tuple
    g1_beta: tuple
    g1_delta: tuple
    g2_beta: tuple
    g2_delta: tuple
    # per-wire QAP evaluations in G1/G2 (length = nb_wires; None for wires
    # absent from the corresponding matrix — the MSM masks infinity)
    g1_a: list
    g1_b: list
    g2_b: list
    # [(β·A_k + α·B_k + C_k)/δ]₁ for private wires (index = wire - nb_public)
    g1_k: list
    # [τ^i · Z(τ)/δ]₁, i < n-1, stored in BIT-REVERSED index order so the
    # prover's h (bit-reversed out of the coset INTT) pairs positionally
    g1_z: list
    domain_log_n: int = 0
    # per-commitment Pedersen proving keys (BSB22)
    commitment_keys: list = field(default_factory=list)
    _device: dict = field(default_factory=dict, repr=False)

    def device_arrays(self, ctx):
        """Upload-once device staging of all MSM point tables on ctx.device;
        "pedersen" holds, per commitment, its basis and σ·basis stacked
        (2·N rows; None where it commits no private wire), the table of the
        commitment and proof-of-knowledge ``msm_batch``
        (``prove._pedersen_msms``)."""
        if ctx.device not in self._device:
            self._device[ctx.device] = {
                "a": ctx.g1_points(self.g1_a),
                "b1": ctx.g1_points(self.g1_b),
                "b2": ctx.g2_points(self.g2_b),
                "k": ctx.g1_points(self.g1_k),
                "z": ctx.g1_points(self.g1_z),
                "pedersen": [ctx.g1_points(ck.basis + ck.basis_exp_sigma) if ck.basis
                             else None for ck in self.commitment_keys],
            }
        return self._device[ctx.device]


@dataclass
class VerifyingKey(_Carry):
    g1_alpha: tuple
    g2_beta: tuple
    g2_gamma: tuple
    g2_delta: tuple
    # [(β·A_k + α·B_k + C_k)/γ]₁ for public wires (index = wire id),
    # followed by one point per commitment wire
    g1_k: list
    nb_public: int = 0
    commitment_keys: list = field(default_factory=list)
    # per commitment: indices into the extended public witness
    public_and_commitment_committed: list = field(default_factory=list)
    _e_alpha_beta: object = field(default=None, repr=False)

    def e_alpha_beta(self, curve):
        """Precomputed e(α, β)."""
        if self._e_alpha_beta is None:
            self._e_alpha_beta = curve.miller_and_final_exp(
                [self.g1_alpha], [self.g2_beta]
            )
        return self._e_alpha_beta


@dataclass
class Proof(_Carry):
    ar: tuple  # G1
    krs: tuple  # G1
    bs: tuple  # G2
    # BSB22: one Pedersen commitment per api.commit + one folded proof of
    # knowledge
    commitments: list = field(default_factory=list)
    commitment_pok: tuple = None
