"""Solidity verifier export for Groth16/BN254.

Role parity: reference backend/groth16/bn254/verify.go:154 ExportSolidity +
the embedded contract template (backend/groth16/bn254/solidity.go). Emits a
self-contained contract using the EVM pairing precompile (0x08) with the VK
baked in as constants — the standard on-chain Groth16 check
e(−A,B)·e(α,β)·e(kSum,γ)·e(C,δ) == 1. BN254 is the only EVM-precompile
curve, as in the reference.

Copied from gnark_icicle_tpu/backend/solidity.py:1, so that the port
imports nothing of the JAX package; tests/test_torch_solidity.py holds its
text to the original's.
"""

from __future__ import annotations

from .groth16.keys import VerifyingKey

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Code generated by gnark-icicle-tpu DO NOT EDIT
pragma solidity ^0.8.0;

contract Verifier {{
    uint256 private constant Q = {p};
    uint256 private constant R = {r};

    // [α]1
    uint256 private constant ALPHA_X = {alpha_x};
    uint256 private constant ALPHA_Y = {alpha_y};
    // [β]2, [γ]2, [δ]2 (Fp2: imaginary part first, per precompile ABI)
    uint256 private constant BETA_X1 = {beta_x1};
    uint256 private constant BETA_X0 = {beta_x0};
    uint256 private constant BETA_Y1 = {beta_y1};
    uint256 private constant BETA_Y0 = {beta_y0};
    uint256 private constant GAMMA_X1 = {gamma_x1};
    uint256 private constant GAMMA_X0 = {gamma_x0};
    uint256 private constant GAMMA_Y1 = {gamma_y1};
    uint256 private constant GAMMA_Y0 = {gamma_y0};
    uint256 private constant DELTA_X1 = {delta_x1};
    uint256 private constant DELTA_X0 = {delta_x0};
    uint256 private constant DELTA_Y1 = {delta_y1};
    uint256 private constant DELTA_Y0 = {delta_y0};

    // [Kᵢ]1 — public-input commitments ({nb_k} points)
{k_constants}

    error ProofInvalid();
    error PublicInputNotInField();

    /// verify a Groth16 proof: proof = (Ar.x, Ar.y, Bs.x1, Bs.x0, Bs.y1,
    /// Bs.y0, Krs.x, Krs.y); input = the {nb_inputs} public inputs.
    function verifyProof(
        uint256[8] calldata proof,
        uint256[{nb_inputs}] calldata input
    ) public view {{
        // kSum = K0 + Σ inputᵢ·K(i+1)  via ecadd/ecmul precompiles
        uint256[2] memory kSum;
        kSum[0] = K_X(0);
        kSum[1] = K_Y(0);
        for (uint256 i = 0; i < {nb_inputs}; i++) {{
            if (input[i] >= R) revert PublicInputNotInField();
            uint256[3] memory mulIn = [K_X(i + 1), K_Y(i + 1), input[i]];
            uint256[2] memory mulOut;
            assembly {{
                if iszero(staticcall(gas(), 7, mulIn, 0x60, mulOut, 0x40)) {{
                    revert(0, 0)
                }}
            }}
            uint256[4] memory addIn =
                [kSum[0], kSum[1], mulOut[0], mulOut[1]];
            assembly {{
                if iszero(staticcall(gas(), 6, addIn, 0x80, kSum, 0x40)) {{
                    revert(0, 0)
                }}
            }}
        }}

        // pairing check e(-A,B)·e(α,β)·e(kSum,γ)·e(C,δ) == 1
        uint256[24] memory pairs;
        pairs[0] = proof[0];
        pairs[1] = (Q - (proof[1] % Q)) % Q; // -A
        pairs[2] = proof[2];
        pairs[3] = proof[3];
        pairs[4] = proof[4];
        pairs[5] = proof[5];
        pairs[6] = ALPHA_X;
        pairs[7] = ALPHA_Y;
        pairs[8] = BETA_X1;
        pairs[9] = BETA_X0;
        pairs[10] = BETA_Y1;
        pairs[11] = BETA_Y0;
        pairs[12] = kSum[0];
        pairs[13] = kSum[1];
        pairs[14] = GAMMA_X1;
        pairs[15] = GAMMA_X0;
        pairs[16] = GAMMA_Y1;
        pairs[17] = GAMMA_Y0;
        pairs[18] = proof[6];
        pairs[19] = proof[7];
        pairs[20] = DELTA_X1;
        pairs[21] = DELTA_X0;
        pairs[22] = DELTA_Y1;
        pairs[23] = DELTA_Y0;
        uint256[1] memory ok;
        assembly {{
            if iszero(staticcall(gas(), 8, pairs, 0x300, ok, 0x20)) {{
                revert(0, 0)
            }}
        }}
        if (ok[0] != 1) revert ProofInvalid();
    }}

{k_accessors}
}}
"""


_TEMPLATE_COMMIT = """\
// SPDX-License-Identifier: MIT
// Code generated by gnark-icicle-tpu DO NOT EDIT
pragma solidity ^0.8.0;

contract Verifier {{
    uint256 private constant Q = {p};
    uint256 private constant R = {r};

    // [α]1
    uint256 private constant ALPHA_X = {alpha_x};
    uint256 private constant ALPHA_Y = {alpha_y};
    // [β]2, [γ]2, [δ]2 (Fp2: imaginary part first, per precompile ABI)
    uint256 private constant BETA_X1 = {beta_x1};
    uint256 private constant BETA_X0 = {beta_x0};
    uint256 private constant BETA_Y1 = {beta_y1};
    uint256 private constant BETA_Y0 = {beta_y0};
    uint256 private constant GAMMA_X1 = {gamma_x1};
    uint256 private constant GAMMA_X0 = {gamma_x0};
    uint256 private constant GAMMA_Y1 = {gamma_y1};
    uint256 private constant GAMMA_Y0 = {gamma_y0};
    uint256 private constant DELTA_X1 = {delta_x1};
    uint256 private constant DELTA_X0 = {delta_x0};
    uint256 private constant DELTA_Y1 = {delta_y1};
    uint256 private constant DELTA_Y0 = {delta_y0};
    // Pedersen commitment key (≙ PEDERSEN_G / PEDERSEN_GSIGMANEG,
    // reference solidity.go:149-160)
    uint256 private constant PEDERSEN_G_X1 = {ped_g_x1};
    uint256 private constant PEDERSEN_G_X0 = {ped_g_x0};
    uint256 private constant PEDERSEN_G_Y1 = {ped_g_y1};
    uint256 private constant PEDERSEN_G_Y0 = {ped_g_y0};
    uint256 private constant PEDERSEN_GSN_X1 = {ped_gsn_x1};
    uint256 private constant PEDERSEN_GSN_X0 = {ped_gsn_x0};
    uint256 private constant PEDERSEN_GSN_Y1 = {ped_gsn_y1};
    uint256 private constant PEDERSEN_GSN_Y0 = {ped_gsn_y0};

    // [Kᵢ]1 — public-input + commitment-wire points ({nb_k} points)
{k_constants}

    error ProofInvalid();
    error CommitmentInvalid();
    error PublicInputNotInField();

    /// verify a Groth16 proof with one BSB22 commitment
    /// (≙ the reference's commitment-carrying verifyProof,
    /// solidity.go:680-760): proof = (Ar.x, Ar.y, Bs.x1, Bs.x0, Bs.y1,
    /// Bs.y0, Krs.x, Krs.y); commitments/commitmentPok = the proof's
    /// Pedersen commitment and folded knowledge proof; input = the
    /// {nb_inputs} public inputs. The proof must be produced with
    /// commitment_hash=("evm", "{hash_fn}").
    function verifyProof(
        uint256[8] calldata proof,
        uint256[2] calldata commitments,
        uint256[2] calldata commitmentPok,
        uint256[{nb_inputs}] calldata input
    ) public view {{
        // HashToField: the commitment wire value
        // (≙ solidity.go:716-724 — plain digest % R)
        bytes memory hbuf = abi.encodePacked(
            bytes32(commitments[0]), bytes32(commitments[1]){committed_binds});
        uint256 pc = uint256({hash_fn}(hbuf)) % R;

        // Pedersen PoK: e(C, -σG₂)·e(π, G₂) == 1  (≙ solidity.go:727-748)
        uint256[12] memory pp;
        pp[0] = commitments[0];
        pp[1] = commitments[1];
        pp[2] = PEDERSEN_GSN_X1;
        pp[3] = PEDERSEN_GSN_X0;
        pp[4] = PEDERSEN_GSN_Y1;
        pp[5] = PEDERSEN_GSN_Y0;
        pp[6] = commitmentPok[0];
        pp[7] = commitmentPok[1];
        pp[8] = PEDERSEN_G_X1;
        pp[9] = PEDERSEN_G_X0;
        pp[10] = PEDERSEN_G_Y1;
        pp[11] = PEDERSEN_G_Y0;
        uint256[1] memory pok;
        assembly {{
            if iszero(staticcall(gas(), 8, pp, 0x180, pok, 0x20)) {{
                revert(0, 0)
            }}
        }}
        if (pok[0] != 1) revert CommitmentInvalid();

        // kSum = K0 + Σ inputᵢ·K(i+1) + pc·K({cm_k_idx}) + C
        uint256[2] memory kSum;
        kSum[0] = K_X(0);
        kSum[1] = K_Y(0);
        for (uint256 i = 0; i < {nb_inputs}; i++) {{
            if (input[i] >= R) revert PublicInputNotInField();
            uint256[3] memory mulIn = [K_X(i + 1), K_Y(i + 1), input[i]];
            uint256[2] memory mulOut;
            assembly {{
                if iszero(staticcall(gas(), 7, mulIn, 0x60, mulOut, 0x40)) {{
                    revert(0, 0)
                }}
            }}
            uint256[4] memory addIn =
                [kSum[0], kSum[1], mulOut[0], mulOut[1]];
            assembly {{
                if iszero(staticcall(gas(), 6, addIn, 0x80, kSum, 0x40)) {{
                    revert(0, 0)
                }}
            }}
        }}
        uint256[3] memory mulIn2 = [K_X({cm_k_idx}), K_Y({cm_k_idx}), pc];
        uint256[2] memory mulOut2;
        assembly {{
            if iszero(staticcall(gas(), 7, mulIn2, 0x60, mulOut2, 0x40)) {{
                revert(0, 0)
            }}
        }}
        uint256[4] memory addIn2 =
            [kSum[0], kSum[1], mulOut2[0], mulOut2[1]];
        assembly {{
            if iszero(staticcall(gas(), 6, addIn2, 0x80, kSum, 0x40)) {{
                revert(0, 0)
            }}
        }}
        uint256[4] memory addIn3 =
            [kSum[0], kSum[1], commitments[0], commitments[1]];
        assembly {{
            if iszero(staticcall(gas(), 6, addIn3, 0x80, kSum, 0x40)) {{
                revert(0, 0)
            }}
        }}

        // pairing check e(-A,B)·e(α,β)·e(kSum,γ)·e(C,δ) == 1
        uint256[24] memory pairs;
        pairs[0] = proof[0];
        pairs[1] = (Q - (proof[1] % Q)) % Q; // -A
        pairs[2] = proof[2];
        pairs[3] = proof[3];
        pairs[4] = proof[4];
        pairs[5] = proof[5];
        pairs[6] = ALPHA_X;
        pairs[7] = ALPHA_Y;
        pairs[8] = BETA_X1;
        pairs[9] = BETA_X0;
        pairs[10] = BETA_Y1;
        pairs[11] = BETA_Y0;
        pairs[12] = kSum[0];
        pairs[13] = kSum[1];
        pairs[14] = GAMMA_X1;
        pairs[15] = GAMMA_X0;
        pairs[16] = GAMMA_Y1;
        pairs[17] = GAMMA_Y0;
        pairs[18] = proof[6];
        pairs[19] = proof[7];
        pairs[20] = DELTA_X1;
        pairs[21] = DELTA_X0;
        pairs[22] = DELTA_Y1;
        pairs[23] = DELTA_Y0;
        uint256[1] memory ok;
        assembly {{
            if iszero(staticcall(gas(), 8, pairs, 0x300, ok, 0x20)) {{
                revert(0, 0)
            }}
        }}
        if (ok[0] != 1) revert ProofInvalid();
    }}

{k_accessors}
}}
"""


def export_solidity(vk: VerifyingKey, curve, hash_fn: str = "sha256") -> str:
    """Render the verifier contract for a BN254 VK (≙ vk.ExportSolidity).

    Commitment VKs (api.commit circuits) render the commitment-carrying
    contract; their proofs MUST be produced with
    ``commitment_hash=("evm", hash_fn)`` — the contract recomputes the
    commitment wire with that plain hash in-contract (the reference has
    the same requirement, verify.go:154-180)."""
    if curve.name != "bn254":
        raise ValueError("Solidity export targets the EVM bn254 precompiles")
    if len(vk.commitment_keys) > 1:
        raise NotImplementedError(
            "Solidity export supports at most one commitment"
        )
    if hash_fn not in ("sha256", "keccak256"):
        raise ValueError("hash_fn must be sha256 or keccak256")

    def xy(pt):
        if pt is None:
            return (0, 0)
        return pt

    def xy2(pt):
        x, y = pt
        return (x.c1, x.c0, y.c1, y.c0)

    k_consts = []
    k_access_x = []
    k_access_y = []
    for i, pt in enumerate(vk.g1_k):
        x, y = xy(pt)
        k_consts.append(f"    uint256 private constant K{i}_X = {x};")
        k_consts.append(f"    uint256 private constant K{i}_Y = {y};")
        k_access_x.append(f"        if (i == {i}) return K{i}_X;")
        k_access_y.append(f"        if (i == {i}) return K{i}_Y;")

    accessors = (
        "    function K_X(uint256 i) private pure returns (uint256) {\n"
        + "\n".join(k_access_x)
        + "\n        revert();\n    }\n\n"
        "    function K_Y(uint256 i) private pure returns (uint256) {\n"
        + "\n".join(k_access_y)
        + "\n        revert();\n    }"
    )

    ax, ay = xy(vk.g1_alpha)
    bx1, bx0, by1, by0 = xy2(vk.g2_beta)
    gx1, gx0, gy1, gy0 = xy2(vk.g2_gamma)
    dx1, dx0, dy1, dy0 = xy2(vk.g2_delta)
    common = dict(
        p=curve.fp.modulus, r=curve.fr.modulus,
        alpha_x=ax, alpha_y=ay,
        beta_x1=bx1, beta_x0=bx0, beta_y1=by1, beta_y0=by0,
        gamma_x1=gx1, gamma_x0=gx0, gamma_y1=gy1, gamma_y0=gy0,
        delta_x1=dx1, delta_x0=dx0, delta_y1=dy1, delta_y0=dy0,
        nb_k=len(vk.g1_k), nb_inputs=vk.nb_public - 1,
        k_constants="\n".join(k_consts), k_accessors=accessors,
    )
    if not vk.commitment_keys:
        return _TEMPLATE.format(**common)

    ck = vk.commitment_keys[0]
    pg_x1, pg_x0, pg_y1, pg_y0 = xy2(ck.g)
    pn_x1, pn_x0, pn_y1, pn_y0 = xy2(ck.g_sigma_neg)
    binds = []
    for j in vk.public_and_commitment_committed[0]:
        if j == 0:
            binds.append(", bytes32(uint256(1))")  # the ONE wire
        elif j < vk.nb_public:
            binds.append(f", bytes32(input[{j - 1}])")
        else:
            raise NotImplementedError(
                "committed commitment wires need >1 commitment"
            )
    return _TEMPLATE_COMMIT.format(
        **common,
        ped_g_x1=pg_x1, ped_g_x0=pg_x0, ped_g_y1=pg_y1, ped_g_y0=pg_y0,
        ped_gsn_x1=pn_x1, ped_gsn_x0=pn_x0,
        ped_gsn_y1=pn_y1, ped_gsn_y0=pn_y0,
        hash_fn=hash_fn,
        committed_binds="".join(binds),
        cm_k_idx=vk.nb_public,
    )
