"""Solidity verifier export for PLONK/BN254.

Role parity: reference backend/plonk/bn254/verify.go:400 ExportSolidity +
the embedded contract template (backend/plonk/bn254/solidity.go). The
emitted contract checks the gnark-shaped proof (backend/plonk/keys.py):

  1. replay the gnark-crypto Fiat-Shamir transcript byte-for-byte
     (backend/transcript.GnarkTranscript): challenge_i's digest =
     sha256(name ∥ prev_digest ∥ bindings), points bound as 64-byte
     uncompressed marshal, gamma binding the vk trace commitments
     (precomputed at export into VK_BLOB) + public inputs + LRO;
  2. check the claimed linearized-poly opening against −constLin;
  3. rebuild the linearized-polynomial digest with ecmul/ecadd
     precompiles, fold the batch opening with the KZG γ challenge
     (kzg.deriveGamma bytes), and run both KZG checks in ONE 4-pair
     pairing-precompile call: e(C−vG+zW, G₂)·e(−W, τG₂) per opening.

BN254 only (the EVM precompile curve). BSB22: like the reference's
template, the contract supports at most ONE commitment
(backend/plonk/bn254/solidity.go's single Qcp/commitment slot): the
commitment point is absorbed into the alpha challenge, hashed to fr with
the in-contract RFC 9380 expand_message_xmd (DST "BSB22-Plonk") and added
to PI(ζ) at the commitment's gate row, its claimed opening joins the
linearized digest and the batched KZG fold.

Proof calldata (25 + 3·nb_commitments words):
  a,b,c,z,h1,h2,h3,batchW,zShiftW as (x,y) pairs [0..17];
  claimed values lin,l,r,o,s1,s2 [18..23]; z(ωζ) [24];
  with a commitment: qcp(ζ) [25], commitment point (x,y) [26..27].

Copied from gnark_icicle_tpu/backend/plonk_solidity.py:1, so that the port
imports nothing of the JAX package; tests/test_torch_solidity.py holds its
text to the original's.
"""

from __future__ import annotations

from .plonk.keys import VerifyingKey

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Code generated by gnark-icicle-tpu DO NOT EDIT
pragma solidity ^0.8.0;

contract PlonkVerifier {{
    uint256 private constant P = {p};
    uint256 private constant R = {r};

    uint256 private constant N = {n};
    uint256 private constant NB_PUBLIC = {nb_public};
    uint256 private constant OMEGA = {omega};
    uint256 private constant K1 = {k1};
    uint256 private constant K2 = {k2};

    // [τ]2 and G2 generator (Fp2: imaginary part first, precompile ABI)
{g2_constants}

    // trace polynomial commitments: ql, qr, qm, qo, qk, s1, s2, s3
{vk_constants}

    error ProofInvalid();
    error PublicInputNotInField();

    // proof calldata layout (25 + 3*nb_commitments words):
    //   [0..17]  a,b,c,z,h1,h2,h3,batchW,zShiftW as (x,y) pairs
    //   [18..23] claimed openings at zeta: lin, l, r, o, s1, s2
    //   [24]     z(omega*zeta)
    //   [25]     qcp(zeta); [26..27] BSB22 commitment (when present)
    function verifyProof(
        uint256[{nb_words}] calldata proof,
        uint256[{nb_inputs_max1}] calldata input
    ) public view {{
        // ---- transcript replay (gnark-crypto fiat-shamir bytes) --------
        // gamma: sha256("gamma" || vk marshals || publics || a || b || c)
        bytes memory buf = abi.encodePacked("gamma", vkBlob());
        for (uint256 i = 0; i < NB_PUBLIC; i++) {{
            if (input[i] >= R) revert PublicInputNotInField();
            buf = abi.encodePacked(buf, bytes32(input[i]));
        }}
        buf = abi.encodePacked(buf,
            marshal(proof[0], proof[1]),
            marshal(proof[2], proof[3]),
            marshal(proof[4], proof[5]));
        bytes32 d = sha256(buf);
        uint256 gamma = uint256(d) % R;
        d = sha256(abi.encodePacked("beta", d));
        uint256 beta = uint256(d) % R;
        d = sha256(abi.encodePacked("alpha", d,{alpha_commit_bind}
            marshal(proof[6], proof[7])));
        uint256 alpha = uint256(d) % R;
        d = sha256(abi.encodePacked("zeta", d,
            marshal(proof[8], proof[9]),
            marshal(proof[10], proof[11]),
            marshal(proof[12], proof[13])));
        uint256 zeta = uint256(d) % R;

        uint256 zhZeta = addmod(expmod(zeta, N), R - 1, R);
        if (zhZeta == 0) revert ProofInvalid();

        // ---- PI(zeta) and the linearization constant -------------------
        uint256 pi = 0;
        {{
            uint256 wj = 1;
            for (uint256 j = 0; j < NB_PUBLIC; j++) {{
                // L_j(zeta) = wj*zhZeta / (N*(zeta-wj))
                uint256 den = mulmod(N, addmod(zeta, R - wj, R), R);
                uint256 lj = mulmod(mulmod(wj, zhZeta, R), inv(den), R);
                pi = addmod(pi, mulmod(input[j], lj, R), R);
                wj = mulmod(wj, OMEGA, R);
            }}
        }}{pi_commit}
        uint256 l1z = mulmod(zhZeta,
            inv(mulmod(N, addmod(zeta, R - 1, R), R)), R);
        uint256 a2l1 = mulmod(mulmod(alpha, alpha, R), l1z, R);
        // cprod = (l + beta*s1 + gamma)(r + beta*s2 + gamma)
        uint256 cprod = mulmod(
            addmod(addmod(proof[19], mulmod(beta, proof[22], R), R), gamma, R),
            addmod(addmod(proof[20], mulmod(beta, proof[23], R), R), gamma, R),
            R);
        {{
            // constLin = -(PI - a2l1 + alpha*cprod*(o+gamma)*zu)
            uint256 cl = mulmod(mulmod(cprod, addmod(proof[21], gamma, R), R),
                                mulmod(alpha, proof[24], R), R);
            cl = addmod(addmod(cl, R - a2l1, R), pi, R);
            if (addmod(proof[18], cl, R) != 0) revert ProofInvalid();
        }}

        // ---- linearized polynomial digest ------------------------------
        uint256[2] memory linD;
        {{
            uint256 s1c = mulmod(mulmod(cprod, beta, R),
                                 mulmod(alpha, proof[24], R), R);
            uint256 bz = mulmod(beta, zeta, R);
            uint256 idp = addmod(addmod(proof[19], bz, R), gamma, R);
            idp = mulmod(idp,
                addmod(addmod(proof[20], mulmod(bz, K1, R), R), gamma, R), R);
            idp = mulmod(idp,
                addmod(addmod(proof[21], mulmod(bz, K2, R), R), gamma, R), R);
            uint256 zc = addmod(a2l1, R - mulmod(alpha, idp, R), R);
            uint256 zn2 = expmod(zeta, N + 2);
            uint256 nzh = R - zhZeta;
            (linD[0], linD[1]) = (QK_X, QK_Y);
            linD = accMul(linD, QL_X, QL_Y, proof[19]);
            linD = accMul(linD, QR_X, QR_Y, proof[20]);
            linD = accMul(linD, QM_X, QM_Y, mulmod(proof[19], proof[20], R));
            linD = accMul(linD, QO_X, QO_Y, proof[21]);
            linD = accMul(linD, S3_X, S3_Y, s1c);
            linD = accMul(linD, proof[6], proof[7], zc);
            linD = accMul(linD, proof[8], proof[9], nzh);
            linD = accMul(linD, proof[10], proof[11], mulmod(nzh, zn2, R));
            linD = accMul(linD, proof[12], proof[13],
                          mulmod(mulmod(nzh, zn2, R), zn2, R));{lin_commit}
        }}

        // ---- KZG fold challenge (kzg.deriveGamma bytes) ----------------
        uint256 gkzg;
        {{
            bytes memory fb = abi.encodePacked("gamma", bytes32(zeta),
                marshal(linD[0], linD[1]),
                marshal(proof[0], proof[1]),
                marshal(proof[2], proof[3]),
                marshal(proof[4], proof[5]),
                marshal(S1_X, S1_Y),
                marshal(S2_X, S2_Y){fold_bytes_commit});
            fb = abi.encodePacked(fb,
                bytes32(proof[18]), bytes32(proof[19]), bytes32(proof[20]),
                bytes32(proof[21]), bytes32(proof[22]), bytes32(proof[23]),
                {fold_claims_tail});
            gkzg = uint256(sha256(fb)) % R;
        }}

        // ---- fold digests/claims; both KZG checks in one pairing call --
        uint256[2] memory foldC = [linD[0], linD[1]];
        uint256 foldV = proof[18];
        {{
            uint256 gi = gkzg;
            foldC = accMul(foldC, proof[0], proof[1], gi);
            foldV = addmod(foldV, mulmod(gi, proof[19], R), R);
            gi = mulmod(gi, gkzg, R);
            foldC = accMul(foldC, proof[2], proof[3], gi);
            foldV = addmod(foldV, mulmod(gi, proof[20], R), R);
            gi = mulmod(gi, gkzg, R);
            foldC = accMul(foldC, proof[4], proof[5], gi);
            foldV = addmod(foldV, mulmod(gi, proof[21], R), R);
            gi = mulmod(gi, gkzg, R);
            foldC = accMul(foldC, S1_X, S1_Y, gi);
            foldV = addmod(foldV, mulmod(gi, proof[22], R), R);
            gi = mulmod(gi, gkzg, R);
            foldC = accMul(foldC, S2_X, S2_Y, gi);
            foldV = addmod(foldV, mulmod(gi, proof[23], R), R);{fold_acc_commit}
        }}
        pairKzg(foldC, foldV, zeta, proof[14], proof[15],
                proof[6], proof[7], proof[24],
                mulmod(zeta, OMEGA, R), proof[16], proof[17]);
    }}

    // acc + s*(x,y) via precompiles (s may be 0; ecmul handles it)
    function accMul(uint256[2] memory acc, uint256 x, uint256 y, uint256 s)
        private view returns (uint256[2] memory)
    {{
        (uint256 tx_, uint256 ty_) = ecmul(x, y, s);
        (acc[0], acc[1]) = ecadd(acc[0], acc[1], tx_, ty_);
        return acc;
    }}

    // C - v*G + z*W accumulated, paired against G2; -W against tau*G2.
    function pairKzg(
        uint256[2] memory c1, uint256 v1, uint256 z1, uint256 w1x, uint256 w1y,
        uint256 c2x, uint256 c2y, uint256 v2, uint256 z2, uint256 w2x, uint256 w2y
    ) private view {{
        uint256[24] memory pairs;
        (pairs[0], pairs[1]) = kzgLeft(c1[0], c1[1], v1, z1, w1x, w1y);
        pairs[2] = G2_X1; pairs[3] = G2_X0; pairs[4] = G2_Y1; pairs[5] = G2_Y0;
        pairs[6] = w1x; pairs[7] = w1y == 0 ? 0 : P - w1y;
        pairs[8] = TAU_X1; pairs[9] = TAU_X0; pairs[10] = TAU_Y1; pairs[11] = TAU_Y0;
        (pairs[12], pairs[13]) = kzgLeft(c2x, c2y, v2, z2, w2x, w2y);
        pairs[14] = G2_X1; pairs[15] = G2_X0; pairs[16] = G2_Y1; pairs[17] = G2_Y0;
        pairs[18] = w2x; pairs[19] = w2y == 0 ? 0 : P - w2y;
        pairs[20] = TAU_X1; pairs[21] = TAU_X0; pairs[22] = TAU_Y1; pairs[23] = TAU_Y0;
        uint256[1] memory ok;
        assembly {{
            if iszero(staticcall(gas(), 8, pairs, 0x300, ok, 0x20)) {{
                revert(0, 0)
            }}
        }}
        if (ok[0] != 1) revert ProofInvalid();
    }}

    function kzgLeft(
        uint256 cx, uint256 cy, uint256 v, uint256 z, uint256 wx, uint256 wy
    ) private view returns (uint256, uint256) {{
        // C + (-v)*G + z*W
        (uint256 ax, uint256 ay) = ecmul(1, 2, v == 0 ? 0 : R - v);
        (uint256 bx, uint256 by) = ecmul(wx, wy, z);
        (ax, ay) = ecadd(cx, cy, ax, ay);
        return ecadd(ax, ay, bx, by);
    }}

    // gnark-crypto uncompressed marshal: X||Y, infinity = 0x40<<248 || 0
    function marshal(uint256 x, uint256 y)
        private pure returns (bytes memory)
    {{
        if (x == 0 && y == 0) {{
            return abi.encodePacked(bytes32(uint256(0x40) << 248), bytes32(0));
        }}
        return abi.encodePacked(bytes32(x), bytes32(y));
    }}

    // bindPublicData's constant prefix: marshal(s1,s2,s3,ql,qr,qm,qo,qk)
    function vkBlob() private pure returns (bytes memory) {{
        return abi.encodePacked(
            marshal(S1_X, S1_Y), marshal(S2_X, S2_Y), marshal(S3_X, S3_Y),
            marshal(QL_X, QL_Y), marshal(QR_X, QR_Y), marshal(QM_X, QM_Y),
            marshal(QO_X, QO_Y), marshal(QK_X, QK_Y){vkblob_commit});
    }}

    function ecmul(uint256 x, uint256 y, uint256 s)
        private view returns (uint256, uint256)
    {{
        uint256[3] memory input_ = [x, y, s];
        uint256[2] memory out;
        assembly {{
            if iszero(staticcall(gas(), 7, input_, 0x60, out, 0x40)) {{
                revert(0, 0)
            }}
        }}
        return (out[0], out[1]);
    }}

    function ecadd(uint256 ax, uint256 ay, uint256 bx, uint256 by)
        private view returns (uint256, uint256)
    {{
        uint256[4] memory input_ = [ax, ay, bx, by];
        uint256[2] memory out;
        assembly {{
            if iszero(staticcall(gas(), 6, input_, 0x80, out, 0x40)) {{
                revert(0, 0)
            }}
        }}
        return (out[0], out[1]);
    }}

    function expmod(uint256 base, uint256 e) private view returns (uint256) {{
        uint256[6] memory input_ = [32, 32, 32, base, e, R];
        uint256[1] memory out;
        assembly {{
            if iszero(staticcall(gas(), 5, input_, 0xC0, out, 0x20)) {{
                revert(0, 0)
            }}
        }}
        return out[0];
    }}

    function inv(uint256 x) private view returns (uint256) {{
        if (x == 0) revert ProofInvalid();
        return expmod(x, R - 2);
    }}
{hash_fr_fn}}}
"""

_HASH_FR_FN = '''
    // RFC 9380 expand_message_xmd(sha256, marshal(point), "BSB22-Plonk", 48)
    // then the 48-byte big-endian value mod R (== fr.Hash / hash_to_fr)
    function hashFr(uint256 x, uint256 y) private pure returns (uint256) {
        bytes memory dstp = abi.encodePacked("BSB22-Plonk", uint8(11));
        bytes32 b0 = sha256(abi.encodePacked(
            new bytes(64), marshal(x, y), uint16(48), uint8(0), dstp));
        bytes32 b1 = sha256(abi.encodePacked(b0, uint8(1), dstp));
        bytes32 b2 = sha256(abi.encodePacked(b0 ^ b1, uint8(2), dstp));
        return addmod(
            mulmod(uint256(b1),
                   0x100000000000000000000000000000000, R),
            uint256(b2) >> 128, R);
    }
'''


def export_plonk_solidity(vk: VerifyingKey, curve) -> str:
    """Render the PLONK verifier contract (≙ plonk vk ExportSolidity)."""
    if curve.name != "bn254":
        raise ValueError("Solidity export targets the EVM bn254 precompiles")
    nb_commit = len(vk.commitment_constraint_indexes)
    if nb_commit > 1:
        raise NotImplementedError(
            "PLONK Solidity export supports at most one BSB22 commitment "
            "(same bound as the reference template, solidity.go)"
        )
    r = curve.fr.modulus
    p = curve.fp.modulus
    n = 1 << vk.log_n

    def xy(pt):
        return (0, 0) if pt is None else pt

    def xy2(pt):
        x, y = pt
        return (x.c1, x.c0, y.c1, y.c0)

    gx1, gx0, gy1, gy0 = xy2(vk.g2_gen)
    tx1, tx0, ty1, ty0 = xy2(vk.g2_tau)
    g2_consts = "\n".join([
        f"    uint256 private constant G2_X1 = {gx1};",
        f"    uint256 private constant G2_X0 = {gx0};",
        f"    uint256 private constant G2_Y1 = {gy1};",
        f"    uint256 private constant G2_Y0 = {gy0};",
        f"    uint256 private constant TAU_X1 = {tx1};",
        f"    uint256 private constant TAU_X0 = {tx0};",
        f"    uint256 private constant TAU_Y1 = {ty1};",
        f"    uint256 private constant TAU_Y0 = {ty0};",
    ])
    vk_consts = []
    for name in ("ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3"):
        x, y = xy(vk.commitments[name])
        up = name.upper()
        vk_consts.append(f"    uint256 private constant {up}_X = {x};")
        vk_consts.append(f"    uint256 private constant {up}_Y = {y};")

    # ---- BSB22 single-commitment hooks ------------------------------------
    if nb_commit:
        ci = vk.commitment_constraint_indexes[0]
        qx, qy = xy(vk.commitments["qcp0"])
        vk_consts.append(f"    uint256 private constant QCP_X = {qx};")
        vk_consts.append(f"    uint256 private constant QCP_Y = {qy};")
        vk_consts.append(
            "    // omega^commitment_gate_row for L_ci(zeta) in PI"
        )
        vk_consts.append(
            f"    uint256 private constant WPOW_CI = {pow(vk.omega, ci, r)};"
        )
        alpha_commit_bind = "\n            marshal(proof[26], proof[27]),"
        pi_commit = """
        {
            // BSB22: PI += hash_fr(commitment) * L_ci(zeta)
            uint256 hc = hashFr(proof[26], proof[27]);
            uint256 den = mulmod(N, addmod(zeta, R - WPOW_CI, R), R);
            uint256 lci = mulmod(mulmod(WPOW_CI, zhZeta, R), inv(den), R);
            pi = addmod(pi, mulmod(hc, lci, R), R);
        }"""
        lin_commit = ("\n            "
                      "linD = accMul(linD, proof[26], proof[27], proof[25]);")
        fold_bytes_commit = ",\n                marshal(QCP_X, QCP_Y)"
        fold_claims_tail = "bytes32(proof[25]), bytes32(proof[24])"
        fold_acc_commit = """
            gi = mulmod(gi, gkzg, R);
            foldC = accMul(foldC, QCP_X, QCP_Y, gi);
            foldV = addmod(foldV, mulmod(gi, proof[25], R), R);"""
        vkblob_commit = ",\n            marshal(QCP_X, QCP_Y)"
        hash_fr_fn = _HASH_FR_FN
        nb_words = 28
    else:
        alpha_commit_bind = ""
        pi_commit = ""
        lin_commit = ""
        fold_bytes_commit = ""
        fold_claims_tail = "bytes32(proof[24])"
        fold_acc_commit = ""
        vkblob_commit = ""
        hash_fr_fn = ""
        nb_words = 25

    return _TEMPLATE.format(
        p=p, r=r, n=n, nb_public=vk.nb_public, omega=vk.omega,
        k1=vk.k1, k2=vk.k2,
        g2_constants=g2_consts, vk_constants="\n".join(vk_consts),
        nb_inputs_max1=max(vk.nb_public, 1),
        nb_words=nb_words,
        alpha_commit_bind=alpha_commit_bind,
        pi_commit=pi_commit,
        lin_commit=lin_commit,
        fold_bytes_commit=fold_bytes_commit,
        fold_claims_tail=fold_claims_tail,
        fold_acc_commit=fold_acc_commit,
        vkblob_commit=vkblob_commit,
        hash_fr_fn=hash_fr_fn,
    )
