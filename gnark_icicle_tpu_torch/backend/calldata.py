"""The arguments of the exported verifier contracts' ``verifyProof``.

``backend/solidity.py`` (Groth16) and ``backend/plonk_solidity.py`` (PLONK)
declare their calldata in their templates; these helpers lay a port proof
and its public inputs out in that order, as lists of uint256 words, one list
an argument (``SolidityContract.call(name, *args)``), and ``encode`` gives
the ABI bytes of those arguments (``SolidityContract.call_calldata``):

- Groth16: ``proof[8]`` = Ar, Bs (each Fp2 coordinate imaginary part first,
  the pairing precompile's order), Krs; a committed circuit's contract then
  takes ``commitments[2]`` and ``commitmentPok[2]``; then the inputs.
- PLONK: ``proof[25 + 3·nb_commitments]`` (plonk_solidity.py's layout: the
  nine points, the six claimed values, z(ωζ), each commitment's claimed
  value and then its point), then the inputs.
"""

from __future__ import annotations


def _xy(pt) -> list:
    return [0, 0] if pt is None else [pt[0], pt[1]]


def groth16_args(proof, public_inputs) -> list:
    """verifyProof's arguments for a Groth16 proof over BN254."""
    (bx, by) = proof.bs
    args = [_xy(proof.ar) + [bx.c1, bx.c0, by.c1, by.c0] + _xy(proof.krs)]
    if proof.commitments:
        if len(proof.commitments) > 1:
            raise NotImplementedError("the contract takes at most one commitment")
        args += [_xy(proof.commitments[0]), _xy(proof.commitment_pok)]
    return args + [list(public_inputs)]


def plonk_args(proof, public_inputs) -> list:
    """verifyProof's arguments for a PLONK proof over BN254."""
    words = []
    for pt in (*proof.lro, proof.z_com, *proof.h_coms, proof.batch_h, proof.z_shifted_h):
        words += _xy(pt)
    words += list(proof.batch_claimed[:6])
    words.append(proof.z_shifted_claimed)
    words += list(proof.batch_claimed[6:])
    for cm in proof.bsb22_commitments:
        words += _xy(cm)
    return [words, list(public_inputs)]


def encode(args) -> bytes:
    """The ABI encoding of static uint256 arrays: each word in 32 bytes,
    big-endian, the arguments one after another."""
    return b"".join(int(w).to_bytes(32, "big") for arg in args for w in arg)
