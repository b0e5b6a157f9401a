"""Gadget standard library (≙ reference std/ — SURVEY.md §2.5): the port
carries the native 2-chain gadgets; the emulated-field layer with the EVM
precompile circuits (emulated, sw_emulated, rangecheck, logderivlookup,
multicommit, math_cmp, math_bits, ecdsa, pairing_bn254, evmprecompiles,
hash/sha2); and the rollup and hashing gadgets with the interactive-proof
verifiers (eddsa over curves/twisted_edwards, merkle, selector, bitslice,
hash/keccakf, hash/sha3, fiat_shamir, polynomial, sumcheck, gkr, fri,
compress_lzss), copied from gnark_icicle_tpu/std/. Still to copy: the
recursion verifiers (recursion/groth16, plonk, native_plonk), the emulated
pairings (pairing_bls12_381, pairing_bw6_761) and kzg_gadget."""
