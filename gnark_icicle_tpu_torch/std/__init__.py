"""Gadget standard library (≙ reference std/ — SURVEY.md §2.5): the port
carries the native 2-chain gadgets and the emulated-field layer with the EVM
precompile circuits (emulated, sw_emulated, rangecheck, logderivlookup,
multicommit, math_cmp, math_bits, ecdsa, pairing_bn254, evmprecompiles,
hash/sha2), copied from gnark_icicle_tpu/std/."""
