"""In-circuit proof verification — recursion gadgets (≙ reference
std/recursion). The port carries the native 2-chain Groth16 verifier
(``native_groth16``), copied from gnark_icicle_tpu/std/recursion/; the
emulated verifiers of the original package are not ported."""
