"""gnark_icicle_tpu_torch — the PyTorch/CUDA port of gnark_icicle_tpu.

The device layer of the JAX package, rewritten on PyTorch with hand-written
CUDA kernels for an NVIDIA H100 (``csrc/``), for BN254, BLS12-381, and the
BLS12-377 → BW6-761 2-chain. It stands alone: it imports neither JAX nor
anything of ``gnark_icicle_tpu``, and holds its own copies of the JAX-free
host modules it needs (each names its source and is held to it by
tests/test_torch_copies.py).

Layout mirrors the reference package:
  frontend/   circuit DSL and R1CS compiler (copied)
  constraint/ R1CS IR, witness solver, hints (copied); native.py and
              csrc/solver.cc are the C++ solver core (copied)
  curves/     host field, tower, group and pairing oracles (copied)
  std/        the native 2-chain gadgets: BLS12-377 pairing and Groth16
              verifier inside a BW6-761 circuit (copied)
  ops/        field, NTT, group law, MSM and fixed-base kernels with their
              plain PyTorch twins
  device.py   per-curve device context
  backend/    Groth16 setup, prove, verify
Entry points run on the first CUDA card unless the caller passes
``device="cpu"``, which runs the plain versions.
"""
