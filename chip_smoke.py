#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gnark_icicle_tpu_torch) on one GPU.

    python3 chip_smoke.py

For each curve the port covers, BN254 (Fp at 8 32-bit words), BLS12-381 and
BLS12-377 (Fp at 12; BLS12-377's Fp2 has u^2 = -5) and BW6-761 (Fp at 24, Fr
at 12, G2 over Fp), phases print one JSON line each on stdout:
  1. build: compile every (CUDA source, curve) pair in
     gnark_icicle_tpu_torch/csrc/ (BW6-761 builds no g2.cu), all nvcc
     processes at once, and report each one's seconds and ptxas's registers
     and spills; phases 2 and 3 of a curve start as soon as its libraries
     are in place, while nvcc builds the others' (the curves in the order
     their builds end); the circuits of phases 4,
     plonk and bsb22 are compiled (host Python, a spawned, niced process
     each) while nvcc and then phases 2 and 3 run, each R1CS solved once
     there, so that its solver schedule (about 25 s at 2^17) is built with
     it and not by its first prove (the line "circuits" says when they were
     done);
  2. kernels: each kernel entry against its plain PyTorch version on the
     card, bit-equal (Fr product, subtraction and addition at 2^16 lanes;
     PLONK's quotient at 2^16 rows, every input holding 0, 1, p - 1, p - 2
     and values near R, and again, timed, at the 4n rows of the curve's
     PLONK path, as fr_add is; the batch inversion of the quotient's
     tables at 2^16 + 37 lanes with those edges, zeros at the first and the
     last lane of threads, a thread all zeros and threads of fewer than k
     lanes, then timed at the 4n rows (BN254's fr_add, quotient and
     inversion also at the 2^20 rows of phase rollup's keccak256); the NTT
     passes on the path's own domains, computeH's 2^18 coset (BW6-761:
     2^16; BN254 also ecrecover's and the rollup's 2^20) and PLONK's 4n
     coset (2^19 on BN254 and BLS12-381, 2^12 on the others; BN254 also
     keccak256's 2^20), each pass with the
     scalings it carries there, and each whole transform, timed beside its
     bound;
     G1 and G2 masked signed mixed add, add and double at 2^14 lanes, with
     operands at 0, 1, p - 1, p - 2 and near R; the bucket accumulation on
     the lanes of a skewed 2^12-point MSM, whose long runs are split, the
     folded segments held to the unsplit runs in affine form; the bucket
     reduction's running sums and combine and Horner with edge
     coordinates, identity buckets and a window with one bucket used; Horner
     also over M_BATCH = 3 problems, one all identity), then
     again at the shapes its curve's path gives it (the 2^17 Chain prove,
     the reduction at W = 17, B = 2^15; for BW6-761 the outer proof of the
     2-chain, W = 33, B = 2^11 and W = 36, B = 2^10; the first of them
     also over the M_BATCH problems of a batched prove, M·W windows, Horner
     one warp a problem, and G1's bucket accumulation at the batched
     prove's A/B1/K batch of three padded wire tables), with CUDA-event times
     there (the kernel's by _cuda_ms: the launches queued behind a spin
     wait, so that the card runs them back to back, each on its own copy of
     the inputs where they would fit the L2 cache (_rotating); the plain
     version's, its one run against which the kernel is checked), ptxas's
     registers and spills of the Fr kernels, and the least time the card
     could take (bound_ms), and
     Horner's time per double; *_add is timed at the fold's
     width and *_double at one lane; the one-step mixed
     add also with the mask a prefix of the lanes, as the reference's
     waves run; setup's fixed-base comb (*_fixed_base at ops/fixed_base.py WINDOW)
     and its normalization (*_normalize) at 2^12 scalars (0, 1, r - 1,
     powers of two, all-ones windows; 24 lanes against the host product),
     then timed at the path's batch widths (the Chain's 656,677 G1 and
     131,512 G2 scalars; BW6-761's 173,101 and 35,856). BW6-761's G2 runs
     its G1 entries with G2's b3 and is checked so (its comb and
     normalization also timed);
  3. msm: G1 and G2 MSMs (2^12 and 2^10 points; BW6-761 2^10 and 2^10)
     against the host oracle of the port's curves/, in affine form, and a
     skewed G1 MSM (scalars mostly 0 and 1) whose digit-1 run is longer than
     a lane takes, so that the MSM splits it; then msm_batch of three
     problems on G1 and G2, with one table shared by them and one a
     problem (one skewed problem split), each problem equal to its own msm
     call and the host oracle, and the batch one launch set;
  4. groth16: the 2^17-step Chain circuit (bench.py's rollup-scale
     benchmark) on BN254, BLS12-381 and BLS12-377: compile, setup
     (host/points split), a first prove, one timed prove with solve /
     computeH / MSM phase times, one prove under torch.profiler (device busy
     share, device time by kernel); the port's verifier accepts the proof
     and rejects a tampered public input. The kernels' launch counts are set
     to 0 just before setup and read just after the last prove: every entry
     of the curve ran but *_double and *_add_mixed_masked (no caller on the
     path), *_add (the fold of split buckets, which the Chain has not) and
     fr_sub (computeH's pointwise rides the coset INTT's first pass),
     each of setup's two fixed-base batches took one *_fixed_base and one
     *_normalize launch (setup's log gives the points phase's split: comb
     table, encoding, comb, normalization, decode),
     each MSM took at most three reduction and Horner launches, each
     transform the passes of pass_split (at most three), and the warm
     proves built no domain table and launched fr_mont_mul at most 6 times
     a prove;
  2chain: the BW6-761 outer proof that phase 4's BLS12-377 proof verifies
     (gnark's native 2-chain): the in-circuit Groth16 verifier of std/
     compiled over BW6-761's r (BLS12-377's p), then setup, a first prove,
     one timed prove and a profiled one on the card, verify, and the inner
     public input + 1 rejected; launch counts as in phase 4, *_add included
     (its MSMs split the top windows' buckets), and setup's G1 batch and its
     G2 batch over Fp both on the g1 entries (two *_fixed_base, two
     *_normalize); then the committed 2-chain (the in-circuit BSB22 branch):
     phase bsb22's BLS12-377 proof made with ("mimc", BW6-761's r), its
     commitment and proof of knowledge among the outer circuit's secrets
     (the commitment wire re-derived with the MiMC gadget, the Pedersen
     proof of knowledge checked by a pairing): compile, setup, a first and
     a warm prove on the card, verify, the inner public input + 1 rejected
     by the verifier and a commitment coordinate + 1 refused by the prover
     (the outer system unsatisfied); its constraints, compile and prove
     seconds;
  plonk: the port's PLONK (KZG commitments on the G1 MSM, the 4n coset
     transforms, the fused quotient) on each curve's SCS Chain
     (bench.py:359 bench_plonk): 2^17 gates on BN254 and BLS12-381 (a 2^19
     coset), 2^10 on BLS12-377 and BW6-761: setup (SRS, host and commit
     split), a first prove, one timed prove with their stage times (solve,
     round-1 commits, Z, quotient, linearization and openings), one under
     torch.profiler, verify and a tampered public input rejected; the
     path's launches as above, with fr_add, fr_sub, fr_batch_inv and
     plonk_quotient on it, the SRS as one *_fixed_base and one *_normalize
     launch, no g2_* entry, and the quotient's tables built once, by the
     first prove (timed, "quotient_tables"), with one fr_batch_inv, one
     fr_sub and at most 42 fr_mont_mul launches;
  Each path of phases 4, 2chain and plonk ends with one warm prove with
     batch_msm=True under the timed prove's rng: the proof must be
     the same, and its G1 MSMs fewer launch sets (the Chain's A, B1 and K
     one msm_batch, Z alone; PLONK's round-1 and round-3 commits one each);
     its stage times, peak device bytes and launches are printed;
  bsb22: the Chain of 2^15 with one api.commit (over the secret input
     and two intermediate values) on BN254 and BLS12-381, through Groth16
     and PLONK with the "sha256" commitment hash: setup, a first and a warm
     prove, verify, a tampered commitment, proof of knowledge and public
     input rejected, the Pedersen commit and proof of knowledge timed; and
     BLS12-377 Groth16 with ("mimc", BW6-761's r) on a small Chain;
  checkpoint: BN254's Chain Groth16 and PLONK provers with checkpoint_dir in
     a temporary directory: a fresh prove, a resume after deleting the last
     stage and a full resume, each under the rng of an uninterrupted prove
     of the path: each equals it and verifies; the seconds saved;
  deploy: the exported Solidity verifiers (backend/solidity.py,
     backend/plonk_solidity.py) run in the port's EVM interpreter (evm.py,
     the precompiles 0x05-0x08 over the port's curves) on BN254 proofs made
     on the card: phase 4's Chain 2^17 Groth16 proof, phase plonk's 2^17
     proof, phase bsb22's committed Groth16 key proved once more with the
     EVM commitment hash ("evm", "keccak256") under a contract exported
     with hash_fn="keccak256", and phase bsb22's PLONK proof; each contract
     accepts its proof's calldata and raises Revert (nothing else) on a
     proof word + 1, the public input + 1 and a commitment's x + 1; each
     contract's source bytes and each call's seconds;
  ceremony: Groth16's MPC ceremony (host code, as gnark's mpcsetup) for
     BN254's Chain at a 2^8 domain, in the second process, which runs it
     once nvcc is done, while phases 2 and 3 hold the card: Phase1.init,
     two contributions, verify; Phase2.init, two contributions, verify,
     finalize; after the lane's paths, the keys read from their bytes, a
     prove on the card, verify, and the exported Groth16 contract, which
     accepts the proof and reverts on each tamper; each step's seconds;
  service: BN254's Chain (Groth16) and 2^17 SCS Chain (PLONK) served from
     gnark's formats: each system written as gnark's .r1cs/.scs and read
     back in its compile worker while nvcc and phase 2 run (encode(decode(bytes)) the
     bytes, the same columns; the R1CS solved again there, to the same
     wires, so that its schedule comes back with it); Groth16's proving key
     of phase 4 (uncompressed) and both vks through their bytes; a resident
     Groth16Prover/PlonkProver on the card, its first prove timed; three and
     two requests, each witness and proof through their bytes, verified
     against the read vk, the first byte-equal to the path's timed prove,
     each request's launches equal to that prove's, the last under
     profile.device_trace and annotate (the trace holds the region and as
     many launches of each kernel as the counts say; its device ms by
     kernel), a proof with one flipped bit refused; DeviceCtx's build and
     cached lookup timed; BLS12-381's and BLS12-377's proofs and vks of
     phases 4 and plonk through their bytes and verified again;
  precompiles: the zkEVM precompile circuits over the emulated-field layer
     (std/emulated.py's deferred mulcheck, rangecheck and logderivlookup
     under one multicommit api.commit), in a third process
     (_lane) started with the run: while nvcc and phases 2 and
     3 run, EcRecover (0x01, the circuit of
     tests/test_evmprecompiles_compiled.py, copied) compiled with the port's
     gadgets (867,307 constraints, 710,886 privately committed wires),
     solved once on a signature of the port's curves/secp256k1.py and
     refused by the solver with the key of priv + 1, and EcAdd (0x06)
     compiled with the SCS builder (17,527 gates); once phases 2 and 3 are
     done, on the card: EcRecover through Groth16 (a 2^20 domain): setup
     (its host/points split), a first prove, a warm prove under
     torch.profiler (stage times, launches and device ms by kernel, busy
     share, peak device bytes), its two Pedersen MSMs one msm_batch and
     one launch set, the commitment and proof of knowledge equal to the
     host pedersen's (by linearity from setup's scalars), verify, and Ar
     doubled, the commitment + G and the proof of knowledge + G rejected;
     EcAdd through PLONK (a 2^15 domain, one BSB22 commitment): setup, a
     first and a warm prove, the warm one under torch.profiler (as the
     rollup's paths: _lane_prove), verify, the commitment + G rejected.
     ``python3 chip_smoke.py precompiles`` runs the build and this phase
     alone;
  rollup: the rollup and hashing gadgets (std/eddsa.py over
     curves/twisted_edwards.py, std/merkle.py's MiMC paths,
     std/hash/keccakf.py under sha3.py) on BN254, in a fourth process
     (_lane) started with the run: while nvcc and phases 2 and 3
     run, gnark's rollup (examples/rollup.py's TransferCircuit, copied) as
     RollupBatch, 8 transfers on a depth-24 account tree chained through
     secret roots (637,208 constraints), compiled, its witness built by the
     example's operator on a sparse tree (16 funded accounts, every other
     leaf zero, one hash of an empty subtree a level; held to
     MerkleTreeHost at depth 8, root and proofs, before and after an
     update), solved once, and refused by the solver with one signature's
     s + 1 and with an overdraft; keccak256 of 64 secret bytes (a Solidity
     mapping slot's preimage, key ‖ slot) against a public digest from the
     host keccak256, compiled with the SCS builder (229,712 gates),
     solved, and a wrong digest refused by the solver; once phases 2 and 3
     are done, on the card: RollupBatch through Groth16 (a 2^20 domain)
     and keccak256 through PLONK (a 2^18 domain, its quotient on 2^20
     rows), each with setup (its split), a first prove and a warm prove
     under torch.profiler (stage times, launches, device ms by kernel,
     busy share, peak device bytes), verify, and the tampers rejected
     (root_after + 1 and Ar doubled; a changed digest byte). ``python3
     chip_smoke.py rollup`` runs the build and this phase alone;
  recursion: the recursion verifiers (std/recursion/groth16.py, plonk.py,
     native_plonk.py, std/kzg_gadget.py, over the emulated pairings of
     std/pairing_bn254.py, pairing_bls12_381.py, pairing_bw6_761.py and
     the native BLS12-377 one) check proofs made on the card, in the Engine
     (frontend/engine.py), in a fifth process (_recursion_lane) started
     with the run, to which each path sends its proof as it makes it:
     Groth16Verifier in a BN254 Engine on phase 4's BN254 Chain 2^17 proof
     (same curve), BLS12-381 Chain 2^17 proof (cross-curve) and phase
     2chain's BW6-761 outer proof (the wrap); PlonkVerifier in BN254 on one
     more prove of phase plonk's BN254 and BLS12-381 Chain 2^17 keys with
     fs_hash="mimc" (same-curve, cross-curve); NativePlonkVerifier in a
     BW6-761 Engine on such a prove of BLS12-377's 2^10 key; KzgVerifier in
     BN254 on an opening of 2^16 coefficients made by the card's kzg.open
     over phase plonk's BN254 and BLS12-381 SRS; each verifier accepts and
     refuses its tamper (the public input + 1, the claimed value + 1) with
     EngineUnsatisfiedError, each verdict and its seconds on a line of its
     own. And the host engine against the card: the fifth process proves a
     BN254 Chain of 2^10 with engine="host" (Groth16 and PLONK, setup rng 1,
     prove rng 2) while nvcc runs; the card does the same in this process;
     the vks' and proofs' bytes must be equal. The card part of each curve
     (the MiMC proves, the openings, the Chain of 2^10) is a path of its
     own ("recursion"), its launches counted;
  The paths of phases 4 to deploy run in two processes at once, each
     with its own launch counts: BN254's paths, BLS12-381's PLONK and
     deploy in this one, the others (LANE_*), the committed 2-chain and
     the ceremony in a spawned one (_other_lane), which also sends its
     curves' proofs and vks through their bytes, and its proofs of phase
     recursion to the fifth process; the service phase runs when both have
     ended, and the recursion checks' result is read after it;
  5. the JSON line of all kernels (each with its launches on each of its
     curve's paths, the batched proves, bsb22, checkpoint, service,
     precompiles and rollup included, and their sum; every kernel but *_double and
     *_add_mixed_masked ran on one);
  6. the card's name and power limit from nvidia-smi.
The last line is {"ok": true, "device": {...}}. Any failure raises: the
script exits non-zero and prints no such line. It needs one CUDA card and
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import random
import subprocess
import sys
import threading
import time
import traceback

CURVE_NAMES = ("bn254", "bls12_381", "bls12_377", "bw6_761")
CHAIN_CURVES = ("bn254", "bls12_381", "bls12_377")   # phase 4
# Chain(2^17 - 2): 131,510 constraints
CHAIN_LOG = {"bn254": 17, "bls12_381": 17, "bls12_377": 17}
# phase plonk: the domain of each curve's SCS Chain (bench.py:359
# bench_plonk, ((2^log - 16) / 3) steps): 2^17 (131,056 gates, a 2^19 coset)
# on BN254 and BLS12-381; a small circuit on BLS12-377 and BW6-761, so that
# their PLONK entries have a path
PLONK_LOG = {"bn254": 17, "bls12_381": 17, "bls12_377": 10, "bw6_761": 10}
REPS_KERNEL = 20    # timed launches per kernel
M_BATCH = 3         # problems of the batched MSMs (A, B1 and K of a Chain prove)
N_FR = 1 << 16      # lanes of the Fr kernel checks
N_EC = 1 << 14      # lanes of the group-law kernel checks
# points of the MSM checks
N_MSM = {"bn254": {"g1": 1 << 12, "g2": 1 << 10}, "bls12_381": {"g1": 1 << 12, "g2": 1 << 10},
         "bls12_377": {"g1": 1 << 12, "g2": 1 << 10}, "bw6_761": {"g1": 1 << 10, "g2": 1 << 10}}


def _path_shapes(log_n: int, msm_points: int, table_rows: int, fr_bits: int,
                 ladder: dict, g2_msm: int) -> dict:
    """The kernel shapes of a Groth16 prove on a 2^log_n domain: the largest
    MSM (the h·Z one, msm_points scalars, pick_window's c) sets the first wave
    stage (windows·2^(c-1) lanes); the G2 MSM (B2 over the wires, g2_msm
    points and rows) the G2 bucket accumulation's; each window size c of the
    path's MSMs (the largest one's and the wires') a bucket reduction and
    Horner of W = ⌈bits / c⌉ + 1 windows of B = 2^(c-1) buckets; the batched
    prove's G1 batch (A, B1 and K) takes the wires' rows (g2_msm) padded as
    the prover pads them (backend/groth16/prove.py _pad_rows)."""
    from gnark_icicle_tpu_torch.backend.groth16.prove import _pad_rows
    from gnark_icicle_tpu_torch.ops.msm import pick_window

    c = pick_window(msm_points)
    windows = -(-fr_bits // c) + 1
    B = 1 << (c - 1)
    cs = sorted({c, pick_window(g2_msm)}, reverse=True)
    return {"fr": 1 << log_n,                  # computeH's Montgomery conversions
            "ntt": log_n,                      # computeH's coset domain
            "points": table_rows,              # MSM point table rows
            "msm": {"g1": msm_points, "g2": g2_msm},  # the bucket accumulation's MSMs
            "wave": windows * B,               # one wave of the reference
            # (W, B, c) of the bucket reduction and Horner
            "reduce": [(-(-fr_bits // k) + 1, 1 << (k - 1), k) for k in cs],
            "batch": _pad_rows(g2_msm),        # the batched prove's A/B1/K rows
            "ladder": ladder}                  # setup's fixed-base ladders


def slice_shapes(name: str) -> dict:
    """The kernel shapes of a curve's main path: the 2^17 Chain (2^18
    domain, c = 16: 17 windows, 557,056 wave lanes; the reduction at W = 17,
    B = 2^15) for the first three curves; for BW6-761 the 2-chain's outer
    proof (35,871 constraints, 35,856 wires, a 2^16 domain; the h·Z MSM of
    65,536 points at c = 12: 33 windows, 67,584 wave lanes, the reduction at
    W = 33, B = 2^11; the wires' MSMs at c = 11: W = 36, B = 2^10; setup's
    G1 batch of 3·35,856 − 2 + 65,535 scalars, its G2 batch of 35,856).
    Setup's fixed-base batches ("ladder"): G1 the A, B, K and Z scalars,
    3·131,512 − 2 + 262,143 = 656,677 on the Chain, G2 B's 131,512. The G2
    MSM is B2 over the wires: 131,512 points on the Chain, 35,856 on
    BW6-761. "plonk" is the 4n rows of the curve's PLONK quotient
    (PLONK_LOG)."""
    if name == "bw6_761":
        shapes = _path_shapes(16, 1 << 16, 35856, 377,
                              {"g1": 3 * 35856 - 2 + 65535, "g2": 35856}, 35856)
    else:
        bits = {"bn254": 254, "bls12_381": 255, "bls12_377": 253}[name]
        shapes = _path_shapes(18, 1 << 18, 1 << 17, bits,
                              {"g1": 3 * 131512 - 2 + (1 << 18) - 1, "g2": 131512}, 131512)
    return {**shapes, "plonk": 4 << PLONK_LOG[name]}
# The card's rates for the bound (the least time the card could take): HBM
# bandwidth from NVIDIA's H100 SXM data sheet; 32-bit integer multiply-adds
# at 64 per SM per clock (compute capability 9.0), at the card's maximum SM
# clock as nvidia-smi reads it. A 32x32 -> 64-bit product is two of them (low
# and high halves).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_SM_CLOCK = 64
# base-field products per group-law lane, not counting the products by b3
# (Renes-Costello-Batina 2016: mixed add 11, add 12, double 8); an Fp2
# product is 3 base products (Karatsuba)
PRODUCTS = {"add_mixed_masked": 11, "add": 12, "double": 8}


def combine_counts(V: int, M: int) -> tuple:
    """(adds, doubles) of one window of the combine (csrc/field.cuh
    k_reduce, reduce_combine_stage): ct = min(V, COMBINE_THREADS) threads
    of r = V / ct chunks, their serial runs (T, G, A), the suffix scan of T
    over the threads, each thread's Y = A + M·(G + r·U) (no U for thread 0,
    no G when r = 1) and the tree over the Y."""
    from gnark_icicle_tpu_torch.ops.ec_t import COMBINE_THREADS

    ct = min(V, COMBINE_THREADS)
    r = V // ct
    log_r, log_m = r.bit_length() - 1, M.bit_length() - 1
    adds, doubles = ct * (2 * (r - 1) + max(r - 2, 0)), 0
    h = 1
    while h < ct:
        adds += ct - h
        h *= 2
    doubles += (ct - 1) * log_r
    adds += (ct - 1) if r > 1 else 0
    with_g = ct if r > 1 else ct - 1
    return adds + with_g + ct - 1, doubles + with_g * log_m
N_SKEW = 1 << 12    # points of the skewed MSM of the bucket accumulation check
N_COMB = 1 << 12    # scalars of the fixed-base comb check
COMB_HOST = 24      # of them held to the host's scalar products


def comb_scalars(rng, r: int, n: int) -> list:
    """n scalars below r: 0, 1, r − 1, 2, 2^64, 2^(bits − 1), 2^(bits − 1) − 1
    (all ones below the top bit), runs of all-ones windows of 3-8 bits,
    then random ones."""
    bits = r.bit_length()
    vals = [0, 1, r - 1, 2, 1 << 64, 1 << (bits - 1), (1 << (bits - 1)) - 1]
    vals += [((1 << (8 * w)) - 1) << (3 * w) for w in range(3, 9)]
    return vals + [rng.randrange(r) for _ in range(n - len(vals))]


# the run's start (main sets it): each phase line carries its seconds since
_START = {"t": None}


def _say(phase: str, **kv) -> None:
    at = {} if _START["t"] is None else {"at_s": time.perf_counter() - _START["t"]}
    print(json.dumps({"phase": phase, **kv, **at}), flush=True)


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _curves() -> dict:
    from gnark_icicle_tpu_torch.curves import bls12_377, bls12_381, bn254, bw6_761

    return {"bn254": bn254.BN254, "bls12_381": bls12_381.BLS12_381,
            "bls12_377": bls12_377.BLS12_377, "bw6_761": bw6_761.BW6_761}


# the SM clock that torch.cuda._sleep counts in (card_rates sets the card's
# maximum: a slower clock only lengthens the wait)
_SPIN_HZ = {"hz": 2.0e9}


def _cuda_ms(fn, reps: int) -> float:
    """Mean ms of one fn() on the card: CUDA events around `reps` calls
    after a warm-up. The calls are queued behind a spin kernel
    (torch.cuda._sleep) that lasts longer than the host takes to enqueue
    them all (1.5x a timed call, at most 1 s), so the card runs them back
    to back and the events time the card's work, not the host's launch
    rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wait = min(1.5 * reps * (time.perf_counter() - t0) + 2e-3, 1.0)
    torch.cuda._sleep(int(wait * _SPIN_HZ["hz"]))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the card's L2 cache: a timed kernel cycles through copies of its inputs
# that move twice this between two uses of one copy (_rotating)
L2_BYTES = 50 * 2**20


def _rotating(run, args: list, nbytes: float):
    """fn() for _cuda_ms: run(*copy) on copies of args in turn, as many as
    make 2·L2_BYTES of traffic (nbytes a call) between two uses of one copy
    (at most 16), so that each launch reads its inputs from device memory,
    as the bound assumes, and not from L2 where the previous launch left
    them."""
    import math

    c = min(16, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    sets = [args] + [[a.clone() for a in args] for _ in range(c - 1)]
    turn = [0]

    def fn():
        turn[0] = (turn[0] + 1) % c
        return run(*sets[turn[0]])
    return fn


def _max_abs_err(a, b) -> int:
    """Largest difference of two tensors, or of two tuples of them."""
    import torch

    if isinstance(a, tuple):
        return max(_max_abs_err(x, y) for x, y in zip(a, b, strict=True))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def card_rates() -> dict:
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm").split()[0])
    rates = {"sms": sms, "max_sm_mhz": mhz, "hbm_bytes_per_s": HBM_BYTES_PER_S,
             "imad_per_s": sms * IMAD_PER_SM_CLOCK * mhz * 1e6}
    _SPIN_HZ["hz"] = mhz * 1e6
    _say("card", **rates)
    return rates


def _bound(rates: dict, nbytes: float, products: float, words: int) -> tuple:
    """(bound_ms, bound_by) for `products` Montgomery products of `words`
    words (CIOS: 2·words² wide products each) and `nbytes` moved."""
    t_bytes = nbytes / rates["hbm_bytes_per_s"]
    t_ops = 2 * (2 * words * words * products) / rates["imad_per_s"]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def comb_work(tc, scalars, table, w: int, bits: int) -> tuple:
    """(bytes, products, adds) of one *_fixed_base launch on these scalars:
    a mixed add (11 products, ×3 over Fp2; b3's not counted, as PRODUCTS)
    for each nonzero digit; the scalars and the whole table read once, the
    projective points written once."""
    from gnark_icicle_tpu_torch.ops.ec_t import comb_digits

    adds = int((comb_digits(scalars, w, bits) != 0).sum().item())
    nbytes = 4 * (scalars.numel() + table.numel() + scalars.shape[1] * tc.planes * tc.W)
    return nbytes, adds * PRODUCTS["add_mixed_masked"] * (3 if tc.NP == 2 else 1), adds


def normalize_work(tc, inf, k: int) -> tuple:
    """(bytes, products) of one *_normalize launch at k lanes a thread
    (csrc/field.cuh normalize_lanes; T = NORMALIZE_THREADS a block): 3
    products for each lane after a thread's first (its running product,
    its inverse and the inverse's update), per thread the Fermat inversion
    (the bits of p − 2 less one squarings, its ones less one products) and
    the product by R⁻¹, and per lane with Z ≠ 0 the coordinates' 2 over Fp,
    10 over Fp2 (the norm 2, z⁻¹ 2, x and y 3 each); the points read once,
    x, y and the flags written once."""
    from gnark_icicle_tpu_torch.ops.ec_t import NORMALIZE_THREADS

    n, T = inf.shape[0], NORMALIZE_THREADS
    full, rest = divmod(n, T * k)
    threads = full * T + min(T, rest)
    e = tc.F.modulus - 2
    inversion = e.bit_length() - 1 + bin(e).count("1") - 1 + 1
    live = n - int(inf.sum().item())
    products = 3 * (n - threads) + threads * inversion + live * (2 if tc.NP == 1 else 10)
    return 4 * n * (5 * tc.NP * tc.W + 1), products


def batch_inv_products(q: int, x) -> int:
    """Products that the batch inverse of the (W, n) array x needs, however
    it is laid out on the card: Montgomery's trick over its nonzero
    elements, 3 for each after the first (the running product, the inverse
    and the inverse's update), and one Fermat inversion (the bits of q − 2
    less one squarings, its ones less one products)."""
    nonzero = int(x.ne(0).any(0).sum().item())
    e = q - 2
    return 3 * max(nonzero - 1, 0) + e.bit_length() - 1 + bin(e).count("1") - 1


def comb_bound(rates: dict, tc, scalars, table, w: int, bits: int) -> tuple:
    """(bound_ms, bound_by, adds) of one *_fixed_base launch (comb_work)."""
    nbytes, products, adds = comb_work(tc, scalars, table, w, bits)
    return _bound(rates, nbytes, products, tc.W) + (adds,)


def normalize_bound(rates: dict, tc, inf, k: int) -> tuple:
    """(bound_ms, bound_by) of one *_normalize launch (normalize_work)."""
    return _bound(rates, *normalize_work(tc, inf, k), tc.W)


# (library stem, mangled kernel name) -> (registers, spill store bytes), from
# ptxas -v in the build's logs (phase_build)
_PTXAS: dict = {}


def ptxas_kernels(lines: list) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} of a ptxas -v
    log."""
    out, cur = {}, None
    for ln in lines:
        if "Compiling entry function '" in ln:
            cur = ln.split("'")[1]
            out[cur] = [None, 0]
        elif "Function properties for " in ln:
            name = ln.split("Function properties for ")[1].strip()
            cur = name if name in out else None
        elif cur and "bytes spill stores" in ln:
            out[cur][1] = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif cur and "Used " in ln and " registers" in ln:
            out[cur][0] = int(ln.split("Used ")[1].split(" registers")[0])
    return {k: tuple(v) for k, v in out.items()}


def kernel_regs(lib: str, kernel: str):
    """(registers, spill store bytes) of the non-template kernel `kernel`
    (its C++ name) in library `lib`, or None where the log has no such
    kernel (the templated group-law kernels)."""
    tag = f"{len(kernel)}{kernel}"
    for mangled, rs in _PTXAS.items():
        if mangled[0] == lib and mangled[1].startswith("_Z" + tag):
            return rs
    return None


def load_curve(name: str) -> None:
    """Load one curve's libraries, once they are built, and read their ptxas
    logs (kernel_regs)."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    kc.load(name)
    out_dir = kc.build_dir()
    for src in kc.CURVE_SOURCES[name]:
        stem = kc.lib_stem(src, name)
        path = os.path.join(out_dir, stem + ".log")
        lines = open(path).read().splitlines() if os.path.exists(path) else []
        _PTXAS.update({(stem, k): v for k, v in ptxas_kernels(lines).items()})


def phase_build(seconds: float) -> None:
    """Report the build (`seconds`: its wall time): each nvcc's seconds and
    its ptxas lines."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    regs, each = {}, {}
    out_dir = kc.build_dir()
    for src, curve in kc.libraries():
        stem = kc.lib_stem(src, curve)
        path = os.path.join(out_dir, stem + ".log")
        lines = open(path).read().splitlines() if os.path.exists(path) else []
        regs[stem] = [ln.split("ptxas info    : ")[-1] for ln in lines
                      if "registers" in ln or "spill" in ln]
        path = os.path.join(out_dir, stem + ".seconds")
        each[stem] = float(open(path).read()) if os.path.exists(path) else None
    _say("build", seconds=seconds, nvcc_seconds=each, ptxas=regs)


def _rand_fe(rng, q, n):
    """n random elements of Z/q, led by 0, 1, p - 1, p - 2 and values near R."""
    from gnark_icicle_tpu_torch.ops.field import field_for

    R = field_for(q).R
    edge = [0, 1, q - 1, q - 2, (R - 1) % q, R % q, (R >> 1) % q]
    return edge + [rng.randrange(q) for _ in range(n - len(edge))]


def _rand_dev(F, planes: int, n: int, device):
    """(planes, W, n) random canonical Montgomery words of field F on the
    card (a top word below p's top word keeps every value under p)."""
    import torch

    w = torch.randint(-(1 << 31), 1 << 31, (planes, F.n32, n), dtype=torch.int64,
                      device=device)
    w[:, -1] = torch.randint(0, F.modulus >> (32 * (F.n32 - 1)), (planes, n),
                             device=device)
    return w.to(torch.int32)


def phase_kernels(device, name: str, rates: dict) -> list:
    """Every kernel entry of one curve against its plain version on the card,
    bit-equal: first at the check sizes (N_FR, N_EC), then at the shapes of
    its curve's path (slice_shapes), where both versions are also timed."""
    import torch

    from gnark_icicle_tpu_torch.ops import cuda as kc
    from gnark_icicle_tpu_torch.ops.ec_t import TCurve, TCurve2, resident_lanes
    from gnark_icicle_tpu_torch.ops.field import field_for, ints_to_limbs32, to_lanes
    from gnark_icicle_tpu_torch.ops.field_t import (
        BATCH_INV_LANES, BATCH_INV_THREADS, QUOTIENT_CONSTS, QUOTIENT_INPUTS, QUOTIENT_PRODUCTS,
        TField, plonk_quotient_plain,
    )
    from gnark_icicle_tpu_torch.ops.msm import (
        MSMKernel, pick_window, reduce_chunks, segment_length,
    )

    curve = _curves()[name]
    prefix = kc.CURVES[name]
    rng = random.Random(7)
    R, P = curve.fr.modulus, curve.fp.modulus
    fr, fp = field_for(R), field_for(P)
    tf = TField(fr)
    results = []
    shapes = slice_shapes(name)

    def record(kname, check_err, shape, args, run, run_plain, nbytes, products,
               words, **extra):
        """args: inputs at the main path's shape; run/run_plain(*args) return
        the result (an in-place kernel returns its updated input). Both run
        once on copies of args and must agree; the plain version's time is
        that one run's (CUDA events around it), and the kernel is timed on
        args (_cuda_ms). A second shape of the same entry goes into its
        row's other_shapes. Returns the row."""
        def fresh():
            return [a.clone() for a in args]

        t_plain = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        want = fresh()
        t_plain[0].record()
        want = run_plain(*want)
        t_plain[1].record()
        torch.cuda.synchronize()
        plain_ms = t_plain[0].elapsed_time(t_plain[1])
        err = max(check_err, _max_abs_err(run(*fresh()), want))
        if err != 0:
            raise AssertionError(f"{prefix}{kname}: kernel differs from its plain version")
        k = kc.KERNELS[prefix + kname]
        bound_ms, bound_by = _bound(rates, nbytes, products, words)
        row = {"shape": shape, "max_abs_err": err,
               "ms": _cuda_ms(_rotating(run, args, nbytes), REPS_KERNEL),
               "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, **extra}
        regs = kernel_regs(k.lib, "k_" + kname)
        if regs is not None:
            row["registers"], row["spill_bytes"] = regs
        first = next((r for r in results if r["name"] == k.name), None)
        if first is not None:
            first["max_abs_err"] = max(first["max_abs_err"], err)
            first.setdefault("other_shapes", []).append(row)
            return row
        results.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "curve": name, **row, "library_ms": None})
        return results[-1]

    # Fr: field elements at N_FR lanes, then the computeH width
    n = N_FR
    a = fr.encode(_rand_fe(rng, R, n), device)
    b = fr.encode(_rand_fe(rng, R, n)[::-1], device)
    c1 = fr.const(rng.randrange(R), device)
    nf = shapes["fr"]
    big = list(_rand_dev(fr, 2, nf, device))
    lane = 4 * fr.n32   # bytes of one element
    record("fr_mont_mul", max(_max_abs_err(tf.mont_mul(a, b), fr.mont_mul(a, b)),
                              _max_abs_err(tf.mont_mul(a, c1), fr.mont_mul(a, c1))),
           f"({fr.n32}, {nf})", big, tf.mont_mul, fr.mont_mul,
           3 * lane * nf, nf, fr.n32)
    record("fr_sub", _max_abs_err(tf.sub(a, b), fr.sub(a, b)),
           f"({fr.n32}, {nf})", big, tf.sub, fr.sub, 3 * lane * nf, 0, fr.n32)

    # PLONK: fr_add and the quotient at N_FR rows with 0, 1, p − 1, p − 2 and
    # values near R in every input (each array's edges on rows of their
    # own), then at the 4n rows of the curve's PLONK path
    # (BN254 also at the 4n rows of phase rollup's keccak256, 2^20)
    rows4 = [shapes["plonk"]] + ([4 << KECCAK_LOG] if name == "bn254" else [])
    add_err = max(_max_abs_err(tf.add(a, b), fr.add(a, b)),
                  _max_abs_err(tf.add(a, a), fr.add(a, a)))
    for m4 in rows4:
        record("fr_add", add_err, f"({fr.n32}, {m4})", list(_rand_dev(fr, 2, m4, device)),
               tf.add, fr.add, 3 * lane * m4, 0, fr.n32)
    edge_vals = _rand_fe(rng, R, n)
    n_in = len(QUOTIENT_INPUTS) + 2
    q_in = torch.stack([fr.encode(edge_vals[3 * i:] + edge_vals[:3 * i], device)
                        for i in range(n_in)])
    zh = fr.encode(_rand_fe(rng, R, 7)[2:6], device)            # p − 1, p − 2, near R
    consts = fr.encode([rng.randrange(R) for _ in range(len(QUOTIENT_CONSTS) - 1)] + [1],
                       device)

    def quotient(fn):
        def run(E, zh_, c):
            return fn(list(E[:n_in - 2]), E[n_in - 2], E[n_in - 1], zh_, c)
        return run

    # the kernel takes the constants from the host, as the path passes them
    consts_host = consts.cpu()
    run_q = quotient(lambda *args: tf.plonk_quotient(*args[:-1], consts_host))
    run_q_plain = quotient(lambda *args: plonk_quotient_plain(fr, *args))
    # the bound at the reference's 21 products a row, so that rows before
    # and after the kernel's 20 compare, and at the kernel's own count
    q_err = _max_abs_err(run_q(q_in, zh, consts), run_q_plain(q_in, zh, consts))
    for m4 in rows4:
        q_bytes = (n_in + 1) * lane * m4 + 11 * lane
        record("plonk_quotient", q_err, f"{n_in} x ({fr.n32}, {m4})",
               [_rand_dev(fr, n_in, m4, device), zh, consts],
               run_q, run_q_plain, q_bytes, 21 * m4, fr.n32,
               products_per_row=21, kernel_products_per_row=QUOTIENT_PRODUCTS,
               kernel_products_bound_ms=_bound(rates, q_bytes, QUOTIENT_PRODUCTS * m4,
                                               fr.n32)[0])

    # the batch inversion of the quotient's tables: edge values, zeros at
    # the first and the last lane of threads, a thread all zeros and a last
    # block whose threads have fewer than k lanes; then at the 4n rows
    k, T = BATCH_INV_LANES, BATCH_INV_THREADS
    nb = N_FR + 37
    vals = _rand_fe(rng, R, nb)
    for b, t in ((0, 5), (1, 0), (2, T - 1), (nb // (T * k), 0)):
        for i in (0, k - 1):
            if b * T * k + t + i * T < nb:
                vals[b * T * k + t + i * T] = 0
    for i in range(k):
        vals[7 + i * T] = 0
    xb = fr.encode(vals, device)
    inv_err = _max_abs_err(tf.mont_inv(xb), fr.mont_inv(xb))
    for m4 in rows4:
        big_inv = _rand_dev(fr, 1, m4, device)[0]
        big_inv[:, ::1021] = 0
        record("fr_batch_inv", inv_err, f"({fr.n32}, {m4}), k = {k}", [big_inv], tf.mont_inv,
               fr.mont_inv, 2 * lane * m4, batch_inv_products(R, big_inv), fr.n32, k=k)

    ntt_rows(device, name, rates, record, shapes)

    # G1 and G2: random coordinates (the formulas are arithmetic, so any field
    # elements test them), identity lanes, random signs and masks
    n = N_EC
    g1 = TCurve(fp, 3 * curve.g1.b % P)
    fp2 = hasattr(curve.g2.b, "c0")
    g2 = (TCurve2(fp, curve.tower.beta, curve.g2.b * 3) if fp2
          else TCurve(fp, 3 * curve.g2.b % P))
    for tc, tag in ((g1, "g1"), (g2, "g2")):
        # BW6-761's G2 runs the g1 entries with its own b3: checked below,
        # recorded once (as g1)
        check_only = not fp2 and tag == "g2"
        coord = 4 * fp.n32 * tc.NP          # bytes of one coordinate
        per_product = 3 if tc.NP == 2 else 1

        def rand_points(count):
            P_ = _rand_dev(fp, tc.planes, count, device)
            k = min(16, count)
            P_[..., :k] = tc.identity(k, device)
            return P_

        def rand_wave(lanes, rows, signed=True):
            table = _rand_dev(fp, 2 * tc.NP, rows, device).reshape(-1, rows).T.contiguous()
            idx = torch.randint(0, rows, (lanes,), dtype=torch.int32, device=device)
            sign = (torch.randint(0, 2, (lanes,), dtype=torch.int32, device=device)
                    if signed else None)
            mask = torch.randint(0, 2, (lanes,), dtype=torch.int32, device=device)
            return [table, idx, sign, mask]

        def wave(fn, lanes):
            def run(acc, table, idx, sign, mask):
                fn(acc, lanes, table, idx, sign, mask)
                return acc
            return run

        def wave_bytes(lanes, w):
            """mask of every lane; idx, sign, table row and acc in and out
            of the unmasked lanes; each gathered row read once"""
            table, idx, sign, mask = w
            on = mask != 0
            rows = int(torch.unique(idx[on]).numel())
            k = int(on.sum().item())
            return (4 * lanes + k * (4 + (4 if sign is not None else 0) + 6 * coord)
                    + rows * 2 * coord), k

        def plain(op):
            def run(*args):
                return tc._stack(getattr(tc.curve, op)(*map(tc._coords, args)))
            return run

        kern = MSMKernel(tc, R.bit_length())

        def bucket(fn):
            def run(acc, table, order, sign, start, count):
                fn(acc, table, order, sign, start, count)
                return acc
            return run

        def msm_lanes(scal):
            """The MSM's own lanes of (Wr, n) scalars: (order, sign, start,
            count, back, nseg, runs' starts, runs' counts, seg)."""
            n_ = scal.shape[1]
            c_ = pick_window(n_)
            seg = segment_length(n_, c_, R.bit_length(), resident_lanes(device))
            order, sign, starts, counts, _, _ = kern._runs(
                torch.zeros(n_, dtype=torch.bool, device=device), scal, c_)
            return (order, sign) + kern._segments(starts, counts, seg) + (starts, counts, seg)

        def bucket_check(table, lanes) -> int:
            """kernel against plain on the lanes, limb for limb; then the
            folded segments of every split run against the run unsplit, in
            affine form"""
            order, sign, start, count, back, nseg, starts, counts, _ = lanes
            acc_k = tc.identity(count.shape[0], device)
            acc_p = acc_k.clone()
            tc.bucket_accumulate(acc_k, table, order, sign, start, count)
            tc.bucket_accumulate_plain(acc_p, table, order, sign, start, count)
            err = _max_abs_err(acc_k, acc_p)
            if nseg is None:
                raise AssertionError("the skewed check split no run")
            folded = kern._fold_segments(acc_k[..., back], nseg)
            whole = kern._accumulate(table, order, sign, starts, counts, 1 << 30)
            split = torch.nonzero(nseg > 1).flatten()
            if tc.to_affine_host(folded[..., split]) != tc.to_affine_host(whole[..., split]):
                raise AssertionError(f"{prefix}{tag}: folded segments differ from the runs")
            return err

        def skewed_scalars(n_):
            """mostly 0 and 1, every 8th random: window 0's digit-1 run
            holds about 60 % of the points"""
            vals = [rng.randrange(R) if i % 8 == 0 else rng.choice((0, 1, 1)) for i in range(n_)]
            return to_lanes(ints_to_limbs32(vals, fr.n32), device)

        def reduction_check() -> int:
            """The running sums, the combine and Horner against their
            plain versions at the check sizes: coordinates at 0, 1,
            p − 1, p − 2 and near R, identity buckets (every 5th and the
            first 16), a window with one bucket used; (M, V) = (16, 1), (8,
            8) and (1, 512: four chunks a combine thread); Horner at W = 5
            (one window sum the identity) and W = 1, c = 4, and at W = 5
            over M_BATCH problems (one all identity, one of edge
            coordinates)."""
            errs = []
            edge = fp.encode(_rand_fe(rng, P, 32), device)
            for W_, B_, V in ((3, 16, 1), (3, 64, 8), (2, 512, 512)):
                S = rand_points(W_ * B_)
                S[:, :, 16:48] = edge
                S[..., ::5] = tc.identity(S[..., ::5].shape[2], device)
                S[..., B_:2 * B_] = tc.identity(B_, device)
                S[..., B_ + 3] = rand_points(17)[..., 16]
                M = B_ // V
                T = A = S
                if M > 1:
                    TA = tc.reduce_runs(S, M)
                    errs.append(_max_abs_err(TA, tc.reduce_runs_plain(S, M)))
                    T, A = TA[:tc.planes], TA[tc.planes:]
                want = tc.reduce_combine_plain(T, A, W_, V, M)
                errs += [_max_abs_err(tc.reduce_combine(T, A, W_, V, M), want),
                         _max_abs_err(tc.bucket_reduce(S, W_, V), want)]
            for W_, M_ in ((5, 1), (1, 1), (5, M_BATCH)):
                S = _rand_dev(fp, tc.planes, M_ * W_, device)
                S[..., W_ // 2:W_ // 2 + 1] = tc.identity(1, device)
                if M_ > 1:     # a problem all identity, a problem of edge coordinates
                    S[..., W_:2 * W_] = tc.identity(W_, device)
                    S[..., 2 * W_:3 * W_] = edge[:, :tc.planes * W_].reshape(
                        fp.n32, tc.planes, W_).permute(1, 0, 2)
                want = tc.horner_plain(S, 4, M_)
                errs.append(_max_abs_err(tc.horner(S, 4, M_), want))
            return max(errs)

        def reduction_path(check_err: int, timed: bool) -> None:
            """The reduction and Horner at each (W, B, c) of the path's
            MSMs, V from reduce_chunks, and the first of them again over the
            M_BATCH problems of a batched prove (msm_batch: M·W global
            windows, Horner one warp a problem; G2, which the batched proves
            do not batch, Horner alone): kernels against plain versions on
            random coordinates (every 97th bucket the identity); timed with
            the bound where timed, else checked only."""
            pt = 3 * coord                  # bytes of one projective point
            for i, (W1, B_, c_) in enumerate(shapes["reduce"]):
                for Mp in ((1, M_BATCH) if i == 0 else (1,)):
                    W_ = Mp * W1
                    if Mp > 1 and tag != "g1":
                        # the batched proves batch G1 only: G2 takes the
                        # batched Horner (one warp a problem) alone
                        Sw = rand_points(W_)
                        Sw[..., ::5] = tc.identity(Sw[..., ::5].shape[2], device)
                        info = f"W={W1}, c={c_}, {Mp} problems"
                    else:
                        V = reduce_chunks(W_, B_, resident_lanes(device))
                        M = B_ // V
                        S = rand_points(W_ * B_)
                        S[..., ::97] = tc.identity(S[..., ::97].shape[2], device)
                        info = f"W={W_}, B={B_}, V={V}, M={M}" + (f", {Mp} problems" if Mp > 1
                                                                   else "")
                        if M > 1:
                            adds = W_ * V * 2 * (M - 1)
                            if timed:
                                record(f"{tag}_bucket_reduce", check_err, info, [S],
                                       lambda S: tc.reduce_runs(S, M),
                                       lambda S: tc.reduce_runs_plain(S, M),
                                       W_ * B_ * pt + 2 * W_ * V * pt,
                                       adds * PRODUCTS["add"] * per_product, fp.n32, adds=adds)
                            elif _max_abs_err(tc.reduce_runs(S, M), tc.reduce_runs_plain(S, M)):
                                raise AssertionError(f"{prefix}{tag}_bucket_reduce differs ({info})")
                            TA = tc.reduce_runs(S, M)
                            T, A = TA[:tc.planes], TA[tc.planes:]
                        else:
                            T = A = S
                        ca, cd = combine_counts(V, M)
                        combine = (lambda T, A: tc.reduce_combine(T, A, W_, V, M),
                                   lambda T, A: tc.reduce_combine_plain(T, A, W_, V, M))
                        if timed:
                            record(f"{tag}_reduce_combine", check_err, info, [T, A], *combine,
                                   (2 if M > 1 else 1) * W_ * V * pt + W_ * pt,
                                   W_ * (ca * PRODUCTS["add"] + cd * PRODUCTS["double"])
                                   * per_product, fp.n32, adds=W_ * ca,
                                   doubles=W_ * cd)
                        elif _max_abs_err(combine[0](T, A), combine[1](T, A)):
                            raise AssertionError(f"{prefix}{tag}_reduce_combine differs ({info})")
                        Sw = tc.reduce_combine(T, A, W_, V, M)
                    rounds = c_ * (W1 - 1)
                    h_products = Mp * ((W1 - 1) * PRODUCTS["add"]
                                       + rounds * PRODUCTS["double"]) * per_product
                    run = (lambda S: tc.horner(S, c_, Mp))
                    run_plain = (lambda S: tc.horner_plain(S, c_, Mp))
                    if not timed:
                        if _max_abs_err(run(Sw), run_plain(Sw)):
                            raise AssertionError(f"{prefix}{tag}_horner differs ({info})")
                        continue
                    row = record(f"{tag}_horner", check_err, f"W={W1}, c={c_}, M={Mp}", [Sw],
                                 run, run_plain, (W_ + Mp) * pt, h_products, fp.n32,
                                 doubles=rounds, adds=W1 - 1, problems=Mp)
                    row["per_double_us"] = row["ms"] * 1e3 / max(rounds, 1)

        # curve points: the fold regroups the sum, which only the group law
        # on the curve leaves unchanged
        group = curve.g1 if tag == "g1" else curve.g2
        skew_pts, _ = _chain_points(group, rng.randrange(1, R), rng.randrange(1, R), N_SKEW, R)
        skew_table = tc.table([pt or group.generator for pt in skew_pts], device)
        skew_err = bucket_check(skew_table, msm_lanes(skewed_scalars(N_SKEW)))

        def comb_rows(entry: str) -> int:
            """K6's role, setup's fixed-base batch: *_fixed_base (at
            WINDOW) and *_normalize against their plain versions
            at N_COMB edge scalars (and a few lanes against the host
            product), then at the path's batch width (random scalars below
            r), timed with the bound. Returns the check sizes' error."""
            from gnark_icicle_tpu_torch.ops.ec_t import NORMALIZE_LANES
            from gnark_icicle_tpu_torch.ops.fixed_base import WINDOW, FixedBaseMul

            group = curve.g1 if tag == "g1" else curve.g2
            bits = R.bit_length()
            w = WINDOW
            fb = FixedBaseMul(tc, group, group.generator, bits, device)
            vals = comb_scalars(rng, R, N_COMB)
            sc = to_lanes(ints_to_limbs32(vals, fr.n32), device)
            got = fb.mul(sc)
            xy, inf = tc.normalize(got)
            err = max(_max_abs_err(got, tc.fixed_base_plain(sc, fb.table, w, bits)),
                      _max_abs_err((xy, inf), tc.normalize_plain(got)))
            host = [group.scalar_mul(group.generator, v) for v in vals[:COMB_HOST]]
            if tc.NP == 2:
                host = [None if q is None else ((q[0].c0, q[0].c1), (q[1].c0, q[1].c1))
                        for q in host]
            if err != 0 or tc.affine_host(xy[..., :COMB_HOST], inf[:COMB_HOST]) != host:
                raise AssertionError(f"{prefix}{entry}_fixed_base / _normalize differ "
                                     "at the check scalars")
            lanes = shapes["ladder"][tag]
            big = to_lanes(ints_to_limbs32(
                [0, 1, R - 1] + [rng.randrange(R) for _ in range(lanes - 3)], fr.n32), device)
            nbytes, products, adds = comb_work(tc, big, fb.table, w, bits)
            role = "G2 over Fp, G2's b3" if check_only else tag.upper()
            record(f"{entry}_fixed_base", err,
                   f"{lanes} lanes ({role}), w = {w}, {fb.table.shape[0]} table rows",
                   [big], fb.mul, lambda s: tc.fixed_base_plain(s, fb.table, w, bits),
                   nbytes, products, fp.n32, w=w, adds=adds)
            P_big = fb.mul(big)
            k = NORMALIZE_LANES
            record(f"{entry}_normalize", err, f"{lanes} lanes ({role}), k = {k}", [P_big],
                   tc.normalize, tc.normalize_plain,
                   *normalize_work(tc, tc.normalize(P_big)[1], k), fp.n32, k=k)
            return err

        P_, Q_ = rand_points(n), rand_points(n)
        # an edge table: rows at 0, 1, p - 1 and near R
        check = [P_] + rand_wave(n, 1 << 12)
        edge = fp.encode(_rand_fe(rng, P, 2 * tc.NP * 8), device)
        check[1][:8] = edge.reshape(fp.n32, 8, 2 * tc.NP).permute(1, 2, 0).reshape(8, -1)
        if check_only:
            errs = [_max_abs_err(wave(tc.add_mixed_masked, n)(*[t.clone() for t in check]),
                                 wave(tc.add_mixed_masked_plain, n)(*[t.clone() for t in check])),
                    _max_abs_err(tc.add(P_, Q_), plain("add")(P_, Q_)),
                    _max_abs_err(tc.double(P_), plain("double")(P_))]
            errs.append(skew_err)
            errs.append(reduction_check())
            reduction_path(0, timed=False)
            errs.append(comb_rows("g1"))
            if max(errs) != 0:
                raise AssertionError(f"{prefix}g1_* with G2's b3 differ from the plain version")
            _say("kernel_check", curve=name, group="g2 over Fp (g1 entries, G2's b3)",
                 max_abs_err=max(errs), comb_lanes=shapes["ladder"]["g2"])
            continue
        lanes = shapes["wave"]
        w_path = rand_wave(lanes, shapes["points"])
        nb, k = wave_bytes(lanes, w_path)
        # the reference's wave: the unmasked lanes a prefix of the lanes
        acc_wave = rand_points(lanes)
        w_prefix = list(w_path)
        w_prefix[3] = (torch.arange(lanes, device=device) < k).to(torch.int32)
        pnb, pk = wave_bytes(lanes, w_prefix)
        p_bound, p_by = _bound(rates, pnb, pk * PRODUCTS["add_mixed_masked"] * per_product,
                               fp.n32)
        record(f"{tag}_add_mixed_masked",
               _max_abs_err(wave(tc.add_mixed_masked, n)(*[t.clone() for t in check]),
                            wave(tc.add_mixed_masked_plain, n)(*[t.clone() for t in check])),
               f"{lanes} lanes, {shapes['points']} table rows",
               [rand_points(lanes)] + w_path,
               wave(tc.add_mixed_masked, lanes), wave(tc.add_mixed_masked_plain, lanes),
               nb, k * PRODUCTS["add_mixed_masked"] * per_product, fp.n32,
               prefix_mask={"unmasked": pk,
                            "ms": _cuda_ms(lambda: wave(tc.add_mixed_masked, lanes)(
                                acc_wave, *w_prefix), REPS_KERNEL),
                            "bound_ms": p_bound, "bound_by": p_by})
        # the MSM's bucket accumulation at the path's MSM of the group (G1:
        # the largest, h·Z; G2: B2 over the wires): random scalars through
        # the MSM's own digits, sort and segments
        n_msm = shapes["msm"][tag]
        lanes_msm = msm_lanes(_rand_dev(fr, 1, n_msm, device)[0])
        order, sign, start, count = lanes_msm[:4]
        adds = int(count.sum().item())
        in_run = torch.repeat_interleave(start, count.long()) + (
            torch.arange(adds, device=device)
            - torch.repeat_interleave(torch.cumsum(count.long(), 0) - count.long(),
                                      count.long()))
        rows = int(torch.unique(order[in_run]).numel())
        record(f"{tag}_bucket_accumulate", skew_err,
               f"{count.shape[0]} lanes, {adds} points, {n_msm} table rows",
               [tc.identity(count.shape[0], device),
                _rand_dev(fp, 2 * tc.NP, n_msm, device).reshape(-1, n_msm).T.contiguous(),
                order, sign, start, count],
               bucket(tc.bucket_accumulate), bucket(tc.bucket_accumulate_plain),
               adds * 8 + rows * 2 * coord + count.shape[0] * (12 + 3 * coord),
               adds * PRODUCTS["add_mixed_masked"] * per_product, fp.n32,
               longest=int(count[0].item()), segment=lanes_msm[8],
               split_runs=0 if lanes_msm[5] is None else int((lanes_msm[5] > 1).sum().item()))
        if tag == "g1":
            # the batched prove's G1 batch (A, B1 and K over the padded wires,
            # msm_batch over one table a problem): the M_BATCH problems' runs
            nb_ = shapes["batch"]
            c_b = pick_window(nb_)
            sc_b = torch.stack([_rand_dev(fr, 1, nb_, device)[0] for _ in range(M_BATCH)])
            ob, sb, st_b, cn_b, _, _ = kern._runs_batch(
                torch.zeros((M_BATCH, nb_), dtype=torch.bool, device=device), sc_b, c_b, False)
            seg_b = segment_length(M_BATCH * nb_, c_b, R.bit_length(), resident_lanes(device))
            start_b, count_b, _, nseg_b = kern._segments(st_b, cn_b, seg_b)
            adds_b = int(count_b.sum().item())
            record(f"{tag}_bucket_accumulate", skew_err,
                   f"{count_b.shape[0]} lanes, {adds_b} points, {M_BATCH} problems of "
                   f"{nb_} table rows",
                   [tc.identity(count_b.shape[0], device),
                    _rand_dev(fp, 2, M_BATCH * nb_, device).reshape(-1, M_BATCH * nb_).T
                    .contiguous(), ob, sb, start_b, count_b],
                   bucket(tc.bucket_accumulate), bucket(tc.bucket_accumulate_plain),
                   adds_b * 8 + M_BATCH * nb_ * 2 * coord + count_b.shape[0] * (12 + 3 * coord),
                   adds_b * PRODUCTS["add_mixed_masked"] * per_product, fp.n32,
                   longest=int(count_b[0].item()), segment=seg_b, problems=M_BATCH,
                   split_runs=0 if nseg_b is None else int((nseg_b > 1).sum().item()))
        # add: the fold's first round on this MSM (a pair of segments of a
        # split run a lane), one lane where no run is split; double: one
        # lane, Horner's shape, which now runs in *_horner
        nseg = lanes_msm[5]
        fold = 0 if nseg is None else int((nseg // 2).sum().item())
        for op, width, role in (("add", max(fold, 1), "the fold's first round" if fold
                                 else "off this path (no run split)"),
                                ("double", 1, "Horner's shape, off the path")):
            args = [P_, Q_] if op == "add" else [P_]
            record(f"{tag}_{op}", _max_abs_err(getattr(tc, op)(*args), plain(op)(*args)),
                   f"{width} lanes: {role}", [rand_points(width) for _ in args],
                   getattr(tc, op), plain(op),
                   (len(args) + 1) * 3 * coord * width,
                   width * PRODUCTS[op] * per_product, fp.n32)
        reduction_path(reduction_check(), timed=True)
        comb_rows(tag)
    torch.cuda.synchronize()
    for r in results:
        _say("kernel", **r)
    return results


def _plain_transform(dom, x, key: str, dif: bool, post=None, **load):
    """A Domain transform as the plain versions of its passes (ops/ntt.py
    Domain._transform): the load's operands on the first, post on the last."""
    from gnark_icicle_tpu_torch.ops.ntt import ntt_pass_plain, pass_split

    passes = pass_split(dom.log_n)
    passes = passes[::-1] if dif else passes
    for i, p in enumerate(passes):
        x = ntt_pass_plain(dom.F, x, dom._twiddles(key), p, dif, **(load if i == 0 else {}),
                           post=post if i == len(passes) - 1 else None)
    return x


def ntt_rows(device, name: str, rates: dict, record, shapes: dict) -> None:
    """ntt_pass at the path's shapes, on the path's own domains (computeH's
    2^log_n coset, PLONK's 4n coset): each pass that a transform there
    launches with the operands it carries, held to ntt_pass_plain and timed
    with its bound (record); then each whole transform, held to its passes'
    plain versions, timed beside its bound (the row's "transforms")."""
    import torch

    from gnark_icicle_tpu_torch.ops.field import field_for
    from gnark_icicle_tpu_torch.ops.ntt import domain_for, ntt_pass, ntt_pass_plain, pass_split

    curve = _curves()[name]
    fr = field_for(curve.fr.modulus)
    W = fr.n32
    lane = 4 * W
    dom = domain_for(fr, curve.fr, shapes["ntt"], device, coset=True)
    dom4 = domain_for(fr, curve.fr, PLONK_LOG[name] + 2, device, coset=True)
    den = fr.const(random.Random(5).randrange(1, curve.fr.modulus), device)

    def operands(d, names):
        return {k: den if k == "scale" else
                (d._coset_unscale_rev if k == "post" else _rand_dev(fr, 1, d.n, device)[0])
                for k in names}

    def pass_row(d, p, key, dif, names, role):
        tws = d._twiddles(key)
        ops = operands(d, names)

        def run(x, *tabs):
            return ntt_pass(fr, x, tws, p, dif, **dict(zip(ops, tabs)))

        def run_plain(x, *tabs):
            return ntt_pass_plain(fr, x, tws, p, dif, **dict(zip(ops, tabs)))
        # each input once: x, the operands, the stages' 2^s twiddles; out once
        words = 2 * d.n + sum(t.shape[1] for t in ops.values()) + (1 << (p.s_lo + p.c)) - (1 << p.s_lo)
        products = (d.n // 2) * p.c + d.n * sum(k != "sub" for k in ops)
        return record("ntt_pass", 0, f"n=2^{d.log_n}, stages {p.s_lo}-{p.s_lo + p.c - 1}, "
                      f"tile {1 << p.log_g}x{1 << p.c}x{1 << p.log_t}: {role}",
                      [_rand_dev(fr, 1, d.n, device)[0], *ops.values()], run, run_plain,
                      lane * words, products, W)

    def computeh_rows(d):
        low, *upper = pass_split(d.log_n)
        top = upper[-1] if upper else low
        row = pass_row(d, top, "i", True, ("mul", "sub", "scale"),
                       "computeH's coset INTT, first pass: (a·b − c)·den on the load")
        for p in upper[:-1]:
            pass_row(d, p, "i", True, (), "coset INTT, a middle pass")
        pass_row(d, low, "i", True, ("post",), "coset INTT, last pass: g^-i·n^-1 on the store")
        pass_row(d, low, "f", False, ("mul",),
                 "coset NTT (bit-reversed in), first pass: g^i on the load")
        return row

    main = computeh_rows(dom)
    # phase precompiles' computeH domain (ecrecover's 2^20: three passes)
    dom_pc = (domain_for(fr, curve.fr, PRECOMPILES_LOG, device, coset=True)
              if name == "bn254" else None)
    if dom_pc is not None:
        computeh_rows(dom_pc)
    # PLONK's 4n coset; on BN254 also phase rollup's keccak256 (2^20 rows)
    doms4 = [dom4] + ([domain_for(fr, curve.fr, KECCAK_LOG + 2, device, coset=True)]
                      if name == "bn254" else [])
    for d4 in doms4:
        low4, *upper4 = pass_split(d4.log_n)
        top4 = upper4[-1] if upper4 else low4
        pass_row(d4, top4, "f", True, ("mul",),
                 "PLONK's 4n coset NTT, first pass: g^i on the load")
        pass_row(d4, low4, "i", True, ("post",), "PLONK's 4n coset INTT, last pass")

    def rand(d):
        return _rand_dev(fr, 1, d.n, device)[0]

    def computeh_cases(d):
        x, b, c = rand(d), rand(d), rand(d)
        return (
            (d, "intt_nat_to_rev", (x,), lambda: _plain_transform(d, x, "i", True, post=d.n_inv),
             1, 1),
            (d, "coset_ntt_rev_in", (x,),
             lambda: _plain_transform(d, x, "f", False, mul=d._coset_pows_rev), d.n, 1),
            (d, "coset_intt_nat_to_rev_pointwise", (x, b, c, den),
             lambda: _plain_transform(d, x, "i", True, post=d._coset_unscale_rev, mul=b, sub=c,
                                      scale=den), d.n, 3))

    def coset_cases(d4):
        x4 = rand(d4)
        return (
            (d4, "coset_ntt_nat", (x4,),
             lambda: d4.bit_reverse(_plain_transform(d4, x4, "f", True, mul=d4.coset_pows)),
             d4.n, 1),
            (d4, "coset_intt_nat", (x4,),
             lambda: d4.bit_reverse(_plain_transform(d4, x4, "i", True,
                                                     post=d4._coset_unscale_rev)), d4.n, 1))

    # (domain, method, its arguments, its plain version, the columns of its
    # scaling table: n, or 1 for n^-1; products a row for the scalings)
    cases = computeh_cases(dom) + (computeh_cases(dom_pc) if dom_pc is not None else ()) + sum(
        (coset_cases(d4) for d4 in doms4), ())
    main["transforms"] = []
    for d, method, args, plain, table, scalings in cases:
        run = getattr(d, method)
        if _max_abs_err(run(*args), plain()) != 0:
            raise AssertionError(f"{name} {method} at 2^{d.log_n} differs from its passes' "
                                 "plain versions")
        n = d.n
        # the arguments, the stage-major twiddles and the scaling table read
        # once, the output written once
        nbytes = lane * (sum(t.shape[1] for t in args) + n + table + n)
        bound_ms, bound_by = _bound(rates, nbytes, (n // 2) * d.log_n + n * scalings, W)
        main["transforms"].append({
            "transform": method, "n": f"2^{d.log_n}", "passes": len(pass_split(d.log_n)),
            "ms": _cuda_ms(_rotating(run, list(args), nbytes), REPS_KERNEL),
            "bound_ms": bound_ms, "bound_by": bound_by})
    torch.cuda.synchronize()


def _chain_points(group, k0: int, dk: int, n: int, q: int):
    """Points (k0 + i·dk)·G by repeated host addition, every 9th at
    infinity, with their discrete logs (so the oracle is one host product)."""
    cur = group.scalar_mul(group.generator, k0)
    step = group.scalar_mul(group.generator, dk)
    pts, logs = [], []
    for i in range(n):
        inf = i % 9 == 4
        pts.append(None if inf else cur)
        logs.append(0 if inf else (k0 + i * dk) % q)
        cur = group.add(cur, step)
    return pts, logs


def phase_msm(ctx, name: str) -> None:
    """G1 and G2 MSMs (N_MSM points) against the host oracle:
    Σ s_i·(k_i·G) = (Σ s_i·k_i)·G, one scalar product on curves/; then a
    skewed G1 MSM: scalars mostly 0 and 1, every 8th random, so that window
    0's digit-1 run outgrows a lane (segment_length) and is split; then
    msm_batch of M_BATCH problems on G1 and G2, with one table shared by them
    and one a problem, each problem held to its own msm call and the host
    oracle in affine form (a skewed problem's run split)."""
    import importlib

    import torch

    from gnark_icicle_tpu_torch.ops.ec_t import resident_lanes
    from gnark_icicle_tpu_torch.ops.msm import MSMKernel, msm_host, pick_window, segment_length

    curve = ctx.curve
    rng = random.Random(11)
    q = curve.fr.modulus
    cases = [("g1", curve.g1, ctx.g1, False), ("g2", curve.g2, ctx.g2, False),
             ("g1", curve.g1, ctx.g1, True)]
    for tag, group, tc, skewed in cases:
        n = N_MSM[name][tag]
        pts, logs = _chain_points(group, rng.randrange(1, q), rng.randrange(1, q), n, q)
        scal = [rng.randrange(q) for _ in range(n)]
        scal[:3] = [0, 1, q - 1]
        extra = {}
        if skewed:
            scal = [s if i % 8 == 0 else rng.choice((0, 1, 1)) for i, s in enumerate(scal)]
            ones = sum(1 for s, p in zip(scal, pts) if s == 1 and p is not None)
            seg = segment_length(n, pick_window(n), q.bit_length(), resident_lanes(ctx.device))
            if ones <= seg:
                raise AssertionError("the skewed MSM has no run longer than a lane")
            extra = {"skewed": True, "digit_1_run": ones, "segment": seg}
        t0 = time.perf_counter()
        got = msm_host(tc, curve.fr, pts, scal, ctx.device)
        seconds = time.perf_counter() - t0
        want = group.scalar_mul(group.generator,
                                sum(s * k for s, k in zip(scal, logs)) % q)
        if tag == "g2" and ctx.g2_fp2 and want is not None:
            want = ((want[0].c0, want[0].c1), (want[1].c0, want[1].c1))
        if got != want:
            raise AssertionError(f"{curve.name} {tag} MSM at {n} points differs "
                                 "from the host oracle")
        _say("msm", curve=curve.name, group=tag, points=n, equal=True, seconds=seconds,
             **extra)
    # msm_batch: M_BATCH problems through one launch set, a table shared by
    # them or one a problem; problem 1 random, problem 2 skewed (its digit-1
    # run split), each against its own msm call and the host oracle
    kc = importlib.import_module("gnark_icicle_tpu_torch.ops.cuda")
    for tag, group, tc in (("g1", curve.g1, ctx.g1), ("g2", curve.g2, ctx.g2)):
        n = N_MSM[name][tag]
        kern = MSMKernel(tc, q.bit_length())
        c = pick_window(n)
        for table in ("shared", "per_problem"):
            sets = [_chain_points(group, rng.randrange(1, q), rng.randrange(1, q), n, q)
                    for _ in range(M_BATCH if table == "per_problem" else 1)]
            pts = [pt for pts_, _ in sets for pt in pts_]
            logs = [lg for _, logs_ in sets for lg in logs_] * (M_BATCH // len(sets))
            scal = [[rng.randrange(q) for _ in range(n)] for _ in range(M_BATCH)]
            scal[2] = [s if i % 8 == 0 else rng.choice((0, 1, 1)) for i, s in enumerate(scal[2])]
            tab, inf_rows = (ctx.g1_points if tag == "g1" else ctx.g2_points)(pts)
            inf = inf_rows.reshape(-1, n).expand(M_BATCH, n).contiguous()
            sc = torch.stack([ctx.fr_plain(v) for v in scal])
            seg = segment_length(M_BATCH * n, c, q.bit_length(), resident_lanes(ctx.device))
            starts = {k.name: k.launches for k in kc.KERNELS.values()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = tc.to_affine_host(kern.msm_batch(tab, inf, sc, c))
            seconds = time.perf_counter() - t0
            ran = {k.name[len(kc.CURVES[name]):]: k.launches - starts[k.name]
                   for k in kc.KERNELS.values() if k.launches != starts[k.name]}
            _check_one_set(f"{curve.name} {tag} msm_batch", ran, tc.GROUP)
            for m in range(M_BATCH):
                t_m = tab[m * n:(m + 1) * n] if table == "per_problem" else tab
                want = group.scalar_mul(group.generator, sum(
                    s * k for s, k in zip(scal[m], logs[m * n:(m + 1) * n])) % q)
                if tag == "g2" and ctx.g2_fp2 and want is not None:
                    want = ((want[0].c0, want[0].c1), (want[1].c0, want[1].c1))
                if not got[m] == tc.to_affine_host(kern.msm(t_m, inf[m], sc[m], c))[0] == want:
                    raise AssertionError(f"{curve.name} {tag} msm_batch problem {m} ({table}) "
                                         "differs from its msm and the host oracle")
            ones = sum(1 for s, pt in zip(scal[2], pts[-n:] if table == "per_problem" else pts)
                       if s == 1 and pt is not None)
            if ones <= seg:
                raise AssertionError("the skewed problem of msm_batch has no run longer than a lane")
            _say("msm_batch", curve=curve.name, group=tag, problems=M_BATCH, points=n,
                 table=table, equal=True, seconds=seconds, digit_1_run=ones, segment=seg,
                 launches=ran)


def _check_one_set(label: str, ran: dict, fam: str) -> None:
    """ran (unprefixed entry -> launches) is one MSM launch set of group
    family fam: one *_bucket_accumulate, *_reduce_combine and *_horner, at
    most one *_bucket_reduce."""
    if not (ran.get(f"{fam}_bucket_accumulate") == ran.get(f"{fam}_reduce_combine")
            == ran.get(f"{fam}_horner") == 1 and ran.get(f"{fam}_bucket_reduce", 0) <= 1):
        raise AssertionError(f"{label} is not one launch set: {ran}")


def _profiled(run) -> dict:
    """run() under torch.profiler: wall seconds, device busy seconds (the
    union of the device events' intervals) and device ms of the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        key = e.name.split("(")[0][:80]
        ms, count = by_name.get(key, (0.0, 0))
        by_name[key] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall if spans else None,
            "device_events": len(spans),
            "top": [{"kernel": k, "device_ms": ms, "launches": c} for k, (ms, c) in top]}


def _prove_path(device, name: str, system: str, cs, pub, sec, bad_pub, phase: str,
                **report) -> tuple:
    """Setup, a first prove, one timed prove and one under torch.profiler
    for one compiled circuit on one curve with one proof system ("groth16"
    or "plonk": the port's backend of that name), then verify and a
    tampered public input. The curve's launch counts are set to 0 just
    before setup and read just after the last prove, and must be the path's
    expected ones (_check_launches, by phase). Each prove's stage times and
    setup's split come from the backend's log lines ("<system> prove:
    <stage> took=", "<system> setup: <part> took=, ..."). Returns
    (launches, vk, the timed proof, pk, the batched prove's launches, the
    timed prove's launches)."""
    import importlib

    import torch

    from gnark_icicle_tpu_torch.ops import cuda as kc
    from gnark_icicle_tpu_torch.ops import fixed_base, ntt

    backend = importlib.import_module(f"gnark_icicle_tpu_torch.backend.{system}")
    curve = _curves()[name]
    phases, setup_split = [], {}

    def took(part: str) -> tuple:
        """"<name> took=<seconds>s" -> (name, seconds)"""
        key, secs = part.rsplit(" took=", 1)
        return key.strip(), float(secs.rstrip("s"))

    class Grab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith(f"{system} setup: "):
                setup_split.update((k.replace(" ", "_") + "_s", v) for k, v in
                                   map(took, msg.split(": ", 1)[1].split(", ")))
            elif msg.startswith(f"{system} prove: ") and "took=" in msg \
                    and "curve=" not in msg:
                phases.append(took(msg.split(": ", 1)[1]))

    log = logging.getLogger("gnark_icicle_tpu")
    grab = Grab(level=logging.INFO)
    log.addHandler(grab)
    log.setLevel(logging.INFO)

    # every transform of the path, by its domain's log_n (Domain._transform
    # runs each transform's passes)
    transforms = []
    transform = ntt.Domain._transform

    def counted(dom, *args, **kw):
        transforms.append(dom.log_n)
        return transform(dom, *args, **kw)

    ntt.Domain._transform = counted
    # each build of PLONK's quotient tables: its wall seconds on the card and
    # its Fr launches (the first prove builds them; warm proves reuse them)
    tables = []
    plonk_prove = importlib.import_module("gnark_icicle_tpu_torch.backend.plonk.prove")
    build_tables = plonk_prove._quotient_tables
    fr_entries = ("fr_mont_mul", "fr_sub", "fr_batch_inv")

    def timed_tables(ctx, *args):
        before = len(plonk_prove._DOMAIN_TABLES)
        counts = {e: kc.KERNELS[kc.CURVES[name] + e].launches for e in fr_entries}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build_tables(ctx, *args)
        torch.cuda.synchronize()
        if len(plonk_prove._DOMAIN_TABLES) > before:
            tables.append({"seconds": time.perf_counter() - t0,
                           **{e: kc.KERNELS[kc.CURVES[name] + e].launches - c
                              for e, c in counts.items()}})
        return out

    plonk_prove._quotient_tables = timed_tables
    # setup builds its comb tables, and the first prove the quotient's, as a
    # fresh process would (phase 2 and earlier paths built some on this card)
    fixed_base._TABLES.clear()
    plonk_prove._DOMAIN_TABLES.clear()
    try:
        for k in kc.KERNELS.values():   # count this path's launches only
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pk, vk = backend.setup(cs, curve, rng=random.Random(1), device=device)
        t_setup = time.perf_counter() - t0
        rng = random.Random(2)
        t0 = time.perf_counter()
        backend.prove(cs, pk, pub, sec, curve, rng=rng, device=device)
        t_first = time.perf_counter() - t0
        warm = [_warm_state(name)]
        phases.clear()
        before = _counts(name)
        t0 = time.perf_counter()    # under a fresh rng, for the batched prove
        proof = backend.prove(cs, pk, pub, sec, curve, device=device,
                              rng=random.Random(BATCH_RNG))
        timed = [{"seconds": time.perf_counter() - t0, **dict(phases)}]
        timed_launches = {k: c - before[k] for k, c in _counts(name).items()}
        profiled = _profiled(lambda: backend.prove(cs, pk, pub, sec, curve, rng=rng,
                                                   device=device))
        launches = {k.name: k.launches for k in kc.KERNELS.values() if k.curve == name}
        warm.append(_warm_state(name))
        peak = torch.cuda.max_memory_allocated()
        path_transforms = list(transforms)   # the batched prove's are not the path's
        # one warm prove with batch_msm=True under the timed prove's rng:
        # the same proof, and its own launches and peak bytes
        for k in kc.KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        phases.clear()
        t0 = time.perf_counter()
        proof_b = backend.prove(cs, pk, pub, sec, curve, rng=random.Random(BATCH_RNG),
                                device=device, batch_msm=True)
        batched = {"seconds": time.perf_counter() - t0, **dict(phases),
                   "peak_device_bytes": torch.cuda.max_memory_allocated()}
        launches_b = {k.name: k.launches for k in kc.KERNELS.values() if k.curve == name}
    finally:
        ntt.Domain._transform = transform
        plonk_prove._quotient_tables = build_tables
    log.removeHandler(grab)
    if _fields(proof_b) != _fields(proof):
        raise AssertionError(f"the {name} {phase} proof with batch_msm=True differs")
    _check_batched(name, phase, launches_b)

    t0 = time.perf_counter()
    backend.verify(proof, vk, pub, curve)
    t_verify = time.perf_counter() - t0
    if backend.is_valid(proof, vk, bad_pub, curve):
        raise AssertionError("the verifier accepted a tampered public input")
    domain = pk.domain_log_n if system == "groth16" else pk.log_n
    size = ({"constraints": cs.nb_constraints} if system == "groth16"
            else {"gates": cs.nb_gates})
    _say(phase, curve=curve.name, **size, wires=cs.nb_wires, domain_log_n=domain,
         **report, setup_s=t_setup, setup_split=setup_split, first_prove_s=t_first,
         proves=timed, profiled_prove=profiled, peak_device_bytes=peak,
         verify_s=t_verify, verified=True, tampered_rejected=True,
         **({"quotient_tables": tables} if system == "plonk" else {}))
    per_transform = _check_launches(name, launches, phase, path_transforms, warm, WARM_PROVES,
                                    tables)
    _say("launches", curve=curve.name, path=phase, **launches, transforms=len(path_transforms),
         passes_per_transform=per_transform,
         warm_prove={k: (warm[1][k] - warm[0][k]) / WARM_PROVES for k in warm[0]})
    _say(f"{phase}_batched", curve=curve.name, byte_equal=True, prove=batched,
         launches={k: v for k, v in launches_b.items() if v})
    return launches, vk, proof, pk, launches_b, timed_launches


# the rng of the timed prove and of the batched prove beside it
BATCH_RNG = 3


def _fields(obj) -> dict:
    """A key's or proof's public fields (host ints and points: BW6-761's
    by raw coordinates)."""
    import dataclasses

    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if not f.name.startswith("_")}


# G1 MSMs of a batched prove (batch_msm=True): the Chain's A, B1 and K pad to
# one size (one msm_batch), Z is alone; BW6-761's G2 (B2) runs the g1
# entries too; PLONK's round-1 and round-3 commits are one msm_batch each,
# beside Z's, the linearization's and the two openings' commits
BATCHED_G1_MSMS = {"groth16": 2, "2chain": 3, "plonk": 6}


def _check_batched(name: str, path: str, launches: dict) -> None:
    """The batched prove's MSMs: BATCHED_G1_MSMS launch sets of G1 (one
    *_bucket_accumulate, *_reduce_combine and *_horner each, at most one
    *_bucket_reduce) and on the Chain's curves one of G2 (B2)."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    pre = kc.CURVES[name]
    want = {"g1": BATCHED_G1_MSMS[path], "g2": 1 if path == "groth16" else 0}
    for g, m in want.items():
        got = {e: launches.get(f"{pre}{g}_{e}", 0)
               for e in ("bucket_accumulate", "reduce_combine", "horner", "bucket_reduce")}
        if not (got["bucket_accumulate"] == got["reduce_combine"] == got["horner"] == m
                and got["bucket_reduce"] <= m):
            raise AssertionError(f"the {name} {path} batched prove ran {got} {g} launches "
                                 f"for {m} MSMs")


# proves after the first in _prove_path: one timed, one profiled
WARM_PROVES = 2


def _warm_state(name: str) -> dict:
    """What a warm prove may not add to (the domain tables: domains, their
    twiddle tables and PLONK's quotient tables) and the Fr launches counted
    per warm prove, for _check_launches."""
    import importlib

    from gnark_icicle_tpu_torch.ops import cuda as kc
    from gnark_icicle_tpu_torch.ops import ntt

    plonk_prove = importlib.import_module("gnark_icicle_tpu_torch.backend.plonk.prove")
    pre = kc.CURVES[name]
    return {"domains": len(ntt._DOMAINS),
            "twiddle_tables": sum(len(d._tw) for d in ntt._DOMAINS.values()),
            "quotient_tables": len(plonk_prove._DOMAIN_TABLES),
            **{e: kc.KERNELS[pre + e].launches
               for e in ("fr_mont_mul", "fr_sub", "ntt_pass", "fr_batch_inv")}}


# the Fr entries that only PLONK's path runs
PLONK_FR = ("fr_add", "plonk_quotient", "fr_sub", "fr_batch_inv")
# fr_mont_mul launches of one build of PLONK's quotient tables: _pow_table's
# 2 a doubling up to 2^19 rows, then xs, dens and L1 one each
TABLE_MONT_MULS = 42


def _expectations(name: str, path: str) -> dict:
    """Each kernel entry of a curve (by C symbol) on one path: "ran" (at
    least one launch), "zero" (none) or "any". Fr: fr_mont_mul and ntt_pass
    on every path; fr_add and plonk_quotient on PLONK's only, and fr_sub and
    fr_batch_inv there too (PLONK's quotient tables), no more on Groth16's
    (computeH's pointwise rides ntt_pass). Groups: every entry ran but *_double (no
    caller) and *_add, the fold of
    split buckets, which the Chain (groth16) never runs, the 2-chain always
    and PLONK's commitments where a bucket is split; PLONK has no G2 MSM, so
    no g2_* entry runs there; the running sums run on every path but the
    small PLONK ones (PLONK_LOG < 17), where a window may hold one bucket
    chunk and skip them. *_add_mixed_masked, the one-step wave, has no
    caller since setup's batches run the comb (*_fixed_base, *_normalize),
    so no path launches it."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    pre = kc.CURVES[name]
    plonk = path == "plonk"
    out = {}
    for k in kc.KERNELS.values():
        if k.curve != name:
            continue
        e = k.name[len(pre):]
        g, _, op = e.partition("_")
        if g not in ("g1", "g2"):
            out[k.name] = "ran" if plonk or e not in PLONK_FR else "zero"
        elif op in ("double", "add_mixed_masked") or (plonk and g == "g2"):
            out[k.name] = "zero"
        elif op == "add":
            out[k.name] = {"groth16": "zero", "2chain": "ran", "plonk": "any"}[path]
        elif op == "bucket_reduce":
            out[k.name] = "any" if plonk and PLONK_LOG[name] < 17 else "ran"
        else:
            out[k.name] = "ran"
    return out


def _check_launches(name: str, launches: dict, path: str, transforms: list, warm: list,
                    warm_proves: int, tables: list) -> dict:
    """The path's launches against _expectations; per MSM (one
    *_bucket_accumulate each) one combine, one Horner and at most one
    running-sums launch, so at most three; per fixed-base batch of setup
    one *_fixed_base and one *_normalize; per transform (`transforms`: the
    log_n of each) the passes of pass_split, at most three; warm proves
    (`warm`: _warm_state after the first prove and after the last) build no
    domain table and launch no fr_batch_inv, and on Groth16 paths launch
    fr_mont_mul at most 6 times a prove (the three conversions of a, b, c to
    Montgomery form and h's back) and fr_sub never; a PLONK path builds its
    quotient tables once (`tables`: each build's launches), with one
    fr_batch_inv, one fr_sub and at most TABLE_MONT_MULS fr_mont_mul
    launches. Returns {log_n: passes a transform}."""
    from gnark_icicle_tpu_torch.ops import cuda as kc
    from gnark_icicle_tpu_torch.ops.ntt import pass_split

    bad = [k for k, e in _expectations(name, path).items()
           if {"zero": launches[k] != 0, "ran": launches[k] == 0, "any": False}[e]]
    for g in ("g1", "g2"):
        stem = f"{kc.CURVES[name]}{g}_"
        mine = {k[len(stem):]: c for k, c in launches.items() if k.startswith(stem)}
        if not mine:
            continue
        msms = mine["bucket_accumulate"]
        if not (mine["reduce_combine"] == mine["horner"] == msms
                and mine["bucket_reduce"] <= msms):
            bad.append(f"{stem}reduction: {mine['bucket_reduce']} + {mine['reduce_combine']} "
                       f"+ {mine['horner']} launches for {msms} MSMs")
    per = {log_n: len(pass_split(log_n)) for log_n in sorted(set(transforms))}
    passes = launches[kc.CURVES[name] + "ntt_pass"]
    if not transforms or max(per.values()) > 3 or passes != sum(per[t] for t in transforms):
        bad.append(f"ntt_pass: {passes} launches for {len(transforms)} transforms {per}")
    # setup's fixed-base batches (G1 and G2 on the Chain, BW6-761's G1 and
    # its G2 over Fp through the g1 entries, PLONK's SRS): one *_fixed_base
    # and one *_normalize launch each
    batches = {"groth16": {"g1": 1, "g2": 1}, "2chain": {"g1": 2},
               "plonk": {"g1": 1, "g2": 0}}[path]
    for g, want in batches.items():
        for e in ("fixed_base", "normalize"):
            key = f"{kc.CURVES[name]}{g}_{e}"
            if key in launches and launches[key] != want:
                bad.append(f"{key}: {launches[key]} launches for {want} batches")
    delta = {k: warm[1][k] - warm[0][k] for k in warm[0]}
    if any(delta[k] for k in ("domains", "twiddle_tables", "quotient_tables")):
        bad.append(f"warm proves built domain tables: {delta}")
    if path != "plonk" and (delta["fr_mont_mul"] > 6 * warm_proves or delta["fr_sub"] != 0):
        bad.append(f"warm proves: {delta['fr_mont_mul']} fr_mont_mul, {delta['fr_sub']} fr_sub "
                   f"launches in {warm_proves}")
    if delta["fr_batch_inv"] != 0:
        bad.append(f"warm proves launched fr_batch_inv {delta['fr_batch_inv']} times")
    if path == "plonk" and not (len(tables) == 1 and tables[0]["fr_batch_inv"] == 1
                                and tables[0]["fr_sub"] == 1
                                and tables[0]["fr_mont_mul"] <= TABLE_MONT_MULS):
        bad.append(f"quotient table builds: {tables}")
    if bad:
        raise AssertionError(f"the {name} {path} path's launches are not the expected ones: {bad}")
    return per


def _chain(name: str, steps: int, builder: str) -> tuple:
    """x_{i+1} = x_i² + x_i + i for `steps` steps (bench.py's benchmark
    circuit) compiled for one curve with `builder` ("r1cs" or "scs"): (cs,
    compile seconds, public output)."""
    from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret, compile_circuit

    q = _curves()[name].fr.modulus

    class Chain(Circuit):
        x = Secret()
        out = Public()

        def define(self, api):
            v = self.x
            for i in range(steps):
                v = api.add(api.mul(v, v), v, i)
            api.assert_is_equal(v, self.out)

    t0 = time.perf_counter()
    cs = compile_circuit(q, Chain, builder=builder)
    t_compile = time.perf_counter() - t0
    v = 3
    for i in range(steps):
        v = (v * v + v + i) % q
    return cs, t_compile, v


def chain_circuit(name: str) -> tuple:
    """The 2^17-step Chain (bench.py:431-439) for Groth16: _chain's tuple."""
    return _chain(name, (1 << CHAIN_LOG[name]) - 2, "r1cs")


def plonk_circuit(name: str) -> tuple:
    """The SCS Chain of PLONK_LOG for PLONK (bench.py:359 bench_plonk's
    sizing, about three gates a step): _chain's tuple."""
    return _chain(name, ((1 << PLONK_LOG[name]) - 16) // 3, "scs")


def phase_groth16(device, name: str, compiled: tuple) -> tuple:
    """_prove_path on one curve's compiled Chain (chain_circuit). Returns
    (launches, vk, proof, public inputs, pk, the batched prove's launches,
    the timed prove's launches)."""
    cs, t_compile, v = compiled
    q = _curves()[name].fr.modulus
    launches, vk, proof, pk, batched, timed = _prove_path(device, name, "groth16", cs, [v],
                                                          [3], [(v + 1) % q], "groth16",
                                                          compile_s=t_compile)
    return launches, vk, proof, [v], pk, batched, timed


def _outer_circuit(inner_vk):
    """OuterG16 of tools/run_2chain_device.py: the in-circuit Groth16
    verifier of std/ over an inner BLS12-377 vk. Where the vk has a
    commitment key, the inner proof's commitment and proof of knowledge are
    four more secret words (the BSB22 branch: the commitment wire re-derived
    with the MiMC gadget, the Pedersen proof of knowledge checked by a
    pairing)."""
    from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret
    from gnark_icicle_tpu_torch.std.recursion.native_groth16 import (
        NativeGroth16Verifier, NativeVerifierProof,
    )

    committed = bool(inner_vk.commitment_keys)

    class OuterG16(Circuit):
        inner_pub = Public()
        # ax ay | bx0 bx1 by0 by1 | cx cy (| commitment x y | its pok x y)
        pr = Secret(shape=12 if committed else 8)

        def define(self, api):
            gv = NativeGroth16Verifier(api, inner_vk)
            p = self.pr
            cm = ({"commitments": ((p[8], p[9]),), "commitment_pok": (p[10], p[11])}
                  if committed else {})
            w = NativeVerifierProof(ar=(p[0], p[1]), bs=((p[2], p[3]), (p[4], p[5])),
                                    krs=(p[6], p[7]), **cm)
            gv.assert_proof(w, [self.inner_pub])

    return OuterG16


def _outer_words(pr) -> list:
    """An inner proof's coordinates in OuterG16's order."""
    words = [pr.ar[0], pr.ar[1], pr.bs[0].c0, pr.bs[0].c1, pr.bs[1].c0, pr.bs[1].c1,
             pr.krs[0], pr.krs[1]]
    for cm in pr.commitments:
        words += [cm[0], cm[1], pr.commitment_pok[0], pr.commitment_pok[1]]
    return words


def phase_2chain(device, inner_vk, inner_proof, inner_pub) -> tuple:
    """The BW6-761 outer proof that the BLS12-377 proof of phase 4 verifies:
    _outer_circuit compiled over BW6-761's r (= BLS12-377's p) with the
    port's std/ gadgets, then _prove_path; the tampered input is the inner
    public value + 1. Returns (launches, the batched prove's launches, the
    outer (vk, proof, public inputs))."""
    from gnark_icicle_tpu_torch.curves import bls12_377
    from gnark_icicle_tpu_torch.frontend import compile_circuit

    OuterG16 = _outer_circuit(inner_vk)
    t0 = time.perf_counter()
    cs = compile_circuit(bls12_377.P, OuterG16)
    t_compile = time.perf_counter() - t0
    w = OuterG16(inner_pub=inner_pub[0], pr=_outer_words(inner_proof))
    opub, osec = w.witness_values(bls12_377.P)
    bad = [(inner_pub[0] + 1) % bls12_377.R]
    launches, vk, proof, _, batched, _ = _prove_path(device, "bw6_761", "groth16", cs, opub,
                                                     osec, bad, "2chain", compile_s=t_compile)
    return launches, batched, (vk, proof, opub)


def phase_2chain_committed(device, inner_vk, inner_proof, inner_pub) -> dict:
    """The 2-chain over a committed inner proof: phase bsb22's BLS12-377
    proof made with ("mimc", BW6-761's r), its commitment and proof of
    knowledge among the outer circuit's secrets (_outer_circuit's BSB22
    branch). Compile, setup, a first and a warm prove on the card, verify;
    the inner public input + 1 is rejected by the verifier, and a
    commitment coordinate + 1 leaves the outer system unsatisfied, so that
    the prover refuses it. Returns {path: launches}."""
    from gnark_icicle_tpu_torch.backend import groth16
    from gnark_icicle_tpu_torch.constraint.solver import UnsatisfiedConstraintError
    from gnark_icicle_tpu_torch.curves import bls12_377
    from gnark_icicle_tpu_torch.frontend import compile_circuit

    curve = _curves()["bw6_761"]
    OuterG16 = _outer_circuit(inner_vk)
    t0 = time.perf_counter()
    cs = compile_circuit(bls12_377.P, OuterG16)
    t_compile = time.perf_counter() - t0
    words = _outer_words(inner_proof)
    opub, osec = OuterG16(inner_pub=inner_pub[0], pr=words).witness_values(bls12_377.P)
    _zero_counts()
    t0 = time.perf_counter()
    pk, vk = groth16.setup(cs, curve, rng=random.Random(1), device=device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    groth16.prove(cs, pk, opub, osec, curve, rng=random.Random(2), device=device)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = groth16.prove(cs, pk, opub, osec, curve, rng=random.Random(3), device=device)
    t_prove = time.perf_counter() - t0
    launches = _counts("bw6_761")
    _check_msm_launches("bw6_761", launches, "bw6_761 2chain committed")
    t0 = time.perf_counter()
    groth16.verify(proof, vk, opub, curve)
    t_verify = time.perf_counter() - t0
    if groth16.is_valid(proof, vk, [(inner_pub[0] + 1) % bls12_377.R], curve):
        raise AssertionError("the verifier accepted a tampered inner public input")
    bad = list(words)
    bad[8] = (bad[8] + 1) % bls12_377.P
    bpub, bsec = OuterG16(inner_pub=inner_pub[0], pr=bad).witness_values(bls12_377.P)
    try:
        groth16.prove(cs, pk, bpub, bsec, curve, rng=random.Random(4), device=device)
    except UnsatisfiedConstraintError:
        pass
    else:
        raise AssertionError("the prover accepted a tampered commitment coordinate")
    _say("2chain", curve=curve.name, inner="bls12_377 groth16 with one commitment, "
         "mimc(bw6-761 r)", constraints=cs.nb_constraints, wires=cs.nb_wires,
         domain_log_n=pk.domain_log_n, compile_s=t_compile, setup_s=t_setup,
         first_prove_s=t_first, prove_s=t_prove, verify_s=t_verify, verified=True,
         rejected={"public_input": True, "commitment_coordinate": True},
         launches={k: c for k, c in launches.items() if c})
    return {"2chain_committed": launches}


def phase_plonk(device, name: str, compiled: tuple) -> tuple:
    """_prove_path with the port's PLONK on one curve's compiled SCS Chain
    (plonk_circuit). Returns (launches, vk, proof, pk, the batched prove's
    launches, the timed prove's launches)."""
    cs, t_compile, v = compiled
    q = _curves()[name].fr.modulus
    return _prove_path(device, name, "plonk", cs, [v], [3], [(v + 1) % q], "plonk",
                       compile_s=t_compile)


# phase bsb22: the Chain's curves that carry a BSB22 commitment, on the
# Chain and the SCS Chain of 2^BSB22_LOG (cut from 2^17 to keep the run
# within its time limit)
BSB22_CURVES = ("bn254", "bls12_381")
BSB22_LOG = 15
BSB22_SMALL_STEPS = 40      # BLS12-377's small circuit with the 2-chain's hash


def _commit_chain(name: str, steps: int, builder: str) -> tuple:
    """_chain's circuit with one api.commit over the secret input and two
    intermediate values (after a quarter and half of the steps): (cs,
    compile seconds, public output)."""
    from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret, compile_circuit

    q = _curves()[name].fr.modulus

    class CommitChain(Circuit):
        x = Secret()
        out = Public()

        def define(self, api):
            v = self.x
            kept = []
            for i in range(steps):
                v = api.add(api.mul(v, v), v, i)
                if i in (steps // 4, steps // 2):
                    kept.append(v)
            api.assert_is_different(api.commit(self.x, *kept), 0)
            api.assert_is_equal(v, self.out)

    t0 = time.perf_counter()
    cs = compile_circuit(q, CommitChain, builder=builder)
    t_compile = time.perf_counter() - t0
    v = 3
    for i in range(steps):
        v = (v * v + v + i) % q
    return cs, t_compile, v


# the native solver's schedule of an R1CS, built by its first solve (about
# 25 s at 2^17) and left out of its pickle; small beside the R1CS (its
# staging arrays, which the first solve also builds, are quick to rebuild
# and as large as the R1CS, so they stay behind)
SOLVER_CACHES = ("_levels_cache", "_native_sched_cache")


# phase service: the curve whose Chain (Groth16) and SCS Chain (PLONK) are
# served from gnark's formats
SERVE_CURVE = "bn254"


def _gnark_round_trip(cs, system: str, pub: list, sec: list, res) -> dict:
    """gnark's .r1cs (Groth16) or .scs (PLONK) of a compiled system, read
    back: encode(decode(bytes)) must give the bytes, and the read system
    the original's columns (an R1CS's coefficient values term by term: its
    ids may differ) and commitments; an R1CS is solved once more, to the
    original's wires (res), which builds its solver schedule. Returns the
    read system, its solver caches, the byte count and the seconds to
    write and to read."""
    from gnark_icicle_tpu_torch.constraint.solver import solve
    from gnark_icicle_tpu_torch.io import gnark_cs

    groth = system == "groth16"
    write, read = ((gnark_cs.write_r1cs, gnark_cs.read_r1cs) if groth
                   else (gnark_cs.write_scs, gnark_cs.read_scs))
    t0 = time.perf_counter()
    blob = write(cs)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = read(blob)
    t_read = time.perf_counter() - t0
    if gnark_cs.encode(gnark_cs.decode(blob)) != blob:
        raise AssertionError(f"{system}: encode(decode(bytes)) is not the bytes")
    cols = (("nb_public", "nb_secret", "nb_internal", "term_wire", "l_off", "r_off", "o_off",
             "solved_wire") if groth else
            ("nb_public", "nb_secret", "nb_internal", "xa", "xb", "xc", "ql", "qr", "qm", "qo",
             "qc", "solved_wire", "commitment_tags"))
    bad = [c for c in cols if getattr(back, c) != getattr(cs, c)]
    if groth and [back.coeffs[c] for c in back.term_coeff] != [cs.coeffs[c] for c in cs.term_coeff]:
        bad.append("coefficients")
    if len(back.commitments) != len(cs.commitments):
        bad.append("commitments")
    caches = {}
    if groth:
        if solve(back, pub, sec).wires != res.wires:
            bad.append("wires")
        caches = {k: v for k, v in vars(back).items() if k in SOLVER_CACHES}
    if bad:
        raise AssertionError(f"the {system} system read from gnark's bytes differs: {bad}")
    return {"cs": back, "caches": caches, "bytes": len(blob), "write_s": t_write,
            "read_s": t_read}


def _compile_job(job: tuple) -> tuple:
    """One circuit of the run, by (kind, curve): _chain's tuple, for an
    R1CS its solver caches (SOLVER_CACHES) from one solve of its witness,
    and on SERVE_CURVE's "groth16" and "plonk" the system read back from
    gnark's bytes (_gnark_round_trip), else None. Kinds: "groth16"
    (chain_circuit), "plonk" (plonk_circuit), "bsb22_groth16" and
    "bsb22_plonk" (the same Chains with a commitment, _commit_chain)."""
    from gnark_icicle_tpu_torch.constraint.solver import solve

    os.nice(10)     # nvcc first: the build is the longer job
    kind, name = job
    system = kind.rsplit("_", 1)[-1]
    if kind.startswith("bsb22_"):
        steps = ((1 << BSB22_LOG) - 2 if system == "groth16"
                 else ((1 << BSB22_LOG) - 16) // 3)
        out = _commit_chain(name, steps, "r1cs" if system == "groth16" else "scs")
    else:
        out = (chain_circuit if kind == "groth16" else plonk_circuit)(name)
    caches, res, served = {}, None, None
    if system == "groth16":
        res = solve(out[0], [out[2]], [3])
        caches = {k: v for k, v in vars(out[0]).items() if k in SOLVER_CACHES}
    if kind in ("groth16", "plonk") and name == SERVE_CURVE:
        served = _gnark_round_trip(out[0], system, [out[2]], [3], res)
    return out + (caches, served)


def compile_circuits(jobs: list) -> tuple:
    """The circuits of the run (host Python, while nvcc and phases 2 and 3 run), each in a
    process of its own (spawned, at most one a core): the compiles and the
    R1CS solver schedules are CPU-bound and independent, and each schedule
    would otherwise be built by its circuit's first prove. The native
    solver is built first, once. Returns _chain's tuples in job order and
    the systems read back from gnark's bytes by job (_gnark_round_trip, with
    their solver caches in place)."""
    import multiprocessing

    from gnark_icicle_tpu_torch import native

    native.get_lib()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        done = pool.map(_compile_job, jobs)
    served = {}
    for job, (cs, _, _, caches, read) in zip(jobs, done):
        vars(cs).update(caches)
        if read is not None:
            vars(read["cs"]).update(read.pop("caches"))
            served[job] = read
    return [d[:3] for d in done], served


def _zero_counts() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    for k in kc.KERNELS.values():
        k.launches = 0


def _counts(name: str) -> dict:
    """The launch counts of one curve's kernels, just after a path ran."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    return {k.name: k.launches for k in kc.KERNELS.values() if k.curve == name}


def _check_msm_launches(name: str, launches: dict, label: str) -> None:
    """Every MSM of a run is one launch set: per *_bucket_accumulate one
    *_reduce_combine and one *_horner, at most one *_bucket_reduce; no
    *_double and no *_add_mixed_masked (no caller on any path)."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    pre = kc.CURVES[name]
    for g in ("g1", "g2"):
        get = {e: launches.get(f"{pre}{g}_{e}", 0) for e in
               ("bucket_accumulate", "reduce_combine", "horner", "bucket_reduce", "double",
                "add_mixed_masked")}
        if not (get["bucket_accumulate"] == get["reduce_combine"] == get["horner"]
                and get["bucket_reduce"] <= get["bucket_accumulate"]
                and get["double"] == get["add_mixed_masked"] == 0):
            raise AssertionError(f"{label}: {g} launches {get}")


def _tamper_rejected(backend, proof, vk, pub, curve, **kw) -> dict:
    """A tampered commitment, proof of knowledge (Groth16) and public input:
    each must be rejected."""
    import dataclasses

    g1 = curve.g1
    groth = hasattr(proof, "commitment_pok")
    field = "commitments" if groth else "bsb22_commitments"
    cases = {"commitment": (dataclasses.replace(
        proof, **{field: [g1.add(getattr(proof, field)[0], g1.generator)]}), pub),
        "public_input": (proof, [(pub[0] + 1) % curve.fr.modulus])}
    if groth:
        cases["proof_of_knowledge"] = (dataclasses.replace(
            proof, commitment_pok=g1.add(proof.commitment_pok, g1.generator)), pub)
    for kind, (bad, bad_pub) in cases.items():
        if backend.is_valid(bad, vk, bad_pub, curve, **kw):
            raise AssertionError(f"the verifier accepted a tampered {kind}")
    return {kind: True for kind in cases}


def phase_bsb22(device, name: str, compiled: dict) -> tuple:
    """BSB22 commitments on the card: the Chain of 2^BSB22_LOG with one
    api.commit (_compile_job's "bsb22_*") through Groth16 and PLONK with the "sha256"
    commitment hash: setup, a first prove and a warm prove, verify, and a
    tampered commitment, proof of knowledge and public input rejected; the
    Pedersen commit and proof of knowledge timed on the committed count, and
    every MSM one launch set. Returns ({path: launches}, {system: (cs, pk,
    vk, the warm proof, public inputs)}), the runs for phase deploy."""
    import importlib

    from gnark_icicle_tpu_torch.backend import pedersen

    curve = _curves()[name]
    out, runs = {}, {}
    for system, (cs, t_compile, v) in compiled.items():
        backend = importlib.import_module(f"gnark_icicle_tpu_torch.backend.{system}")
        _zero_counts()
        t0 = time.perf_counter()
        pk, vk = backend.setup(cs, curve, rng=random.Random(1), device=device)
        t_setup = time.perf_counter() - t0
        stages, phases = [], []
        grab = _StageLog(system, phases)
        t0 = time.perf_counter()
        backend.prove(cs, pk, [v], [3], curve, rng=random.Random(2), device=device)
        t_first = time.perf_counter() - t0
        phases.clear()
        t0 = time.perf_counter()
        proof = backend.prove(cs, pk, [v], [3], curve, rng=random.Random(3), device=device)
        stages = {"seconds": time.perf_counter() - t0, **dict(phases)}
        grab.close()
        launches = _counts(name)
        _check_msm_launches(name, launches, f"{name} bsb22 {system}")
        backend.verify(proof, vk, [v], curve)
        rejected = _tamper_rejected(backend, proof, vk, [v], curve)
        extra = {}
        if system == "groth16":
            rng = random.Random(4)
            key = pk.commitment_keys[0]
            vals = [rng.randrange(curve.fr.modulus) for _ in key.basis]
            t0 = time.perf_counter()
            pedersen.commit(curve, key, vals)
            t_commit = time.perf_counter() - t0
            t0 = time.perf_counter()
            pedersen.prove_knowledge(curve, key, vals)
            extra = {"pedersen_committed": len(vals), "pedersen_commit_s": t_commit,
                     "pedersen_pok_s": time.perf_counter() - t0}
        size = ({"constraints": cs.nb_constraints} if system == "groth16"
                else {"gates": cs.nb_gates})
        _say("bsb22", curve=curve.name, system=system, **size, commitments=len(cs.commitments),
             compile_s=t_compile, setup_s=t_setup, first_prove_s=t_first, warm_prove=stages,
             verified=True, rejected=rejected, **extra,
             launches={k: c for k, c in launches.items() if c})
        out[f"bsb22_{system}"] = launches
        runs[system] = (cs, pk, vk, proof, [v])
    return out, runs


def phase_bsb22_mimc(device) -> tuple:
    """BLS12-377 Groth16 with the 2-chain's commitment hash, ("mimc",
    BW6-761's r), on a small Chain with a commitment: setup, prove, verify
    with that hash, a tampered public input rejected. Returns ({path:
    launches}, (vk, proof, public inputs)): the committed 2-chain's inner
    proof."""
    from gnark_icicle_tpu_torch.backend import groth16

    curve = _curves()["bls12_377"]
    h = ("mimc", _curves()["bw6_761"].fr.modulus)
    cs, t_compile, v = _commit_chain("bls12_377", BSB22_SMALL_STEPS, "r1cs")
    _zero_counts()
    pk, vk = groth16.setup(cs, curve, rng=random.Random(1), device=device)
    t0 = time.perf_counter()
    proof = groth16.prove(cs, pk, [v], [3], curve, rng=random.Random(2), device=device,
                          commitment_hash=h)
    t_prove = time.perf_counter() - t0
    launches = _counts("bls12_377")
    _check_msm_launches("bls12_377", launches, "bls12_377 bsb22 mimc")
    groth16.verify(proof, vk, [v], curve, commitment_hash=h)
    if groth16.is_valid(proof, vk, [(v + 1) % curve.fr.modulus], curve):
        raise AssertionError("the verifier accepted a tampered public input")
    _say("bsb22", curve=curve.name, system="groth16", commitment_hash="mimc(bw6-761 r)",
         constraints=cs.nb_constraints, prove_s=t_prove, verified=True,
         tampered_rejected=True, launches={k: c for k, c in launches.items() if c})
    return {"bsb22_mimc": launches}, (vk, proof, [v])


# phase deploy: gnark-icicle's deployment, from ceremony to contract, on
# BN254 (the EVM's curve). The ceremony's Chain has a 2^CEREMONY_LOG domain:
# the ceremony is host code (Python ints, as gnark's mpcsetup is CPU Go), too
# slow for 2^17, whose proofs the contracts check instead
CEREMONY_LOG = 8
CEREMONY_STEPS = 200            # 201 constraints
CEREMONY_CONTRIBUTIONS = 2      # contributions a phase, each verified


def _step(steps: dict, name: str, run):
    """run(), its wall seconds kept in steps[name]."""
    t0 = time.perf_counter()
    out = run()
    steps[name] = time.perf_counter() - t0
    return out


def _bumped(args: list, arg: int, word: int, modulus: int) -> list:
    """verifyProof's arguments with one word + 1 (mod modulus)."""
    out = [list(a) for a in args]
    out[arg][word] = (out[arg][word] + 1) % modulus
    return out


def _deploy_contract(label: str, src: str, args: list, tampers: dict) -> None:
    """One exported verifier in the port's EVM interpreter: the source
    parses, the proof's calldata (args as ABI bytes) is accepted, and each
    tamper (name -> verifyProof's tampered arguments) raises Revert; any
    other exception fails the run. Prints the contract's line."""
    from gnark_icicle_tpu_torch import evm
    from gnark_icicle_tpu_torch.backend import calldata

    t0 = time.perf_counter()
    contract = evm.load_contract(src)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    contract.call_calldata("verifyProof", calldata.encode(args))
    t_call = time.perf_counter() - t0
    reverted = {}
    for kind, bad in tampers.items():
        t0 = time.perf_counter()
        try:
            contract.call("verifyProof", *bad)
        except evm.Revert as e:
            reverted[kind] = {"error": e.error or "(raw)", "call_s": time.perf_counter() - t0}
            continue
        raise AssertionError(f"the {label} contract accepted a tampered {kind}")
    _say("deploy", contract=label, source_bytes=len(src.encode()),
         calldata_words=sum(len(a) for a in args), load_s=t_load, call_s=t_call,
         accepted=True, reverted=reverted)


def _groth16_contract(label: str, vk, proof, pub: list, hash_fn: str = "sha256") -> None:
    """_deploy_contract on export_solidity's contract of a BN254 vk: a
    proof word (Ar's x) + 1 and the public input + 1 must revert, and a
    commitment's x + 1 where the proof has one."""
    from gnark_icicle_tpu_torch.backend import calldata
    from gnark_icicle_tpu_torch.backend.solidity import export_solidity

    curve = _curves()["bn254"]
    p, r = curve.fp.modulus, curve.fr.modulus
    args = calldata.groth16_args(proof, pub)
    tampers = {"proof_word": _bumped(args, 0, 0, p), "public_input": _bumped(args, -1, 0, r)}
    if proof.commitments:
        tampers["commitment"] = _bumped(args, 1, 0, p)
    _deploy_contract(label, export_solidity(vk, curve, hash_fn), args, tampers)


def _plonk_contract(label: str, vk, proof, pub: list) -> None:
    """_deploy_contract on export_plonk_solidity's contract of a BN254 vk: a
    proof word (z(ωζ), word 24) + 1 and the public input + 1 must revert,
    and a commitment's x + 1 where the proof has one."""
    from gnark_icicle_tpu_torch.backend import calldata
    from gnark_icicle_tpu_torch.backend.plonk_solidity import export_plonk_solidity

    curve = _curves()["bn254"]
    p, r = curve.fp.modulus, curve.fr.modulus
    args = calldata.plonk_args(proof, pub)
    tampers = {"proof_word": _bumped(args, 0, 24, r), "public_input": _bumped(args, -1, 0, r)}
    if proof.bsb22_commitments:
        tampers["commitment"] = _bumped(args, 0, len(args[0]) - 2, p)
    _deploy_contract(label, export_plonk_solidity(vk, curve), args, tampers)


def phase_deploy(device, groth16_run: tuple, plonk_run: tuple, bsb22_runs: dict) -> dict:
    """The exported Solidity verifiers run in the port's EVM interpreter on
    proofs made on the card (BN254): phase 4's Chain 2^17 Groth16 vk and
    proof, phase plonk's 2^17 vk and proof (each run: (vk, proof, public
    inputs)), and phase bsb22's committed circuits (bsb22_runs: its runs):
    its Groth16 key proves once more on the card with the EVM commitment
    hash ("evm", "keccak256"), which its contract (hash_fn="keccak256")
    recomputes, and its PLONK proof goes to its contract as it is. Each
    contract accepts its proof and reverts on each tamper. Returns {path:
    launches}."""
    from gnark_icicle_tpu_torch.backend import groth16

    curve = _curves()["bn254"]
    _groth16_contract(f"groth16 chain 2^{CHAIN_LOG['bn254']}", *groth16_run)
    _plonk_contract(f"plonk chain 2^{PLONK_LOG['bn254']}", *plonk_run)
    cs, pk, vk, _, pub = bsb22_runs["groth16"]
    h = ("evm", "keccak256")
    _zero_counts()
    t0 = time.perf_counter()
    proof = groth16.prove(cs, pk, pub, [3], curve, rng=random.Random(5), device=device,
                          commitment_hash=h)
    t_prove = time.perf_counter() - t0
    launches = _counts("bn254")
    _check_msm_launches("bn254", launches, "bn254 deploy groth16 evm hash")
    groth16.verify(proof, vk, pub, curve, commitment_hash=h)
    _say("deploy", curve=curve.name, system="groth16", commitment_hash="evm keccak256",
         constraints=cs.nb_constraints, prove_s=t_prove, verified=True,
         launches={k: c for k, c in launches.items() if c})
    _groth16_contract(f"groth16 bsb22 2^{BSB22_LOG} keccak256", vk, proof, pub, "keccak256")
    _, _, pvk, pproof, ppub = bsb22_runs["plonk"]
    _plonk_contract(f"plonk bsb22 2^{BSB22_LOG}", pvk, pproof, ppub)
    return {"deploy_bsb22_evm": launches}


def ceremony_keys(t_start: float) -> dict:
    """Groth16's MPC ceremony (mpcsetup, host code) for BN254's Chain at a
    2^CEREMONY_LOG domain: Phase1.init, CEREMONY_CONTRIBUTIONS
    contributions, verify; Phase2.init over the compiled system, as many
    contributions, verify, finalize; the keys as their bytes (io/keys,
    io/serialize). It needs no card, so the second process runs it while
    phases 2 and 3 hold the card (main). Returns the compiled system, its
    public output, the key bytes, each step's seconds and when it ran."""
    from gnark_icicle_tpu_torch.backend.groth16.mpcsetup import Phase1, Phase2
    from gnark_icicle_tpu_torch.io import keys, serialize

    at = [time.perf_counter() - t_start]
    curve = _curves()["bn254"]
    n = 1 << CEREMONY_LOG
    cs, t_compile, v = _chain("bn254", CEREMONY_STEPS, "r1cs")
    if not n // 2 < cs.nb_constraints <= n:
        raise AssertionError(f"the ceremony's Chain has {cs.nb_constraints} constraints")
    rng = random.Random(7)
    steps = {"compile": t_compile}
    p1 = _step(steps, "phase1_init", lambda: Phase1.init(curve, n))
    for i in range(CEREMONY_CONTRIBUTIONS):
        _step(steps, f"phase1_contribute_{i + 1}", lambda: p1.contribute(rng=rng))
    _step(steps, "phase1_verify", p1.verify)
    p2 = _step(steps, "phase2_init", lambda: Phase2.init(p1, cs))
    for i in range(CEREMONY_CONTRIBUTIONS):
        _step(steps, f"phase2_contribute_{i + 1}", lambda: p2.contribute(rng=rng))
    _step(steps, "phase2_verify", p2.verify)
    pk, vk = p2.finalize()
    return {"cs": cs, "v": v, "pk": keys.pk_to_bytes(curve, pk, compressed=False),
            "vk": serialize.vk_to_bytes(curve, vk, True), "steps": steps,
            "host_at_s": at + [time.perf_counter() - t_start]}


def phase_ceremony(device, ceremony: dict) -> dict:
    """The ceremony's keys (ceremony_keys) read from their bytes, as phase
    service reads a key; a prove on the card, verify, a tampered input
    rejected, and the exported Groth16 contract, which must accept the
    proof and revert on each tamper. Returns {path: launches}."""
    from gnark_icicle_tpu_torch.backend import groth16
    from gnark_icicle_tpu_torch.io import keys, serialize

    curve = _curves()["bn254"]
    cs, v, steps = ceremony["cs"], ceremony["v"], dict(ceremony["steps"])
    pk = _step(steps, "keys_read", lambda: keys.pk_from_bytes(curve, ceremony["pk"]))
    vk, _ = serialize.vk_from_bytes(curve, ceremony["vk"])
    _zero_counts()
    proof = _step(steps, "prove", lambda: groth16.prove(cs, pk, [v], [3], curve,
                                                        rng=random.Random(8), device=device))
    launches = _counts("bn254")
    _check_msm_launches("bn254", launches, "bn254 ceremony")
    _step(steps, "verify", lambda: groth16.verify(proof, vk, [v], curve))
    if groth16.is_valid(proof, vk, [(v + 1) % curve.fr.modulus], curve):
        raise AssertionError("the verifier accepted a tampered public input")
    total = sum(t for k, t in steps.items() if k.startswith("phase"))
    _say("ceremony", curve=curve.name, domain_log_n=CEREMONY_LOG,
         constraints=cs.nb_constraints, contributions=CEREMONY_CONTRIBUTIONS,
         pk_bytes=len(ceremony["pk"]), vk_bytes=len(ceremony["vk"]), steps=steps,
         ceremony_s=total, host_at_s=ceremony["host_at_s"], verified=True,
         tampered_rejected=True, launches={k: c for k, c in launches.items() if c})
    _groth16_contract(f"groth16 ceremony 2^{CEREMONY_LOG}", vk, proof, [v])
    return {"ceremony": launches}


class _StageLog:
    """Collects "<system> prove: <stage> took=<s>s" log lines into a list
    of (stage, seconds) while open, and the parts of "<system> setup: <part>
    took=<s>s, ..." into the dict `setup` where one is given."""

    def __init__(self, system: str, into: list, setup: dict | None = None):
        self.system, self.into = system, into
        self.log = logging.getLogger("gnark_icicle_tpu")
        self.log.setLevel(logging.INFO)
        outer = self

        def took(part: str) -> tuple:
            key, secs = part.rsplit(" took=", 1)
            return key.strip(), float(secs.rstrip("s"))

        class Grab(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if setup is not None and msg.startswith(f"{outer.system} setup: "):
                    setup.update((k.replace(" ", "_") + "_s", v) for k, v in
                                 map(took, msg.split(": ", 1)[1].split(", ")))
                elif msg.startswith(f"{outer.system} prove: ") and "took=" in msg \
                        and "curve=" not in msg:
                    outer.into.append(took(msg.split(": ", 1)[1]))

        self.handler = Grab(level=logging.INFO)
        self.log.addHandler(self.handler)

    def close(self):
        self.log.removeHandler(self.handler)


def phase_checkpoint(device, name: str, runs: dict) -> dict:
    """checkpoint_dir in both provers on the card: for Groth16 and PLONK on
    the curve's Chain (runs: {system: (cs, pk, vk, public, secret, the
    uninterrupted proof under random.Random(BATCH_RNG))}), a fresh prove
    into a temporary directory, a resume after the last stage's file is
    deleted, and a full resume, each under that rng: each verifies and
    equals the uninterrupted proof; the seconds each resume saves. Returns
    {path: launches}."""
    import importlib
    import tempfile

    curve = _curves()[name]
    last = {"groth16": "msms.pkl", "plonk": "quotient.pkl"}
    out = {}
    for system, (cs, pk, vk, pub, sec, want) in runs.items():
        backend = importlib.import_module(f"gnark_icicle_tpu_torch.backend.{system}")
        _zero_counts()
        times = {}
        with tempfile.TemporaryDirectory() as d:
            for step in ("fresh", "partial_resume", "full_resume"):
                if step == "partial_resume":
                    os.unlink(os.path.join(d, last[system]))
                t0 = time.perf_counter()
                proof = backend.prove(cs, pk, pub, sec, curve, rng=random.Random(BATCH_RNG),
                                      device=device, checkpoint_dir=d)
                times[f"{step}_s"] = time.perf_counter() - t0
                if _fields(proof) != _fields(want):
                    raise AssertionError(f"the {system} {step} proof differs from the "
                                         "uninterrupted one")
                backend.verify(proof, vk, pub, curve)
            files = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
        launches = _counts(name)
        _say("checkpoint", curve=curve.name, system=system, stage_files=files, **times,
             saved_partial_s=times["fresh_s"] - times["partial_resume_s"],
             saved_full_s=times["fresh_s"] - times["full_resume_s"], byte_equal=True,
             verified=True, launches={k: c for k, c in launches.items() if c})
        out[f"checkpoint_{system}"] = launches
    return out


# the __global__ function that each entry launches (unprefixed entry, or the
# op of a g1_/g2_ entry), as a profiler trace names its launches
SYMBOLS = {"fr_mont_mul": "k_fr_mont_mul", "fr_sub": "k_fr_sub", "fr_add": "k_fr_add",
           "plonk_quotient": "k_plonk_quotient", "fr_batch_inv": "k_fr_batch_inv",
           "ntt_pass": "k_ntt_pass", "add": "k_add", "double": "k_double",
           "add_mixed_masked": "k_mixed_accumulate", "bucket_accumulate": "k_mixed_accumulate",
           "fixed_base": "k_mixed_accumulate", "normalize": "k_normalize",
           "bucket_reduce": "k_reduce", "reduce_combine": "k_reduce", "horner": "k_horner"}


def _trace_symbol(kernel: str) -> tuple:
    """A trace's kernel name -> (function, over Fp2): "void
    k_reduce<Elt2<FpP>, B3Row>(ReduceArgs)" -> ("k_reduce", True)."""
    base = kernel.removeprefix("void ").split("(")[0]
    sym = base.split("<")[0]
    return sym, base.startswith(sym + "<Elt2<")


def _check_trace(name: str, path: str, launches: dict) -> dict:
    """One served request's trace (profile.device_trace): the file holds
    the annotated region ("request") and names every kernel that the launch
    counts say ran, as often: per (function, over Fp2) its kernel events
    equal the launches of the entries that run it. Returns the device ms
    and launches by kernel that the trace gives, the port's first."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    if not any(e.get("name") == "request" and e.get("cat") == "user_annotation"
               for e in events):
        raise AssertionError(f"{path} holds no annotated region")
    pre = kc.CURVES[name]
    want, got, by_kernel = {}, {}, {}
    for k, c in launches.items():
        g, _, op = k[len(pre):].partition("_")
        key = (SYMBOLS[op], g == "g2") if g in ("g1", "g2") else (SYMBOLS[k[len(pre):]], False)
        want[key] = want.get(key, 0) + c
    for e in events:
        if e.get("cat") == "kernel":
            key = _trace_symbol(e["name"])
            got[key] = got.get(key, 0) + 1
            ms, n = by_kernel.get(e["name"], (0.0, 0))
            by_kernel[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    off = {f"{s}{'<Elt2>' if fp2 else ''}": (n, got.get((s, fp2), 0))
           for (s, fp2), n in want.items() if got.get((s, fp2), 0) != n}
    if off:
        raise AssertionError(f"the {name} trace's kernels are not the launches "
                             f"(launches, trace events): {off}")
    ours = {s for s, _ in want}
    rows = sorted(by_kernel.items(), key=lambda kv: (_trace_symbol(kv[0])[0] not in ours,
                                                     -kv[1][0]))
    return {"file_bytes": os.path.getsize(path),
            "device_ms": sum(ms for ms, _ in by_kernel.values()),
            "kernels": [{"kernel": k.split("(")[0][:80], "device_ms": ms, "launches": n}
                        for k, (ms, n) in rows[:16]]}


def ctx_seconds(curve, device, reps: int = 5) -> dict:
    """DeviceCtx's constructor on one device: a build, its cache entry
    dropped first (what every prove, setup and KZG paid before the cache),
    and a lookup of the cached one (what each pays now); medians of reps."""
    import statistics

    from gnark_icicle_tpu_torch.device import DeviceCtx

    build, lookup = [], []
    for _ in range(reps):
        DeviceCtx._cache.pop((curve.name, DeviceCtx(curve, device).device))
        t0 = time.perf_counter()
        DeviceCtx(curve, device)
        build.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        DeviceCtx(curve, device)
        lookup.append(time.perf_counter() - t0)
    return {"build_s": statistics.median(build), "cached_s": statistics.median(lookup)}


def _chain_out(name: str, steps: int, x: int) -> int:
    q = _curves()[name].fr.modulus
    v = x
    for i in range(steps):
        v = (v * v + v + i) % q
    return v


# phase service: the requests a served system answers (secret inputs); the
# first is the timed prove's witness, under its rng, so that its bytes are
# the direct prove's; the last runs under profile.device_trace
SERVE_REQUESTS = {"groth16": (3, 5, 7), "plonk": (3, 5)}


def phase_service(device, served: dict, runs: dict, others: dict) -> dict:
    """Serve SERVE_CURVE's Chain (Groth16) and SCS Chain (PLONK) from gnark's
    formats on the card: the systems read from gnark's bytes in the compile
    workers (served: {system: _gnark_round_trip's dict}); the keys of the
    paths' setups (runs: {system: (pk, vk, the timed proof, its public
    inputs, the timed prove's launches)}), Groth16's proving key and both
    vks through their bytes (PLONK's proving key has no encoding in either
    package, so it stays in memory); a resident Groth16Prover/PlonkProver
    on the card, its warm-up timed; then SERVE_REQUESTS, each witness
    through its bytes and each proof through its bytes, verified against
    the read vk; the first byte-equal to the direct prove's; each request's
    launches equal to the timed prove's; the last under
    profile.device_trace and annotate (_check_trace); a proof with one
    flipped coordinate bit refused. Then service_others(others). Returns
    {path: launches}."""
    import statistics
    import tempfile

    from gnark_icicle_tpu_torch import profile
    from gnark_icicle_tpu_torch.backend import groth16, plonk
    from gnark_icicle_tpu_torch.backend.prover_service import Groth16Prover, PlonkProver
    from gnark_icicle_tpu_torch.io import keys, plonk_serialize, serialize

    name = SERVE_CURVE
    curve = _curves()[name]
    codec = {"groth16": (groth16, Groth16Prover, serialize.proof_to_bytes,
                         serialize.proof_from_bytes, serialize.vk_to_bytes,
                         serialize.vk_from_bytes),
             "plonk": (plonk, PlonkProver, plonk_serialize.plonk_proof_to_bytes,
                       plonk_serialize.plonk_proof_from_bytes, plonk_serialize.plonk_vk_to_bytes,
                       plonk_serialize.plonk_vk_from_bytes)}
    steps = {"groth16": (1 << CHAIN_LOG[name]) - 2, "plonk": ((1 << PLONK_LOG[name]) - 16) // 3}
    out = {}
    _say("service", curve=curve.name, device_ctx=ctx_seconds(curve, device))
    for system, (backend, Prover, proof_to, proof_from, vk_to, vk_from) in codec.items():
        read = served[system, name]
        pk, vk, direct, pub0, timed = runs[system]
        report = {"system_bytes": read["bytes"], "system_write_s": read["write_s"],
                  "system_read_s": read["read_s"]}
        t0 = time.perf_counter()
        vk_bytes = vk_to(curve, vk)
        report["vk_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        read_vk, _ = vk_from(curve, vk_bytes)
        report["vk_read_s"], report["vk_bytes"] = time.perf_counter() - t0, len(vk_bytes)
        if _fields(read_vk) != _fields(vk):
            raise AssertionError(f"the {system} vk read from bytes differs")
        served_pk = pk
        if system == "groth16":
            t0 = time.perf_counter()
            pk_bytes = keys.pk_to_bytes(curve, pk, compressed=False)
            report["pk_write_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            served_pk = keys.pk_from_bytes(curve, pk_bytes)
            report["pk_read_s"], report["pk_bytes"] = time.perf_counter() - t0, len(pk_bytes)
            if _fields(served_pk) != _fields(pk):
                raise AssertionError("the proving key read from bytes differs")
            del pk_bytes
        total = {}

        def add(counts):
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c

        _zero_counts()
        prover = Prover(read["cs"], served_pk, curve, device=device)
        x0 = SERVE_REQUESTS[system][0]
        report["first_prove_s"] = prover.warmup(
            [_chain_out(name, steps[system], x0)], [x0], rng=random.Random(11))
        add(_counts(name))
        requests = []
        for i, x in enumerate(SERVE_REQUESTS[system]):
            pub, sec = serialize.witness_from_bytes(
                curve, serialize.witness_to_bytes(curve, [_chain_out(name, steps[system], x)],
                                                  [x]))
            traced = i == len(SERVE_REQUESTS[system]) - 1
            rng = random.Random(BATCH_RNG if i == 0 else 20 + i)
            with tempfile.TemporaryDirectory() as d:
                _zero_counts()
                t0 = time.perf_counter()
                if traced:
                    with profile.device_trace(d, device=device) as trace:
                        with profile.annotate("request"):
                            proof = prover.prove(pub, sec, rng=rng)
                else:
                    proof = prover.prove(pub, sec, rng=rng)
                seconds = time.perf_counter() - t0
                launches = _counts(name)
                add(launches)
                trace_info = _check_trace(name, trace.path, launches) if traced else None
            if launches != timed:
                off = {k: (c, timed[k]) for k, c in launches.items() if c != timed[k]}
                raise AssertionError(f"the {system} request {i} ran {off} launches where the "
                                     "timed prove ran the second")
            data = proof_to(curve, proof)
            t0 = time.perf_counter()
            back, used = proof_from(curve, data)
            t_read = time.perf_counter() - t0
            if used != len(data) or _fields(back) != _fields(proof):
                raise AssertionError(f"the {system} proof read from bytes differs")
            t0 = time.perf_counter()
            backend.verify(back, read_vk, pub, curve)
            t_verify = time.perf_counter() - t0
            row = {"x": x, "seconds": seconds, "proof_bytes": len(data), "proof_read_s": t_read,
                   "verify_s": t_verify, "traced": traced}
            if i == 0:
                if pub != pub0 or data != proof_to(curve, direct):
                    raise AssertionError(f"the served {system} proof is not the direct one")
                row["byte_equal_to_direct"] = True
                # one flipped bit of the first point's x: refused when read or
                # when verified
                bad = bytearray(data)
                bad[curve.fp.nb_bytes - 1] ^= 1
                try:
                    tampered, _ = proof_from(curve, bytes(bad))
                except ValueError:
                    row["flipped_bit_refused"] = "read"
                else:
                    if backend.is_valid(tampered, read_vk, pub, curve):
                        raise AssertionError(f"a {system} proof with a flipped bit verified")
                    row["flipped_bit_refused"] = "verify"
            if traced:
                row["trace"] = trace_info
            requests.append(row)
        untraced = [r["seconds"] for r in requests if not r["traced"]]
        _say("service", curve=curve.name, system=system, **report, requests=requests,
             marginal_s=statistics.median(r["seconds"] for r in requests),
             marginal_untraced_s=statistics.median(untraced),
             launches_equal_timed_prove=True, launches={k: c for k, c in timed.items() if c})
        out[f"service_{system}"] = total
    service_others(others)
    return out


def service_others(others: list) -> None:
    """Other curves' proofs and vks (others: [(curve, system, vk, proof,
    public inputs)]) through their bytes, compressed where the curve's p ≡ 3
    (mod 4), and verified again."""
    from gnark_icicle_tpu_torch.backend import groth16, plonk
    from gnark_icicle_tpu_torch.io import plonk_serialize, serialize

    codec = {"groth16": (groth16, serialize.proof_to_bytes, serialize.proof_from_bytes,
                         serialize.vk_to_bytes, serialize.vk_from_bytes),
             "plonk": (plonk, plonk_serialize.plonk_proof_to_bytes,
                       plonk_serialize.plonk_proof_from_bytes, plonk_serialize.plonk_vk_to_bytes,
                       plonk_serialize.plonk_vk_from_bytes)}
    for oname, system, vk, proof, pub in others:
        oc = _curves()[oname]
        backend, proof_to, proof_from, vk_to, vk_from = codec[system]
        compressed = oc.fp.modulus % 4 == 3
        data, vk_bytes = proof_to(oc, proof, compressed), vk_to(oc, vk, compressed)
        t0 = time.perf_counter()
        back, _ = proof_from(oc, data)
        read_vk, _ = vk_from(oc, vk_bytes)
        t_read = time.perf_counter() - t0
        if _fields(back) != _fields(proof) or _fields(read_vk) != _fields(vk):
            raise AssertionError(f"the {oname} {system} proof or vk read from bytes differs")
        backend.verify(back, read_vk, pub, oc)
        _say("service", curve=oc.name, system=system, compressed=compressed,
             proof_bytes=len(data), vk_bytes=len(vk_bytes), read_s=t_read, verified=True)


# the paths that run in a second process (_other_lane) beside SERVE_CURVE's
# and BLS12-381's PLONK: phase 4 on BLS12-381 and BLS12-377 (whose proof the
# 2-chain verifies), the 2-chain, PLONK on the small circuits, BSB22 on
# BLS12-381, the MiMC commitment hash and the committed 2-chain over it, and
# the ceremony. The paths are host-bound (a
# Chain prove's solve is 90 % of it, PERF.md §5), so two of them share the
# card and the host's cores; the served requests run once this lane has
# ended, alone.
LANE_CHAIN = ("bls12_381", "bls12_377")
LANE_PLONK = ("bls12_377", "bw6_761")
LANE_BSB22 = ("bls12_381",)


def _solver_caches(systems: list) -> list:
    """Each system's solver caches (SOLVER_CACHES), which its pickle leaves
    out: a spawned process puts them back (_other_lane), or its first prove
    would build the schedule again."""
    return [{k: v for k, v in vars(cs).items() if k in SOLVER_CACHES} for cs in systems]


def _other_lane(t_start: float, compiled: dict, compiled_scs: dict,
                compiled_bsb22: dict, caches: list, ceremony: dict) -> tuple:
    """The LANE_* paths in a process of their own (spawned, with launch
    counts of its own, set to 0 before each path as in the main process),
    the committed 2-chain over phase bsb22's MiMC-hashed proof, then their
    proofs and vks through their bytes (service_others), then the
    ceremony's keys (`ceremony`: ceremony_keys, which this process ran
    before) on the card.
    `caches`: _solver_caches of the R1CS systems of `compiled` and then of
    `compiled_bsb22`'s Groth16 ones, in order. Its proofs of phase
    recursion go to the recursion lane (send_recursion). Returns (paths,
    extra) as main keeps them, and the count of checks it sent there."""
    import torch

    from gnark_icicle_tpu_torch.ops import cuda as kc

    _START["t"] = t_start
    r1cs = ([c[0] for c in compiled.values()]
            + [systems["groth16"][0] for systems in compiled_bsb22.values()])
    for cs, cache in zip(r1cs, caches, strict=True):
        vars(cs).update(cache)
    device = torch.device("cuda", 0)
    kc.load_all()
    paths, extra, others, inner = [], [], [], None
    for name in LANE_CHAIN:
        counts, vk, proof, pub, _, batched, _ = phase_groth16(device, name, compiled[name])
        paths.append((name, "groth16", counts))
        extra.append((name, "groth16_batched", batched))
        others.append((name, "groth16", vk, proof, pub))
        if name == "bls12_377":
            inner = (vk, proof, pub)
        if name == "bls12_381":     # phase recursion: the cross-curve verifier
            send_recursion(groth16_job(name, vk, proof, pub, "bls12-381 chain 2^17"))
    counts, batched, outer = phase_2chain(device, *inner)
    paths.append(("bw6_761", "2chain", counts))
    extra.append(("bw6_761", "2chain_batched", batched))
    send_recursion(groth16_job("bw6_761", *outer, "bw6-761 2-chain outer proof (the wrap)"))
    for name in LANE_PLONK:
        counts, vk, proof, pk, batched, _ = phase_plonk(device, name, compiled_scs[name])
        paths.append((name, "plonk", counts))
        extra.append((name, "plonk_batched", batched))
        if name in CHAIN_CURVES:
            others.append((name, "plonk", vk, proof, [compiled_scs[name][2]]))
        if name == "bls12_377":     # phase recursion: the native PLONK verifier
            extra += [(name, path, c) for path, c in phase_recursion_card(
                device, name, compiled_scs[name], pk, vk).items()]
    for name in LANE_BSB22:
        extra += [(name, path, c) for path, c in
                  phase_bsb22(device, name, compiled_bsb22[name])[0].items()]
    mimc_counts, committed_inner = phase_bsb22_mimc(device)
    extra += [("bls12_377", path, c) for path, c in mimc_counts.items()]
    extra += [("bw6_761", path, c) for path, c in
              phase_2chain_committed(device, *committed_inner).items()]
    service_others(others)
    extra += [("bn254", path, c) for path, c in phase_ceremony(device, ceremony).items()]
    return paths, extra, _REC["sent"]


# phase precompiles: the zkEVM precompile circuits over the emulated-field
# layer (std/emulated.py's deferred mulcheck, rangecheck and logderivlookup
# under one multicommit api.commit), on BN254 in a third process
# (_lane): ecrecover (0x01) through Groth16 at its full size,
# ecAdd (0x06) through PLONK
ECRECOVER_CONSTRAINTS = 867_307    # tests/test_evmprecompiles_compiled.py:28
PRECOMPILES_LOG = 20               # its domain: phase 2 checks BN254's ntt_pass there too
ECRECOVER_COMMITTED = 710_886      # its privately committed wires: the Pedersen MSMs' size
ECADD_GATES = 17_527               # EcAdd under the SCS builder
PEDERSEN_SPOT = 16                 # Pedersen basis points held to host scalar products


def _limbs(value: int, params) -> list:
    return [(value >> (params.limb_bits * i)) & ((1 << params.limb_bits) - 1)
            for i in range(params.n_limbs)]


def precompile_circuits() -> tuple:
    """EcRecover and EcAdd over the port's gadgets, copied from
    tests/test_evmprecompiles_compiled.py:122-160 and :36-50: a secp256k1
    public key recovered from (msg, v, r, s) and a BN254 G1 sum, each held
    to points given as emulated limbs."""
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.frontend import Circuit, Secret
    from gnark_icicle_tpu_torch.std import evmprecompiles as evm
    from gnark_icicle_tpu_torch.std.sw_emulated import BN254G1, SECP256K1, EmulatedCurve

    q, sfr, sfp, fp = bn254.R, SECP256K1.fr, SECP256K1.fp, BN254G1.fp

    class EcRecover(Circuit):
        msg = Secret(shape=sfr.n_limbs)
        v = Secret()
        r = Secret(shape=sfr.n_limbs)
        s = Secret(shape=sfr.n_limbs)
        pubx = Secret(shape=sfp.n_limbs)
        puby = Secret(shape=sfp.n_limbs)

        def define(self, api):
            c = EmulatedCurve(api, SECP256K1, q)
            fr = c.fr
            P = evm.ec_recover(api, q, fr.from_limbs(self.msg), self.v,
                               fr.from_limbs(self.r), fr.from_limbs(self.s))
            c.assert_is_equal(P, c.witness_point(self.pubx, self.puby))

    class EcAdd(Circuit):
        px = Secret(shape=fp.n_limbs)
        py = Secret(shape=fp.n_limbs)
        qx = Secret(shape=fp.n_limbs)
        qy = Secret(shape=fp.n_limbs)
        rx = Secret(shape=fp.n_limbs)
        ry = Secret(shape=fp.n_limbs)

        def define(self, api):
            c = EmulatedCurve(api, BN254G1, q)
            out = evm.ec_add(api, q, c.witness_point(self.px, self.py),
                             c.witness_point(self.qx, self.qy))
            c.assert_is_equal(out, c.witness_point(self.rx, self.ry))

    return EcRecover, EcAdd


def ecrecover_witness(seed: int) -> tuple:
    """A secp256k1 key and an RFC 6979 signature of a random message from
    the port's curves/secp256k1.py, v the recovery parity: the EcRecover
    secrets for the true key and for the key of priv + 1."""
    from gnark_icicle_tpu_torch.curves import secp256k1
    from gnark_icicle_tpu_torch.std import evmprecompiles as evm
    from gnark_icicle_tpu_torch.std.sw_emulated import SECP256K1

    rng = random.Random(seed)
    priv, pub = secp256k1.keygen(rng)
    msg = rng.randrange(1, secp256k1.N)
    r, s = secp256k1.sign(priv, msg)
    if not secp256k1.verify(pub, msg, (r, s)):
        raise AssertionError("the host secp256k1 signature does not verify")
    v = next(v for v in (0, 1) if evm._recover_host(msg, v, r, s) == pub)
    bad = secp256k1.G1.scalar_mul(secp256k1.G1.generator, priv + 1)
    sfr, sfp = SECP256K1.fr, SECP256K1.fp

    def sec(point):
        return (_limbs(msg, sfr) + [v] + _limbs(r, sfr) + _limbs(s, sfr)
                + _limbs(point[0], sfp) + _limbs(point[1], sfp))

    return sec(pub), sec(bad)


def ecadd_witness(seed: int) -> list:
    """EcAdd's secrets: two random BN254 G1 points and their sum."""
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.std.sw_emulated import BN254G1

    rng = random.Random(seed)
    g1, fp = bn254.G1, BN254G1.fp
    p, q = g1.random_point(rng), g1.random_point(rng)
    return [w for pt in (p, q, g1.add(p, q)) for c in pt for w in _limbs(c, fp)]


def precompiles_host() -> dict:
    """The host part of phase precompiles, which needs no card: EcRecover
    compiled (ECRECOVER_CONSTRAINTS, ECRECOVER_COMMITTED), solved once (which
    builds its solver schedule) and solved with the key of priv + 1, which
    the solver must refuse; EcAdd compiled with the SCS builder."""
    from gnark_icicle_tpu_torch.constraint.solver import UnsatisfiedConstraintError, solve
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.frontend import compile_circuit

    EcRecover, EcAdd = precompile_circuits()
    sec, bad = ecrecover_witness(41)
    t = {}
    t0 = time.perf_counter()
    cs = compile_circuit(bn254.R, EcRecover)
    t["compile_s"] = time.perf_counter() - t0
    committed = sum(len(c.private_committed) for c in cs.commitments)
    if (cs.nb_constraints, committed) != (ECRECOVER_CONSTRAINTS, ECRECOVER_COMMITTED):
        raise AssertionError(f"EcRecover: {cs.nb_constraints} constraints, {committed} "
                             f"committed wires")
    t0 = time.perf_counter()
    solve(cs, [], sec)
    t["solve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        solve(cs, [], bad)
    except UnsatisfiedConstraintError:
        t["wrong_key_refused_s"] = time.perf_counter() - t0
    else:
        raise AssertionError("the solver accepted the key of priv + 1")
    t0 = time.perf_counter()
    scs = compile_circuit(bn254.R, EcAdd, builder="scs")
    t["ecadd_compile_s"] = time.perf_counter() - t0
    if scs.nb_gates != ECADD_GATES or len(scs.commitments) != 1:
        raise AssertionError(f"EcAdd: {scs.nb_gates} gates, {len(scs.commitments)} commitments")
    _say("precompiles", part="host", circuit="ecrecover", constraints=cs.nb_constraints,
         wires=cs.nb_wires, committed_wires=committed, commitments=len(cs.commitments),
         ecadd_gates=scs.nb_gates, wrong_key_refused=True, **t)
    return {"ecrecover": (cs, sec), "ecadd": (scs, ecadd_witness(7))}


def phase_precompiles_ecrecover(device, cs, sec) -> dict:
    """EcRecover through Groth16 on the card: setup (its host/points split),
    a first prove, one warm prove under torch.profiler (its stage times,
    launches and device ms by kernel, busy share, peak device bytes). The
    two Pedersen MSMs of the commitment (prove._pedersen_msms) are one
    launch set of the G1 MSM kernels; the commitment and proof of knowledge
    equal the host's pedersen.commit and prove_knowledge of the same values,
    computed by linearity from setup's scalars (basisᵢ = sᵢ·G, held to the
    host's scalar products at PEDERSEN_SPOT points); the proof verifies,
    and Ar replaced by 2·Ar, the commitment + G and the proof of knowledge +
    G are rejected. Returns {path: launches}."""
    import dataclasses
    import importlib

    import torch

    from gnark_icicle_tpu_torch.backend import groth16

    prove_mod = importlib.import_module("gnark_icicle_tpu_torch.backend.groth16.prove")
    setup_mod = importlib.import_module("gnark_icicle_tpu_torch.backend.groth16.setup")

    curve = _curves()["bn254"]
    g1, r = curve.g1, curve.fr.modulus
    phases, split = [], {}
    grab = _StageLog("groth16", phases, split)
    g1_batches, pedersen_runs = [], []
    batch, pedersen_msms = setup_mod.batch_scalar_mul_host, prove_mod._pedersen_msms

    def recorded_batch(tc, grp, base, scalars, *args, **kw):
        if grp is g1:
            g1_batches.append(scalars)
        return batch(tc, grp, base, scalars, *args, **kw)

    def counted_pedersen(ctx, pk, i, values):
        """_pedersen_msms with its launches, its seconds and those of its
        msm_batch alone (the card's part: digits, sort, the kernels)."""
        kernel, inner = ctx.msm_g1, []

        def timed_batch(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = type(kernel).msm_batch(kernel, *args)
            torch.cuda.synchronize()
            inner.append(time.perf_counter() - t0)
            return res

        before = _counts("bn254")
        kernel.msm_batch = timed_batch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pedersen_msms(ctx, pk, i, values)
            torch.cuda.synchronize()
        finally:
            del kernel.msm_batch
        pedersen_runs.append({"values": values, "out": out, "seconds": time.perf_counter() - t0,
                              "msm_batch_s": inner,
                              "launches": {k: c - before[k] for k, c in _counts("bn254").items()
                                           if c != before[k]}})
        return out

    setup_mod.batch_scalar_mul_host, prove_mod._pedersen_msms = recorded_batch, counted_pedersen
    try:
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pk, vk = groth16.setup(cs, curve, rng=random.Random(1), device=device)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        groth16.prove(cs, pk, [], sec, curve, rng=random.Random(2), device=device)
        t_first = time.perf_counter() - t0
        first_phases = dict(phases)
        phases.clear()
        before = _counts("bn254")
        holder = {}
        profiled = _profiled(lambda: holder.setdefault("proof", groth16.prove(
            cs, pk, [], sec, curve, rng=random.Random(3), device=device)))
        launches = _counts("bn254")
        peak = torch.cuda.max_memory_allocated()
    finally:
        setup_mod.batch_scalar_mul_host, prove_mod._pedersen_msms = batch, pedersen_msms
        grab.close()
    proof = holder["proof"]
    warm = {k: c - before[k] for k, c in launches.items() if c != before[k]}
    _check_msm_launches("bn254", launches, "bn254 precompiles ecrecover")
    # the warm prove's Pedersen MSMs: one msm_batch, one launch set
    run = pedersen_runs[-1]
    _check_one_set("the Pedersen commitment and proof of knowledge", run["launches"], "g1")
    n = len(pk.commitment_keys[0].basis)
    if len(pedersen_runs) != 2 or n != ECRECOVER_COMMITTED or len(run["values"]) != n \
            or len(run["msm_batch_s"]) != 1:
        raise AssertionError(f"Pedersen MSMs: {len(pedersen_runs)} runs over {n} bases")
    scal = g1_batches[0]
    s, s_sigma = scal[len(scal) - 2 * n:len(scal) - n], scal[len(scal) - n:]
    key, gen = pk.commitment_keys[0], g1.generator
    rng = random.Random(5)
    for i in rng.sample(range(n), PEDERSEN_SPOT):
        if (key.basis[i], key.basis_exp_sigma[i]) != (g1.scalar_mul(gen, s[i]),
                                                      g1.scalar_mul(gen, s_sigma[i])):
            raise AssertionError(f"Pedersen basis point {i} is not its scalar's product")
    vals = run["values"]
    host_cm = g1.scalar_mul(gen, sum(v * w for v, w in zip(vals, s)) % r)
    host_pok = g1.scalar_mul(gen, sum(v * w for v, w in zip(vals, s_sigma)) % r)
    if (proof.commitments[0], run["out"][0]) != (host_cm, host_cm) or \
            (run["out"][1], proof.commitment_pok) != (host_pok, host_pok):
        raise AssertionError("the card's Pedersen commitment or proof of knowledge is not "
                             "the host's")
    t0 = time.perf_counter()
    groth16.verify(proof, vk, [], curve)
    t_verify = time.perf_counter() - t0
    tampers = {"ar_doubled": dataclasses.replace(proof, ar=g1.scalar_mul(proof.ar, 2)),
               "commitment_plus_g": dataclasses.replace(
                   proof, commitments=[g1.add(proof.commitments[0], gen)]),
               "pok_plus_g": dataclasses.replace(proof,
                                                 commitment_pok=g1.add(proof.commitment_pok, gen))}
    for kind, bad in tampers.items():
        if groth16.is_valid(bad, vk, [], curve):
            raise AssertionError(f"the verifier accepted a proof with {kind}")
    _say("precompiles", circuit="ecrecover", system="groth16", curve=curve.name,
         constraints=cs.nb_constraints, wires=cs.nb_wires, domain_log_n=pk.domain_log_n,
         committed_wires=n, setup_s=t_setup, setup_split=split, first_prove_s=t_first,
         first_prove=first_phases, warm_prove={"seconds": profiled["wall_s"], **dict(phases)},
         profiled_prove=profiled, warm_launches=warm, peak_device_bytes=peak,
         pedersen={"values": n, "seconds": run["seconds"], "msm_batch_s": run["msm_batch_s"],
                   "launches": run["launches"],
                   "equals_host": True, "basis_points_checked": PEDERSEN_SPOT},
         verify_s=t_verify, verified=True, rejected={k: True for k in tampers})
    return {"precompiles_ecrecover": launches}


def _lane_prove(device, system: str, cs, pub, sec) -> dict:
    """One path of a lane on the card (system "groth16" or "plonk", BN254):
    setup (its log's split), a first prove, and a warm prove under
    torch.profiler, with the backend's stage times of each prove; launch
    counts from 0 just before setup to just after the warm prove, the warm
    prove's own, and the peak device bytes of the three. Returns the keys,
    the warm proof and the report."""
    import importlib

    import torch

    backend = importlib.import_module(f"gnark_icicle_tpu_torch.backend.{system}")
    curve = _curves()["bn254"]
    phases, split = [], {}
    grab = _StageLog(system, phases, split)
    try:
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pk, vk = backend.setup(cs, curve, rng=random.Random(1), device=device)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        backend.prove(cs, pk, pub, sec, curve, rng=random.Random(2), device=device)
        first = {"seconds": time.perf_counter() - t0, **dict(phases)}
        phases.clear()
        before = _counts("bn254")
        holder = {}
        profiled = _profiled(lambda: holder.setdefault("proof", backend.prove(
            cs, pk, pub, sec, curve, rng=random.Random(3), device=device)))
        launches = _counts("bn254")
        peak = torch.cuda.max_memory_allocated()
    finally:
        grab.close()
    t0 = time.perf_counter()
    backend.verify(holder["proof"], vk, pub, curve)
    return {"pk": pk, "vk": vk, "proof": holder["proof"], "launches": launches,
            "report": {"setup_s": t_setup, "setup_split": split, "first_prove": first,
                       "warm_prove": {"seconds": profiled["wall_s"], **dict(phases)},
                       "profiled_prove": profiled,
                       "warm_launches": {k: c - before[k] for k, c in launches.items()
                                         if c != before[k]},
                       "launches": {k: c for k, c in launches.items() if c},
                       "peak_device_bytes": peak, "verify_s": time.perf_counter() - t0,
                       "verified": True}}


def phase_precompiles_ecadd(device, scs, sec) -> dict:
    """EcAdd through PLONK on the card (one BSB22 commitment: Qcp;
    _lane_prove): the proof verifies, a tampered commitment is rejected.
    Returns {path: launches}."""
    import dataclasses

    from gnark_icicle_tpu_torch.backend import plonk

    curve = _curves()["bn254"]
    g1 = curve.g1
    run = _lane_prove(device, "plonk", scs, [], sec)
    _check_msm_launches("bn254", run["launches"], "bn254 precompiles ecadd")
    proof, vk = run["proof"], run["vk"]
    bad = dataclasses.replace(proof, bsb22_commitments=[
        g1.add(proof.bsb22_commitments[0], g1.generator)])
    if plonk.is_valid(bad, vk, [], curve):
        raise AssertionError("the verifier accepted a tampered commitment")
    _say("precompiles", circuit="ecadd", system="plonk", curve=curve.name,
         gates=scs.nb_gates, domain_log_n=run["pk"].log_n, **run["report"],
         rejected={"commitment_plus_g": True})
    return {"precompiles_ecadd": run["launches"]}


# phase rollup: the rollup and hashing gadgets of std/ (eddsa over
# curves/twisted_edwards, merkle's MiMC paths; hash/keccakf under
# hash/sha3) on BN254 in a fourth process (_lane): gnark's rollup
# (examples/rollup.py) as one batch of EdDSA-signed transfers on a MiMC
# account tree through Groth16, and the EVM's keccak256 of 64 bytes through
# PLONK
ROLLUP_DEPTH = 24                  # the account tree's depth
ROLLUP_TRANSFERS = 8               # transfers a batch, chained through secret roots
ROLLUP_ACCOUNTS = 16               # funded accounts; every other leaf is zero
# RollupBatch as the JAX package compiles it (8 x 79,651; the slow test of
# tests/test_torch_rollup.py holds the two packages' systems equal)
ROLLUP_CONSTRAINTS = 637_208
ROLLUP_LOG = 20                    # its domain
SPARSE_CHECK_DEPTH = 8             # the sparse tree held to MerkleTreeHost there
KECCAK_BYTES = 64                  # a Solidity mapping's slot preimage: key ‖ slot
KECCAK_GATES = 229_712             # keccak256 of 64 bytes under the SCS builder
KECCAK_LOG = 18                    # its domain; PLONK's 4n coset has 2^20 rows


def rollup_circuits(depth: int, transfers: int) -> tuple:
    """gnark's rollup over the port's gadgets: TransferCircuit, copied from
    examples/rollup.py:41-126 with the tree's depth a parameter, and
    RollupBatch: `transfers` of them, each transfer's root_after the next
    one's root_before; the batch's first root_before and last root_after
    are public, the roots between them secret (`roots`), and every other
    input of transfer i is entry i of the batch's input of the same name."""
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret
    from gnark_icicle_tpu_torch.std.eddsa import verify_signature
    from gnark_icicle_tpu_torch.std.hash.mimc import MiMC

    Q = bn254.R

    class TransferCircuit(Circuit):
        """One rollup transfer (the reference batches these; batch = repeat)."""

        root_before = Public()
        root_after = Public()

        sender_pub_x = Secret()
        sender_pub_y = Secret()
        receiver_pub_x = Secret()
        receiver_pub_y = Secret()
        sender_balance = Secret()
        sender_nonce = Secret()
        receiver_balance = Secret()
        receiver_nonce = Secret()
        amount = Secret()
        # signature
        sig_rx = Secret()
        sig_ry = Secret()
        sig_s = Secret()
        # merkle paths: sender against root_before, receiver against root_mid
        sender_sibs = Secret(shape=depth)
        sender_dirs = Secret(shape=depth)
        receiver_sibs = Secret(shape=depth)
        receiver_dirs = Secret(shape=depth)

        def _leaf(self, api, px, py, bal, nonce):
            h = MiMC(api, Q)
            h.write(px, py, bal, nonce)
            return h.sum()

        def _root(self, api, leaf, sibs, dirs):
            cur = leaf
            for sib, bit in zip(sibs, dirs):
                api.assert_is_boolean(bit)
                left = api.select(bit, sib, cur)
                right = api.select(bit, cur, sib)
                h = MiMC(api, Q)
                h.write(left, right)
                cur = h.sum()
            return cur

        def define(self, api):
            sender_pub = (self.sender_pub_x, self.sender_pub_y)

            # 1. the sender authorized this transfer
            h = MiMC(api, Q)
            h.write(self.sender_pub_x, self.receiver_pub_x, self.amount,
                    self.sender_nonce)
            msg = h.sum()
            verify_signature(api, Q, sender_pub, (self.sig_rx, self.sig_ry),
                             self.sig_s, msg)

            # 2. funds are sufficient (64-bit balances)
            api.assert_is_less_or_equal(self.amount, self.sender_balance)

            # 3. sender pre-state is in root_before
            sender_leaf = self._leaf(api, self.sender_pub_x, self.sender_pub_y,
                                     self.sender_balance, self.sender_nonce)
            root = self._root(api, sender_leaf, self.sender_sibs,
                              self.sender_dirs)
            api.assert_is_equal(root, self.root_before)

            # 4. sender post-state defines the mid root
            sender_after = self._leaf(
                api, self.sender_pub_x, self.sender_pub_y,
                api.sub(self.sender_balance, self.amount),
                api.add(self.sender_nonce, 1),
            )
            root_mid = self._root(api, sender_after, self.sender_sibs,
                                  self.sender_dirs)

            # 5. receiver pre-state is in root_mid; post-state gives root_after
            recv_leaf = self._leaf(api, self.receiver_pub_x, self.receiver_pub_y,
                                   self.receiver_balance, self.receiver_nonce)
            root2 = self._root(api, recv_leaf, self.receiver_sibs,
                               self.receiver_dirs)
            api.assert_is_equal(root2, root_mid)
            recv_after = self._leaf(
                api, self.receiver_pub_x, self.receiver_pub_y,
                api.add(self.receiver_balance, self.amount),
                self.receiver_nonce,
            )
            root3 = self._root(api, recv_after, self.receiver_sibs,
                               self.receiver_dirs)
            api.assert_is_equal(root3, self.root_after)

    inputs = [d for d in TransferCircuit._inputs() if not d.public]

    def define(self, api):
        roots = [self.root_before, *self.roots, self.root_after]
        for i in range(transfers):
            TransferCircuit(root_before=roots[i], root_after=roots[i + 1],
                            **{d.name: getattr(self, d.name)[i] for d in inputs}).define(api)

    batch = {"root_before": Public(), "root_after": Public(),
             "roots": Secret(shape=transfers - 1)}
    batch.update((d.name, Secret(shape=transfers if d.shape is None else (transfers, d.shape)))
                 for d in inputs)
    return TransferCircuit, type("RollupBatch", (Circuit,), {**batch, "define": define})


def batch_assignment(RollupBatch, transfers: list):
    """RollupBatch's assignment from its transfers' (TransferCircuit
    assignments as dicts, in order)."""
    names = [d.name for d in RollupBatch._inputs()
             if d.name not in ("root_before", "root_after", "roots")]
    return RollupBatch(root_before=transfers[0]["root_before"],
                       root_after=transfers[-1]["root_after"],
                       roots=[t["root_after"] for t in transfers[:-1]],
                       **{k: [t[k] for t in transfers] for k in names})


def _mimc(*values) -> int:
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.std.hash.mimc import MiMCHost

    h = MiMCHost(bn254.R)
    h.write(*values)
    return h.h


class SparseTree:
    """The MiMC Merkle tree of std/merkle.py's MerkleTreeHost over 2^depth
    leaves, most of them zero, without its 2^depth leaves: the nodes above a
    leaf ever set are kept by level and index, every other node of a level
    is the hash of an empty subtree there (one hash a level). The same root
    and proofs (sparse_tree_check)."""

    def __init__(self, depth: int, leaves: dict):
        self.depth = depth
        self.empty = [0]
        for _ in range(depth):
            self.empty.append(_mimc(self.empty[-1], self.empty[-1]))
        self.nodes = [{} for _ in range(depth + 1)]
        for index, value in leaves.items():
            self.update(index, value)

    def node(self, level: int, index: int) -> int:
        return self.nodes[level].get(index, self.empty[level])

    @property
    def root(self) -> int:
        return self.node(self.depth, 0)

    def proof(self, index: int) -> tuple:
        """(siblings, direction_bits) bottom-up for leaf `index`, as
        MerkleTreeHost.proof."""
        sibs, dirs = [], []
        for level in range(self.depth):
            sibs.append(self.node(level, index ^ 1))
            dirs.append(index & 1)
            index >>= 1
        return sibs, dirs

    def update(self, index: int, value: int) -> None:
        from gnark_icicle_tpu_torch.curves import bn254

        self.nodes[0][index] = value % bn254.R
        for level in range(self.depth):
            base = index & ~1
            index >>= 1
            self.nodes[level + 1][index] = _mimc(self.node(level, base),
                                                 self.node(level, base + 1))


class RollupOperator:
    """examples/rollup.py's Operator (:129-176) on a SparseTree of the
    given depth: ROLLUP_ACCOUNTS funded accounts (balance 1000, nonce 0)
    spread over the leaves, every other leaf zero. transfer() returns the
    TransferCircuit assignment as a dict."""

    def __init__(self, depth: int):
        from gnark_icicle_tpu_torch.curves import twisted_edwards as te

        n = ROLLUP_ACCOUNTS
        stride = (1 << depth) // n
        self.keys = [te.generate_key(f"acct{i}".encode()) for i in range(n)]
        self.index = [i * stride + i % stride for i in range(n)]
        self.balances = [1000] * n
        self.nonces = [0] * n
        self.tree = SparseTree(depth, {self.index[i]: self.leaf(i) for i in range(n)})

    def leaf(self, i: int) -> int:
        """H(pub.x, pub.y, balance, nonce) (examples/rollup.py
        account_leaf_host)."""
        pub = self.keys[i].public
        return _mimc(pub[0], pub[1], self.balances[i], self.nonces[i])

    def transfer(self, frm: int, to: int, amount: int) -> dict:
        """Execute + build the witness for one transfer."""
        from gnark_icicle_tpu_torch.curves import twisted_edwards as te

        kp, dest = self.keys[frm], self.keys[to]
        msg = _mimc(kp.public[0], dest.public[0], amount, self.nonces[frm])
        R, s = te.sign(kp, msg)
        sender_sibs, sender_dirs = self.tree.proof(self.index[frm])
        w = dict(root_before=self.tree.root,
                 sender_pub_x=kp.public[0], sender_pub_y=kp.public[1],
                 receiver_pub_x=dest.public[0], receiver_pub_y=dest.public[1],
                 sender_balance=self.balances[frm], sender_nonce=self.nonces[frm],
                 receiver_balance=self.balances[to], receiver_nonce=self.nonces[to],
                 amount=amount, sig_rx=R[0], sig_ry=R[1], sig_s=s,
                 sender_sibs=sender_sibs, sender_dirs=sender_dirs)
        # apply sender side, take receiver proof from the mid tree
        self.balances[frm] -= amount
        self.nonces[frm] += 1
        self.tree.update(self.index[frm], self.leaf(frm))
        w["receiver_sibs"], w["receiver_dirs"] = self.tree.proof(self.index[to])
        self.balances[to] += amount
        self.tree.update(self.index[to], self.leaf(to))
        w["root_after"] = self.tree.root
        return w


def rollup_batch(depth: int, seed: int, overdraw: bool = False) -> list:
    """ROLLUP_TRANSFERS transfers of a fresh RollupOperator (account 2i to
    2i + 1, amounts from `seed`); with `overdraw` the first one moves one
    more than the sender holds, the rest of its witness as the operator
    computes it."""
    rng = random.Random(seed)
    op = RollupOperator(depth)
    out = []
    for i in range(ROLLUP_TRANSFERS):
        amount = rng.randrange(1, 251)
        if overdraw and i == 0:
            amount = op.balances[0] + 1
        out.append(op.transfer(2 * i, 2 * i + 1, amount))
    return out


def sparse_tree_check(depth: int = SPARSE_CHECK_DEPTH) -> dict:
    """RollupOperator's sparse tree against std/merkle.py's MerkleTreeHost
    over all 2^depth leaves: the same root and the proofs of every funded
    account, before and after a batch of transfers and an update of a zero
    leaf."""
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.std.merkle import MerkleTreeHost

    op = RollupOperator(depth)
    dense = MerkleTreeHost(bn254.R, [op.tree.node(0, i) for i in range(1 << depth)])

    def same(when: str):
        if dense.root != op.tree.root or any(dense.proof(i) != op.tree.proof(i)
                                             for i in op.index + [1, (1 << depth) - 1]):
            raise AssertionError(f"the sparse tree differs from MerkleTreeHost {when}")

    same("after its build")
    for i in range(ROLLUP_TRANSFERS):
        op.transfer(2 * i, 2 * i + 1, 10 + i)
        for j in (2 * i, 2 * i + 1):
            dense.update(op.index[j], op.leaf(j))
    op.tree.update(1, 77)
    dense.update(1, 77)
    same("after the transfers")
    return {"depth": depth, "accounts": len(op.index), "transfers": ROLLUP_TRANSFERS}


def keccak_circuit():
    """keccak256 of KECCAK_BYTES secret bytes (std/hash/sha3.py keccak256)
    held to a public 32-byte digest."""
    from gnark_icicle_tpu_torch.frontend import Circuit, Public, Secret
    from gnark_icicle_tpu_torch.std.hash.sha3 import keccak256

    class Keccak256(Circuit):
        data = Secret(shape=KECCAK_BYTES)
        digest = Public(shape=32)

        def define(self, api):
            for have, want in zip(keccak256(api, list(self.data)), self.digest):
                api.assert_is_equal(have, want)

    return Keccak256


def keccak_witness(seed: int) -> tuple:
    """A Solidity mapping's slot preimage, key ‖ slot (a 20-byte address
    left-padded to 32 bytes, then the mapping's slot number, both
    big-endian), and its keccak256 from the port's host hash
    (std/hash/mimc.py keccak256, which evm.py's SHA3 runs): (public, secret)."""
    from gnark_icicle_tpu_torch.std.hash.mimc import keccak256

    rng = random.Random(seed)
    data = bytes(12) + rng.randbytes(20) + rng.randrange(1 << 8).to_bytes(32, "big")
    return list(keccak256(data)), list(data)


def rollup_host() -> dict:
    """The host part of phase rollup, which needs no card: the sparse tree
    held to MerkleTreeHost (sparse_tree_check); RollupBatch compiled at
    ROLLUP_DEPTH (ROLLUP_CONSTRAINTS), its batch of transfers solved once
    (which builds the solver's schedule), and refused by the solver with
    one signature's s + 1 and with an overdraft; keccak256 compiled with
    the SCS builder (KECCAK_GATES), solved, and refused with a wrong
    digest."""
    from gnark_icicle_tpu_torch.constraint.scs import SparseUnsatisfiedError, solve_scs
    from gnark_icicle_tpu_torch.constraint.solver import UnsatisfiedConstraintError, solve
    from gnark_icicle_tpu_torch.curves import bn254
    from gnark_icicle_tpu_torch.frontend import compile_circuit

    t = {}
    t0 = time.perf_counter()
    tree = sparse_tree_check()
    t["sparse_tree_check_s"] = time.perf_counter() - t0
    _, RollupBatch = rollup_circuits(ROLLUP_DEPTH, ROLLUP_TRANSFERS)
    t0 = time.perf_counter()
    cs = compile_circuit(bn254.R, RollupBatch)
    t["compile_s"] = time.perf_counter() - t0
    if cs.nb_constraints != ROLLUP_CONSTRAINTS:
        raise AssertionError(f"RollupBatch: {cs.nb_constraints} constraints")
    t0 = time.perf_counter()
    transfers = rollup_batch(ROLLUP_DEPTH, 11)
    forged = [dict(tr) for tr in transfers]
    forged[3]["sig_s"] += 1
    overdraft = rollup_batch(ROLLUP_DEPTH, 11, overdraw=True)
    t["witnesses_s"] = time.perf_counter() - t0
    pub, sec = batch_assignment(RollupBatch, transfers).witness_values(bn254.R)
    t0 = time.perf_counter()
    solve(cs, pub, sec)
    t["solve_s"] = time.perf_counter() - t0
    for kind, bad in (("forged_signature", forged), ("overdraft", overdraft)):
        t0 = time.perf_counter()
        try:
            solve(cs, *batch_assignment(RollupBatch, bad).witness_values(bn254.R))
        except UnsatisfiedConstraintError:
            t[f"{kind}_refused_s"] = time.perf_counter() - t0
        else:
            raise AssertionError(f"the solver accepted the batch with a {kind}")
    t0 = time.perf_counter()
    scs = compile_circuit(bn254.R, keccak_circuit(), builder="scs")
    t["keccak_compile_s"] = time.perf_counter() - t0
    if scs.nb_gates != KECCAK_GATES:
        raise AssertionError(f"keccak256: {scs.nb_gates} gates")
    digest, data = keccak_witness(5)
    t0 = time.perf_counter()
    solve_scs(scs, digest, data)
    t["keccak_solve_s"] = time.perf_counter() - t0
    try:
        solve_scs(scs, [digest[0] ^ 1] + digest[1:], data)
    except SparseUnsatisfiedError:
        pass
    else:
        raise AssertionError("the SCS solver accepted a wrong keccak256 digest")
    _say("rollup", part="host", circuit="rollup", depth=ROLLUP_DEPTH,
         transfers=ROLLUP_TRANSFERS, constraints=cs.nb_constraints, wires=cs.nb_wires,
         public=cs.nb_public, secret=cs.nb_secret, sparse_tree=tree,
         refused=["forged_signature", "overdraft"], keccak_gates=scs.nb_gates,
         keccak_wrong_digest_refused=True, **t)
    return {"rollup": (cs, pub, sec), "keccak": (scs, digest, data)}


def _check_ran(label: str, launches: dict, ran: tuple, zero: tuple = (),
               name: str = "bn254") -> None:
    """Each entry of `ran` (unprefixed, of curve `name`) launched on the path,
    none of `zero`, and every MSM one launch set (_check_msm_launches)."""
    from gnark_icicle_tpu_torch.ops import cuda as kc

    pre = kc.CURVES[name]
    bad = [e for e in ran if not launches.get(pre + e)] + [
        e for e in zero if launches.get(pre + e)]
    if bad:
        raise AssertionError(f"{label}: launches of {bad} are not the path's: {launches}")
    _check_msm_launches(name, launches, label)


def phase_rollup_groth16(device, cs, pub, sec) -> dict:
    """RollupBatch through Groth16 on the card (_lane_prove: a 2^ROLLUP_LOG
    domain, the G2 MSM B2 over its wires): the proof verifies; the proof
    checked against root_after + 1, and the proof with Ar replaced by 2·Ar,
    are rejected. Returns {path: launches}."""
    import dataclasses

    from gnark_icicle_tpu_torch.backend import groth16

    curve = _curves()["bn254"]
    run = _lane_prove(device, "groth16", cs, pub, sec)
    pk, vk, proof = run["pk"], run["vk"], run["proof"]
    if pk.domain_log_n != ROLLUP_LOG:
        raise AssertionError(f"RollupBatch's domain is 2^{pk.domain_log_n}")
    _check_ran("bn254 rollup groth16", run["launches"],
               ("fr_mont_mul", "ntt_pass", "g1_bucket_accumulate", "g2_bucket_accumulate",
                "g1_fixed_base", "g1_normalize", "g2_fixed_base", "g2_normalize"),
               ("fr_add", "plonk_quotient", "fr_batch_inv"))
    tampers = {"root_after_changed": (proof, [pub[0], (pub[1] + 1) % curve.fr.modulus]),
               "ar_doubled": (dataclasses.replace(proof, ar=curve.g1.scalar_mul(proof.ar, 2)),
                              pub)}
    for kind, (bad, bad_pub) in tampers.items():
        if groth16.is_valid(bad, vk, bad_pub, curve):
            raise AssertionError(f"the verifier accepted the rollup proof with {kind}")
    _say("rollup", circuit="rollup", system="groth16", curve=curve.name,
         depth=ROLLUP_DEPTH, transfers=ROLLUP_TRANSFERS, constraints=cs.nb_constraints,
         wires=cs.nb_wires, domain_log_n=pk.domain_log_n, **run["report"],
         rejected={k: True for k in tampers}, card=_smi("name,power.limit"))
    return {"rollup_groth16": run["launches"]}


def phase_rollup_keccak(device, scs, digest, data) -> dict:
    """keccak256 of KECCAK_BYTES bytes through PLONK on the card
    (_lane_prove: a 2^KECCAK_LOG domain, its quotient on 2^(KECCAK_LOG + 2)
    rows): the proof verifies; the proof checked against a digest with one
    byte changed is rejected. Returns {path: launches}."""
    from gnark_icicle_tpu_torch.backend import plonk

    curve = _curves()["bn254"]
    run = _lane_prove(device, "plonk", scs, digest, data)
    pk, vk, proof = run["pk"], run["vk"], run["proof"]
    if pk.log_n != KECCAK_LOG:
        raise AssertionError(f"keccak256's domain is 2^{pk.log_n}")
    _check_ran("bn254 keccak256 plonk", run["launches"],
               ("fr_mont_mul", "ntt_pass", "fr_add", "plonk_quotient", "fr_batch_inv",
                "fr_sub", "g1_bucket_accumulate", "g1_fixed_base", "g1_normalize"),
               ("g2_bucket_accumulate", "g2_fixed_base", "g2_normalize"))
    bad = list(digest)
    bad[7] ^= 0x40
    if plonk.is_valid(proof, vk, bad, curve):
        raise AssertionError("the verifier accepted the keccak256 proof with a changed digest")
    _say("rollup", circuit="keccak256", system="plonk", curve=curve.name, bytes=KECCAK_BYTES,
         gates=scs.nb_gates, domain_log_n=pk.log_n, **run["report"],
         rejected={"digest_byte_changed": True}, card=_smi("name,power.limit"))
    return {"keccak_plonk": run["launches"]}


# phase recursion: the recursion verifiers of std/recursion/ and the KZG
# gadget (std/kzg_gadget.py, over the emulated pairings of std/) check proofs
# made on the card, in the Engine (frontend/engine.py), in a fifth process
# (_recursion_lane) that the paths send their proofs to as they make them;
# and the host engine (engine="host") proves a small Chain as the card does
HOST_CHECK_LOG = 10                # the Chain of the host engine against the card
KZG_POLY_LOG = 16                  # the polynomial that the card's kzg.open opens
RECURSION_CHECKS = 10              # 3 Groth16, 2 PLONK, 1 native PLONK, 2 KZG, 2 host engine
RECURSION_WAIT_S = 600             # the lane's longest wait for its next job
# the recursion lane's job queue and the jobs this process sent there
_REC = {"q": None, "sent": 0}


def _recursion_queue(jobs) -> None:
    """A process's handle on the recursion lane's job queue (the second
    process's Pool initializer: a queue passes to a spawned process only as
    it starts)."""
    _REC["q"] = jobs


def send_recursion(job) -> None:
    """One check for the recursion lane (check_recursion); ("end", n) once
    all processes together have sent n."""
    _REC["q"].put(job)
    _REC["sent"] += not isinstance(job, tuple)


def host_check_circuits() -> dict:
    """The BN254 Chain of 2^HOST_CHECK_LOG for each proof system (_chain's
    tuples), as chain_circuit and plonk_circuit size theirs."""
    return {"groth16": _chain("bn254", (1 << HOST_CHECK_LOG) - 2, "r1cs"),
            "plonk": _chain("bn254", ((1 << HOST_CHECK_LOG) - 16) // 3, "scs")}


def _artifacts(system: str, curve, vk, proof) -> tuple:
    """(vk bytes, proof bytes) in gnark's formats (io/)."""
    from gnark_icicle_tpu_torch.io import plonk_serialize, serialize

    if system == "groth16":
        return serialize.vk_to_bytes(curve, vk), serialize.proof_to_bytes(curve, proof)
    return (plonk_serialize.plonk_vk_to_bytes(curve, vk),
            plonk_serialize.plonk_proof_to_bytes(curve, proof))


def engine_artifacts(**engine) -> dict:
    """host_check_circuits' keys (setup rng 1) and proofs (prove rng 2) under
    `engine` (engine="host", or device=...): {system: (vk bytes, proof
    bytes, setup seconds, prove seconds)}."""
    import importlib

    curve = _curves()["bn254"]
    out = {}
    for system, (cs, _, v) in host_check_circuits().items():
        backend = importlib.import_module(f"gnark_icicle_tpu_torch.backend.{system}")
        t0 = time.perf_counter()
        pk, vk = backend.setup(cs, curve, rng=random.Random(1), **engine)
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        proof = backend.prove(cs, pk, [v], [3], curve, rng=random.Random(2), **engine)
        out[system] = (*_artifacts(system, curve, vk, proof), t_setup,
                       time.perf_counter() - t0)
    return out


def _verifier_run(job: dict, tampered: bool):
    """The job's verifier, made anew in a BN254 Engine (a BW6-761 one for the
    native PLONK verifier), run on its proof: the job's inputs, or its tamper
    (the public input + 1; for KZG the claimed value + 1)."""
    from gnark_icicle_tpu_torch.curves import bls12_377, bn254
    from gnark_icicle_tpu_torch.frontend.engine import Engine
    from gnark_icicle_tpu_torch.std.kzg_gadget import KzgVerifier
    from gnark_icicle_tpu_torch.std.recursion import Groth16Verifier, PlonkVerifier
    from gnark_icicle_tpu_torch.std.recursion.native_plonk import NativePlonkVerifier
    from gnark_icicle_tpu_torch.std.sw_emulated import AffinePoint

    q, kind = bn254.R, job["kind"]
    if kind == "kzg":
        (cm, z, v, w), (g2_gen, g2_tau) = job["opening"], job["g2"]
        kv = KzgVerifier(Engine(q), q, g2_gen, g2_tau, curve_id=job["curve_id"])
        fp, fr = kv.curve.fp, kv.curve.fr

        def pt(p):
            return AffinePoint(fp.constant(p[0]), fp.constant(p[1]))

        v = (v + int(tampered)) % job["r"]
        return kv.assert_opening(pt(cm), fr.constant(z), fr.constant(v), pt(w))
    if kind == "native_plonk":
        ver = NativePlonkVerifier(Engine(bls12_377.P), job["vk"])
    else:
        cls = Groth16Verifier if kind == "groth16" else PlonkVerifier
        ver = cls(Engine(q), q, job["vk"], curve_id=job["curve_id"])
    pub = [(p + int(tampered)) % job["r"] for p in job["pub"]]
    return ver.assert_proof(ver.proof_witness(job["proof"]), pub)


def check_recursion(job: dict, host: dict) -> dict:
    """One check of the recursion lane: a verifier accepts its proof and
    refuses its tamper with EngineUnsatisfiedError (_verifier_run), or the
    host engine's keys and proof are the card's bytes. Raises otherwise;
    prints its line and returns it."""
    from gnark_icicle_tpu_torch.frontend.engine import EngineUnsatisfiedError

    if job["kind"] == "host":
        vk_h, proof_h, setup_h, prove_h = host[job["system"]]
        vk_c, proof_c, setup_c, prove_c = job["card"]
        line = {"check": f"{job['system']} host engine against the card", "curve": "bn254",
                "domain_log_n": HOST_CHECK_LOG, "vk_equal": vk_h == vk_c,
                "proof_equal": proof_h == proof_c, "proof_bytes": len(proof_c),
                "host_setup_s": setup_h, "host_prove_s": prove_h, "card_setup_s": setup_c,
                "card_prove_s": prove_c}
        if not (line["vk_equal"] and line["proof_equal"]):
            raise AssertionError(f"the host engine's bytes differ from the card's: {line}")
        _say("recursion", **line)
        return line
    t0 = time.perf_counter()
    _verifier_run(job, tampered=False)
    t_accept = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        _verifier_run(job, tampered=True)
    except EngineUnsatisfiedError:
        pass
    else:
        raise AssertionError(f"{job['label']}: the verifier accepted its tamper")
    line = {"check": job["label"], "verifier": job["kind"], "inner": job["inner"],
            "accepted": True, "accept_s": t_accept,
            "tamper": "claimed value + 1" if job["kind"] == "kzg" else "public input + 1",
            "rejected": True, "reject_s": time.perf_counter() - t0}
    _say("recursion", **line)
    return line


def _recursion_lane(t_start: float, jobs, out) -> None:
    """Phase recursion's checks in a process of their own (spawned, niced as
    the compile workers are): first the host engine's part of the check
    against the card (engine_artifacts), while nvcc runs; then each job that
    a path sends (send_recursion) as it comes, until it has checked as many
    as ("end", n) says were sent. Puts ("ok", [the checks' lines]) or
    ("error", traceback) on `out`."""
    try:
        _START["t"] = t_start
        os.nice(10)
        host = engine_artifacts(engine="host")
        lines, total = [], None
        while total is None or len(lines) < total:
            job = jobs.get(timeout=RECURSION_WAIT_S)
            if isinstance(job, tuple):
                total = job[1]
            else:
                lines.append(check_recursion(job, host))
        out.put(("ok", lines))
    except BaseException:   # noqa: BLE001 (raised again by main)
        out.put(("error", traceback.format_exc()))


def start_recursion(t_start: float) -> tuple:
    """_recursion_lane started in a spawned process: (its process, its
    result's queue); this process's handle on its job queue set."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    jobs, out = ctx.Queue(), ctx.Queue()
    _recursion_queue(jobs)
    proc = ctx.Process(target=_recursion_lane, args=(t_start, jobs, out))
    proc.start()
    return proc, out


def groth16_job(name: str, vk, proof, pub: list, inner: str) -> dict:
    """The Groth16 verifier's check of a card's proof on `name`'s curve."""
    curve = _curves()[name]
    return {"kind": "groth16", "label": f"groth16 {inner} in bn254", "inner": inner,
            "curve_id": "bn254" if name == "bn254" else curve.name, "vk": vk, "proof": proof,
            "pub": pub, "r": curve.fr.modulus}


def recursion_plonk(device, name: str, compiled: tuple, pk, vk) -> dict:
    """One more prove of a curve's PLONK path on the card, with the MiMC
    transcript (fs_hash="mimc", which the in-circuit verifiers replay),
    under its key, and the verifier's check of it: PlonkVerifier in BN254
    (same-curve on BN254, cross-curve on BLS12-381), NativePlonkVerifier in
    BW6-761 for BLS12-377. Returns the job."""
    from gnark_icicle_tpu_torch.backend import plonk

    cs, _, v = compiled
    curve = _curves()[name]
    t0 = time.perf_counter()
    proof = plonk.prove(cs, pk, [v], [3], curve, rng=random.Random(4), device=device,
                        fs_hash="mimc")
    t_prove = time.perf_counter() - t0
    kind = "native_plonk" if name == "bls12_377" else "plonk"
    where = "bw6-761" if kind == "native_plonk" else "bn254"
    _say("recursion", curve=curve.name, prove="plonk, fs_hash=mimc", gates=cs.nb_gates,
         domain_log_n=pk.log_n, prove_s=t_prove)
    return {"kind": kind, "label": f"{kind} {curve.name} 2^{pk.log_n} in {where}",
            "inner": f"{curve.name} plonk chain 2^{pk.log_n}, fs_hash=mimc",
            "curve_id": curve.name, "vk": vk, "proof": proof, "pub": [v],
            "r": curve.fr.modulus}


def recursion_kzg(device, name: str, srs) -> dict:
    """A polynomial of 2^KZG_POLY_LOG seeded coefficients committed and
    opened at a seeded point by the card's KZG (backend/kzg.py: both
    commitments MSMs on the card) over a path's SRS, and the KZG gadget's
    check of the opening in BN254. Returns the job."""
    from gnark_icicle_tpu_torch.backend.kzg import KZG

    curve = _curves()[name]
    r = curve.fr.modulus
    rng = random.Random(5)
    coeffs = [rng.randrange(r) for _ in range(1 << KZG_POLY_LOG)]
    z = rng.randrange(r)
    kzg = KZG(curve, srs, device)
    t0 = time.perf_counter()
    cm = kzg.commit(coeffs)
    v, w = kzg.open(coeffs, z)
    _say("recursion", curve=curve.name, kzg_open=f"2^{KZG_POLY_LOG} coefficients",
         commit_open_s=time.perf_counter() - t0)
    return {"kind": "kzg", "label": f"kzg {curve.name} opening in bn254",
            "inner": f"{curve.name} kzg.open of 2^{KZG_POLY_LOG} coefficients",
            "curve_id": curve.name, "opening": (cm, z, v, w), "g2": (srs.g2_gen, srs.g2_tau),
            "r": r}


def phase_recursion_card(device, name: str, compiled: tuple, pk, vk) -> dict:
    """Phase recursion's card part on one curve, with the launch counts set
    to 0 just before it and read just after: the MiMC-transcript PLONK prove
    (recursion_plonk), on BN254 and BLS12-381 the KZG opening
    (recursion_kzg), and on BN254 the host engine's Chain proved on the card
    (engine_artifacts). Each check goes to the recursion lane. Returns
    {path: launches}."""
    _zero_counts()
    send_recursion(recursion_plonk(device, name, compiled, pk, vk))
    if name != "bls12_377":
        send_recursion(recursion_kzg(device, name, pk.srs))
    if name == "bn254":
        for system, card in engine_artifacts(device=device).items():
            send_recursion({"kind": "host", "system": system, "card": card})
    launches = _counts(name)
    ran = ["g1_bucket_accumulate", "ntt_pass", "plonk_quotient", "fr_add"]
    if name == "bn254":    # the Chain's Groth16 setup and prove
        ran += ["g1_fixed_base", "g1_normalize", "g2_fixed_base", "g2_bucket_accumulate"]
    _check_ran(f"{name} recursion", launches, tuple(ran), name=name)
    return {"recursion": launches}


# the phases that run in a process of their own: phase -> (its host part,
# which returns {name: arguments}, and its paths on the card by those names)
LANES = {"precompiles": (precompiles_host, {"ecrecover": phase_precompiles_ecrecover,
                                            "ecadd": phase_precompiles_ecadd}),
         "rollup": (rollup_host, {"rollup": phase_rollup_groth16,
                                  "keccak": phase_rollup_keccak})}


def _lane(phase: str, t_start: float, card_free, out) -> None:
    """A phase of LANES in a process of its own (spawned): its host part
    while nvcc and phases 2 and 3 run, niced as the compile workers are;
    then, once main sets `card_free` (phases 2 and 3 done), its paths on the
    card, with launch counts of its own. Puts ("ok", [(curve, path,
    launches)]) or ("error", traceback) on `out`."""
    try:
        import torch

        from gnark_icicle_tpu_torch.ops import cuda as kc

        _START["t"] = t_start
        os.nice(10)
        host_part, paths = LANES[phase]
        host = host_part()
        card_free.wait()
        device = torch.device("cuda", 0)
        kc.load("bn254")
        runs = {}
        for name, run in paths.items():
            runs.update(run(device, *host[name]))
        out.put(("ok", [("bn254", path, c) for path, c in runs.items()]))
    except BaseException:   # noqa: BLE001 (raised again by main)
        out.put(("error", traceback.format_exc()))


def start_lane(phase: str, t_start: float, card_free) -> tuple:
    """_lane of `phase` started in a spawned process, its card part held
    until `card_free` is set: (its process, its result's queue)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_lane, args=(phase, t_start, card_free, out))
    proc.start()
    return proc, out


def lane_result(phase: str, lane: tuple) -> list:
    """The lane's [(curve, path, launches)]; its failure, or its end
    without a result, raised here."""
    import queue

    proc, out = lane
    while True:
        try:
            status, value = out.get(timeout=10)
            break
        except queue.Empty:
            if not proc.is_alive():
                raise AssertionError(f"phase {phase} ended with code {proc.exitcode} "
                                     "and no result") from None
    if status != "ok":
        raise AssertionError(f"phase {phase} failed:\n{value}")
    return value


def main() -> int:
    # the profiler detaches CUPTI at the end of each session (_profiled, the
    # served request's device_trace), in this process and the lane's: kept
    # attached, a later session drops its first seconds of kernels
    # (gnark_icicle_tpu_torch/trace_probe.py). Set before torch is imported;
    # the process then ends by _exit
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    import multiprocessing

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this runs on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gnark_icicle_tpu_torch.device import DeviceCtx

    from gnark_icicle_tpu_torch.ops import cuda as kc

    t_start = _START["t"] = time.perf_counter()
    device = torch.device("cuda", 0)
    # phases precompiles and rollup in a third and a fourth process: their
    # host parts now, their card parts once phases 2 and 3 are done
    alone = sys.argv[1:]
    card_free = multiprocessing.get_context("spawn").Event()
    # phase recursion's checks in a fifth process, started now: the host
    # engine's proofs while nvcc runs, then the card's proofs as they come
    recursion = start_recursion(t_start) if not alone else None
    lanes = {phase: start_lane(phase, t_start, card_free)
             for phase in LANES if alone in ([], [phase])}
    if alone:               # that phase alone, after the build
        if not lanes:
            raise SystemExit(f"chip_smoke.py: no phase {alone}; precompiles or rollup")
        kc.build()
        card_free.set()
        lane_result(alone[0], lanes[alone[0]])
        _say("done", seconds=time.perf_counter() - t_start)
        return 0
    # nvcc runs in processes of its own, and the circuits compile in niced
    # processes of their own (host Python) while nvcc and then phases 2 and 3
    # run, which need no circuit; a failed build or compile is re-raised
    build, circuits = {}, {}
    # the second process: the ceremony's host part (ceremony_keys) once nvcc
    # is done, while this one runs phases 2 and 3; then the lane's paths
    pool = multiprocessing.get_context("spawn").Pool(1, initializer=_recursion_queue,
                                                     initargs=(_REC["q"],))
    jobs = ([("groth16", name) for name in CHAIN_CURVES] + [("plonk", name) for name in CURVE_NAMES]
            + [(f"bsb22_{system}", name) for name in BSB22_CURVES
               for system in ("groth16", "plonk")])

    def run_build():
        try:
            build["dir"] = kc.build()
        except BaseException as e:     # noqa: BLE001 (re-raised below)
            build["error"] = e
        else:
            build["ceremony"] = pool.apply_async(ceremony_keys, (t_start,))
        build["seconds"] = time.perf_counter() - t_start

    def run_compile():
        try:
            circuits["done"] = compile_circuits(jobs)
        except BaseException as e:     # noqa: BLE001 (re-raised below)
            circuits["error"] = e
        circuits["seconds"] = time.perf_counter() - t_start

    builder = threading.Thread(target=run_build)
    compiler = threading.Thread(target=run_compile, daemon=True)
    builder.start()
    compiler.start()
    # phases 2 and 3 of a curve start as soon as its libraries are in place,
    # while nvcc builds the others': the curves in the order their builds end
    # (all start at once; BW6-761's three sources and BN254's are done first,
    # in under half the build, BLS12-377's 12-word G2 last)
    rates, kernels = None, []
    pending = list(CURVE_NAMES)
    while pending:
        ready = [name for name in pending if kc.built(name)]
        if not ready and builder.is_alive():
            time.sleep(0.5)
            continue
        if "error" in build:
            raise build["error"]
        name = (ready or pending)[0]
        pending.remove(name)
        load_curve(name)
        if rates is None:
            rates = card_rates()
        kernels += phase_kernels(device, name, rates)
        phase_msm(DeviceCtx(_curves()[name], device), name)
    builder.join()
    if "error" in build:
        raise build["error"]
    card_free.set()
    phase_build(build["seconds"])
    compiler.join()
    if "error" in circuits:
        raise circuits["error"]
    _say("circuits", compiled_s=circuits["seconds"])
    compiled_jobs, served = circuits["done"]
    done = dict(zip(jobs, compiled_jobs))
    compiled = {name: done["groth16", name] for name in CHAIN_CURVES}
    compiled_scs = {name: done["plonk", name] for name in CURVE_NAMES}
    compiled_bsb22 = {name: {system: done[f"bsb22_{system}", name]
                             for system in ("groth16", "plonk")} for name in BSB22_CURVES}
    # (curve, path, launches): the paths of _expectations, then the others
    paths, extra, ck_runs, srv_runs, srv_others = [], [], {}, {}, []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()    # phase 2's inputs: the lane's card memory
    with pool:
        lane_chain = {n: compiled[n] for n in LANE_CHAIN}
        lane_bsb22 = {n: compiled_bsb22[n] for n in LANE_BSB22}
        lane = pool.apply_async(_other_lane, (
            t_start, lane_chain, {n: compiled_scs[n] for n in LANE_PLONK}, lane_bsb22,
            _solver_caches([c[0] for c in lane_chain.values()]
                           + [systems["groth16"][0] for systems in lane_bsb22.values()]),
            build["ceremony"].get()))
        for name in CHAIN_CURVES:
            if name in LANE_CHAIN:
                continue
            counts, vk, proof, pub, pk, batched, timed = phase_groth16(device, name,
                                                                       compiled[name])
            paths.append((name, "groth16", counts))
            extra.append((name, "groth16_batched", batched))
            if name == "bn254":
                ck_runs["groth16"] = (compiled[name][0], pk, vk, pub, [3], proof)
                send_recursion(groth16_job(name, vk, proof, pub, "bn254 chain 2^17"))
            if name == SERVE_CURVE:
                srv_runs["groth16"] = (pk, vk, proof, pub, timed)
            else:
                srv_others.append((name, "groth16", vk, proof, pub))
        for name in CURVE_NAMES:
            if name in LANE_PLONK:
                continue
            counts, vk, proof, pk, batched, timed = phase_plonk(device, name, compiled_scs[name])
            paths.append((name, "plonk", counts))
            extra.append((name, "plonk_batched", batched))
            pub = [compiled_scs[name][2]]
            extra += [(name, path, c) for path, c in phase_recursion_card(
                device, name, compiled_scs[name], pk, vk).items()]
            if name == "bn254":
                ck_runs["plonk"] = (compiled_scs[name][0], pk, vk, pub, [3], proof)
            if name == SERVE_CURVE:
                srv_runs["plonk"] = (pk, vk, proof, pub, timed)
            elif name in CHAIN_CURVES:
                srv_others.append((name, "plonk", vk, proof, pub))
        bsb22_runs = {}
        for name in BSB22_CURVES:
            if name not in LANE_BSB22:
                counts, bsb22_runs[name] = phase_bsb22(device, name, compiled_bsb22[name])
                extra += [(name, path, c) for path, c in counts.items()]
        extra += [("bn254", path, c) for path, c in
                  phase_checkpoint(device, "bn254", ck_runs).items()]
        extra += [("bn254", path, c) for path, c in phase_deploy(
            device, srv_runs["groth16"][1:4], srv_runs["plonk"][1:4],
            bsb22_runs["bn254"]).items()]
        lane_paths, lane_extra, lane_sent = lane.get()
        _say("lane", curves=sorted({c for c, _, _ in lane_paths + lane_extra}),
             paths=[p for _, p, _ in lane_paths + lane_extra])
        send_recursion(("end", _REC["sent"] + lane_sent))
    paths += lane_paths
    extra += lane_extra
    extra += [(SERVE_CURVE, path, c) for path, c in
              phase_service(device, served, srv_runs, srv_others).items()]
    for phase, lane in lanes.items():
        extra += lane_result(phase, lane)
    checks = lane_result("recursion", recursion)
    if len(checks) != RECURSION_CHECKS:
        raise AssertionError(f"phase recursion made {len(checks)} checks, "
                             f"not {RECURSION_CHECKS}")
    _say("recursion", checks=len(checks), all_passed=True)
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for curve, path, counts in paths + extra
                                 if curve == k["curve"]}
        k["launches"] = sum(k["launches_by_path"].values())
    # every kernel ran on a path of its curve, but those that a path of the
    # curve holds at 0 and none requires (_expectations): *_double, g2_add on
    # the Chain curves, and g1_add where neither the Chain nor PLONK splits
    expected = {}
    for curve, path, _ in paths:
        for k, e in _expectations(curve, path).items():
            expected.setdefault(k, set()).add(e)
    held_at_zero = {k for k, es in expected.items() if "zero" in es and "ran" not in es}
    idle = [k["name"] for k in kernels if k["launches"] == 0 and k["name"] not in held_at_zero]
    if idle:
        raise AssertionError(f"kernels that no path launched: {idle}")
    _say("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _exit(code: int) -> None:
    """End the process without the interpreter's finalization, which hangs
    once a profiler session has detached CUPTI (TEARDOWN_CUPTI=1, torch
    2.11): the pools' workers are stopped and the output flushed first."""
    import multiprocessing

    children = multiprocessing.active_children()
    for child in children:
        child.terminate()
    for child in children:
        child.join(10)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    try:
        code = main()
    except SystemExit:      # no card: raised before torch touches one
        raise
    except BaseException:   # noqa: BLE001 (reported, then the run fails)
        traceback.print_exc()
        code = 1
    _exit(code)
