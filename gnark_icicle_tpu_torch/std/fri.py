"""FRI proof of proximity: host prover + in-circuit verifier.

Role parity: reference std/commitments/fri (fri.go RadixTwoFri — radix-2
folding rounds committed with MiMC Merkle trees, Fiat-Shamir folding
challenges, per-query pair openings with folding-consistency checks down to
a constant evaluation; ρ = 8 blowup). Layout simplification vs the
reference (documented): evaluations stay in natural domain order with the
±x pair at (j, j + N/2), so the query-position chain is pure bit-dropping —
no sorted↔canonical permutation hint is needed. Prover and verifier share
the transcript code (prover runs it on the test engine), as everywhere else
in this framework.

Copied from gnark_icicle_tpu/std/fri.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .fiat_shamir import CircuitTranscript
from .merkle import MerkleTreeHost, verify_proof

RHO = 8
LOG_RHO = 3


def _names(nb_steps: int, nb_queries: int) -> list:
    return ([f"fri.x{i}" for i in range(nb_steps)] + ["fri.eval"]
            + [f"fri.q{k}" for k in range(nb_queries)])


@dataclass
class FriQueryRound:
    lo: int          # f_i at position p
    hi: int          # f_i at position p + N_i/2
    lo_sibs: list    # Merkle siblings for lo (bottom-up)
    hi_sibs: list


@dataclass
class FriProof:
    roots: list                       # per-round Merkle roots
    evaluation: int                   # the final constant
    queries: list = field(default_factory=list)  # [per query: [FriQueryRound]]


class Fri:
    """Radix-2 FRI over the proving field (≙ RadixTwoFri).

    size: claimed degree bound (power of two). The evaluation domain has
    ρ·size points on the 2^k-torsion of fr.
    """

    def __init__(self, prime_field, size: int, nb_queries: int = 4):
        assert size & (size - 1) == 0 and size >= 2
        self.fr = prime_field
        self.q = prime_field.modulus
        self.size = size
        self.nb_queries = nb_queries
        self.n0 = RHO * size
        self.nb_steps = size.bit_length() - 1  # log2(size)
        self.log_n0 = self.n0.bit_length() - 1
        self.gen = prime_field.root_of_unity(self.log_n0)

    # -- host prover --------------------------------------------------------
    def prove(self, coeffs: list) -> FriProof:
        """Proof that `coeffs` (degree < size) is low-degree (honest case);
        proofs for higher-degree functions fail verification w.h.p."""
        from ..frontend.engine import Engine

        q = self.q
        assert len(coeffs) <= self.size
        # evaluate on the blown-up domain (host NTT-free: fine at test sizes)
        g = self.gen
        evals = []
        x = 1
        for _ in range(self.n0):
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * x + c) % q
            evals.append(acc)
            x = x * g % q
        return self.prove_evals(evals)

    def prove_evals(self, evals: list) -> FriProof:
        from ..frontend.engine import Engine

        q = self.q
        assert len(evals) == self.n0
        eng = Engine(q)
        ts = CircuitTranscript(
            eng, q, _names(self.nb_steps, self.nb_queries)
        )
        layers = [list(evals)]
        trees = [MerkleTreeHost(q, layers[0])]
        xis = []
        gi = self.gen
        inv2 = pow(2, -1, q)
        cur = list(evals)
        for i in range(self.nb_steps):
            ts.bind(f"fri.x{i}", [trees[i].root])
            xi = ts.compute_challenge(f"fri.x{i}")
            xis.append(xi)
            n = len(cur)
            gj_inv = 1
            g_inv = pow(gi, -1, q)
            nxt = []
            for j in range(n // 2):
                fe = (cur[j] + cur[j + n // 2]) * inv2 % q
                fo = (cur[j] - cur[j + n // 2]) * inv2 % q * gj_inv % q
                nxt.append((fe + xi * fo) % q)
                gj_inv = gj_inv * g_inv % q
            cur = nxt
            gi = gi * gi % q
            if i + 1 < self.nb_steps:
                layers.append(list(cur))
                trees.append(MerkleTreeHost(q, cur))
        # cur has ρ entries of (supposedly) a constant polynomial
        evaluation = cur[0]
        ts.bind("fri.eval", [evaluation])
        ts.compute_challenge("fri.eval")

        proof = FriProof(
            roots=[t.root for t in trees], evaluation=evaluation
        )
        for k in range(self.nb_queries):
            seed = ts.compute_challenge(f"fri.q{k}")
            pos = seed % (self.n0 // 2)
            rounds = []
            p = pos
            for i in range(self.nb_steps):
                n_i = self.n0 >> i
                pp = p % (n_i // 2)
                lo_s, _ = trees[i].proof(pp)
                hi_s, _ = trees[i].proof(pp + n_i // 2)
                rounds.append(FriQueryRound(
                    lo=layers[i][pp], hi=layers[i][pp + n_i // 2],
                    lo_sibs=lo_s, hi_sibs=hi_s,
                ))
                p = pp  # consumed below as p mod next half-size
            proof.queries.append(rounds)
        return proof

    # -- in-circuit verifier -------------------------------------------------
    def verify(self, api, proof: FriProof) -> None:
        """Constrain the proof (roots/evaluation/openings as circuit
        variables) to a valid proximity proof
        (≙ VerifyProofOfProximity, fri.go:227)."""
        q = self.q
        ts = CircuitTranscript(api, q, _names(self.nb_steps,
                                              self.nb_queries))
        xis = []
        for i in range(self.nb_steps):
            ts.bind(f"fri.x{i}", [proof.roots[i]])
            xis.append(ts.compute_challenge(f"fri.x{i}"))
        ts.bind("fri.eval", [proof.evaluation])
        ts.compute_challenge("fri.eval")

        inv2 = pow(2, -1, q)
        # host tables of w_i^{-2^j} for the in-circuit exponentiations
        ginv_pows = []  # per round: [g_i^{-2^j} for j < log(N_i/2)]
        gi_inv = pow(self.gen, -1, q)
        for i in range(self.nb_steps):
            bits_i = self.log_n0 - 1 - i
            row = []
            cur = gi_inv
            for _ in range(bits_i):
                row.append(cur)
                cur = cur * cur % q
            ginv_pows.append(row)
            gi_inv = gi_inv * gi_inv % q

        for k in range(self.nb_queries):
            seed = ts.compute_challenge(f"fri.q{k}")
            # full-width decomposition; like the reference's ToBinary-based
            # query derivation a malicious witness could pick the seed+q
            # representation, which at worst redirects single queries —
            # bounded soundness slack, identical to fri.go:131-133
            seed_bits = api.to_binary(seed, self.q.bit_length())
            pos_bits = seed_bits[: self.log_n0 - 1]  # p0 < N0/2 (low bits)
            rounds = proof.queries[k]
            fold_prev = None
            sel_prev = None
            for i in range(self.nb_steps):
                n_bits = self.log_n0 - 1 - i   # bits of the pair position
                pp_bits = pos_bits[:n_bits]
                r = rounds[i]
                # Merkle membership of both pair halves (tree depth
                # = n_bits + 1; hi has the top direction bit set)
                verify_proof(api, q, proof.roots[i], r.lo, r.lo_sibs,
                             pp_bits + [0])
                verify_proof(api, q, proof.roots[i], r.hi, r.hi_sibs,
                             pp_bits + [1])
                if fold_prev is not None:
                    got = api.select(sel_prev, r.hi, r.lo)
                    api.assert_is_equal(got, fold_prev)
                # fold: (lo+hi)/2 + xi·(lo−hi)·w^{-p}/2
                x_inv = 1
                for b, wconst in zip(pp_bits, ginv_pows[i]):
                    x_inv = api.mul(x_inv, api.select(b, wconst, 1))
                fe = api.mul(api.add(r.lo, r.hi), inv2)
                fo = api.mul(api.mul(api.sub(r.lo, r.hi), inv2), x_inv)
                fold_prev = api.add(fe, api.mul(xis[i], fo))
                # next round's selector = the bit dropped from the position
                sel_prev = pos_bits[n_bits - 1]
                pos_bits = pos_bits[: n_bits - 1]
            api.assert_is_equal(fold_prev, proof.evaluation)
