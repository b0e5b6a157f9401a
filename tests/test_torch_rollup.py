"""gnark's rollup (examples/rollup.py) over the port's gadgets, against the JAX
package, on the CPU.

One rollup transfer proves that an EdDSA-signed transfer moves a MiMC
account tree from root_before to root_after (examples/rollup.py, ≙ gnark's
examples/rollup/). ``transfer_circuit`` copies its TransferCircuit
(:41-126) with the tree's depth a parameter, over either package's frontend
and gadgets (the port's ``std/eddsa.py``, ``std/merkle.py``,
``std/hash/mimc.py`` and ``curves/twisted_edwards.py``); ``Operator`` copies
its host operator (:129-176). ``rollup_batch`` chains transfers as
chip_smoke.py's phase rollup does: each transfer's root_after is the next
one's root_before, the first and the last root public, the others secret.

At depth 2 (the example's DEPTH) the port's transfer compiles to the JAX
example's own system (21,351 constraints) and solves to its wires on the
JAX operator's witness; an overdraft and a forged signature are refused by
both solvers. The full batch of chip_smoke.py (8 transfers at depth 24,
637,208 constraints) and the R1CS keccak256 of 64 bytes (189,664
constraints) compile for about a minute in each package and are marked
slow. No prove here: the prover is the one the other tests hold to the JAX
package. Every comparison is exact.
"""

import hashlib
import importlib.util
import pathlib
import pickle

import pytest

from gnark_icicle_tpu_torch.curves import bn254

from test_torch_emulated import PKGS, _plain, mod
from test_torch_std import assert_same_system, hash_circuit

Q = bn254.R
REPO = pathlib.Path(__file__).resolve().parents[1]
TRANSFER_FIELDS = ("sender_pub_x", "sender_pub_y", "receiver_pub_x", "receiver_pub_y",
                   "sender_balance", "sender_nonce", "receiver_balance", "receiver_nonce",
                   "amount", "sig_rx", "sig_ry", "sig_s", "sender_sibs", "sender_dirs",
                   "receiver_sibs", "receiver_dirs")


def example():
    """examples/rollup.py, the JAX package's rollup example."""
    spec = importlib.util.spec_from_file_location("rollup_example",
                                                  REPO / "examples" / "rollup.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def transfer_circuit(pkg: str, depth: int):
    """examples/rollup.py's TransferCircuit over pkg's frontend and
    gadgets, at `depth`."""
    fe = mod(pkg, "frontend")
    MiMC = mod(pkg, "std.hash.mimc").MiMC
    verify_signature = mod(pkg, "std.eddsa").verify_signature

    class TransferCircuit(fe.Circuit):
        root_before = fe.Public()
        root_after = fe.Public()
        sender_pub_x = fe.Secret()
        sender_pub_y = fe.Secret()
        receiver_pub_x = fe.Secret()
        receiver_pub_y = fe.Secret()
        sender_balance = fe.Secret()
        sender_nonce = fe.Secret()
        receiver_balance = fe.Secret()
        receiver_nonce = fe.Secret()
        amount = fe.Secret()
        sig_rx = fe.Secret()
        sig_ry = fe.Secret()
        sig_s = fe.Secret()
        sender_sibs = fe.Secret(shape=depth)
        sender_dirs = fe.Secret(shape=depth)
        receiver_sibs = fe.Secret(shape=depth)
        receiver_dirs = fe.Secret(shape=depth)

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
            h = MiMC(api, Q)
            h.write(self.sender_pub_x, self.receiver_pub_x, self.amount, self.sender_nonce)
            verify_signature(api, Q, (self.sender_pub_x, self.sender_pub_y),
                             (self.sig_rx, self.sig_ry), self.sig_s, h.sum())
            api.assert_is_less_or_equal(self.amount, self.sender_balance)
            root = self._root(api, self._leaf(api, self.sender_pub_x, self.sender_pub_y,
                                              self.sender_balance, self.sender_nonce),
                              self.sender_sibs, self.sender_dirs)
            api.assert_is_equal(root, self.root_before)
            root_mid = self._root(api, self._leaf(api, self.sender_pub_x, self.sender_pub_y,
                                                  api.sub(self.sender_balance, self.amount),
                                                  api.add(self.sender_nonce, 1)),
                                  self.sender_sibs, self.sender_dirs)
            root2 = self._root(api, self._leaf(api, self.receiver_pub_x, self.receiver_pub_y,
                                               self.receiver_balance, self.receiver_nonce),
                               self.receiver_sibs, self.receiver_dirs)
            api.assert_is_equal(root2, root_mid)
            root3 = self._root(api, self._leaf(api, self.receiver_pub_x, self.receiver_pub_y,
                                               api.add(self.receiver_balance, self.amount),
                                               self.receiver_nonce),
                               self.receiver_sibs, self.receiver_dirs)
            api.assert_is_equal(root3, self.root_after)

    return TransferCircuit


def rollup_batch(pkg: str, depth: int, transfers: int):
    """`transfers` TransferCircuits chained through secret roots, as
    chip_smoke.py's RollupBatch."""
    fe = mod(pkg, "frontend")
    Transfer = transfer_circuit(pkg, depth)

    class RollupBatch(fe.Circuit):
        root_before = fe.Public()
        root_after = fe.Public()
        roots = fe.Secret(shape=transfers - 1)
        sender_pub_x = fe.Secret(shape=transfers)
        sender_pub_y = fe.Secret(shape=transfers)
        receiver_pub_x = fe.Secret(shape=transfers)
        receiver_pub_y = fe.Secret(shape=transfers)
        sender_balance = fe.Secret(shape=transfers)
        sender_nonce = fe.Secret(shape=transfers)
        receiver_balance = fe.Secret(shape=transfers)
        receiver_nonce = fe.Secret(shape=transfers)
        amount = fe.Secret(shape=transfers)
        sig_rx = fe.Secret(shape=transfers)
        sig_ry = fe.Secret(shape=transfers)
        sig_s = fe.Secret(shape=transfers)
        sender_sibs = fe.Secret(shape=(transfers, depth))
        sender_dirs = fe.Secret(shape=(transfers, depth))
        receiver_sibs = fe.Secret(shape=(transfers, depth))
        receiver_dirs = fe.Secret(shape=(transfers, depth))

        def define(self, api):
            roots = [self.root_before, *self.roots, self.root_after]
            for i in range(transfers):
                Transfer(root_before=roots[i], root_after=roots[i + 1],
                         **{k: getattr(self, k)[i] for k in TRANSFER_FIELDS}).define(api)

    return RollupBatch


class Operator:
    """examples/rollup.py's Operator over pkg's host modules: 2^depth
    accounts of balance 1000 in a dense MerkleTreeHost; transfer() returns
    the TransferCircuit assignment as a dict."""

    def __init__(self, pkg: str, depth: int):
        self.te = mod(pkg, "curves.twisted_edwards")
        self.mimc = mod(pkg, "std.hash.mimc").MiMCHost
        self.keys = [self.te.generate_key(f"acct{i}".encode()) for i in range(1 << depth)]
        self.balances = [1000] * (1 << depth)
        self.nonces = [0] * (1 << depth)
        self.tree = mod(pkg, "std.merkle").MerkleTreeHost(
            Q, [self.leaf(i) for i in range(1 << depth)])

    def hash(self, *values) -> int:
        h = self.mimc(Q)
        h.write(*values)
        return h.h

    def leaf(self, i: int) -> int:
        pub = self.keys[i].public
        return self.hash(pub[0], pub[1], self.balances[i], self.nonces[i])

    def transfer(self, frm: int, to: int, amount: int) -> dict:
        kp, dest = self.keys[frm], self.keys[to]
        R, s = self.te.sign(kp, self.hash(kp.public[0], dest.public[0], amount,
                                          self.nonces[frm]))
        sibs, dirs = self.tree.proof(frm)
        w = dict(root_before=self.tree.root, sender_pub_x=kp.public[0],
                 sender_pub_y=kp.public[1], receiver_pub_x=dest.public[0],
                 receiver_pub_y=dest.public[1], sender_balance=self.balances[frm],
                 sender_nonce=self.nonces[frm], receiver_balance=self.balances[to],
                 receiver_nonce=self.nonces[to], amount=amount, sig_rx=R[0], sig_ry=R[1],
                 sig_s=s, sender_sibs=sibs, sender_dirs=dirs)
        self.balances[frm] -= amount
        self.nonces[frm] += 1
        self.tree.update(frm, self.leaf(frm))
        w["receiver_sibs"], w["receiver_dirs"] = self.tree.proof(to)
        self.balances[to] += amount
        self.tree.update(to, self.leaf(to))
        w["root_after"] = self.tree.root
        return w


def batch_values(transfers: list) -> dict:
    """RollupBatch's input values from its transfers' assignments."""
    return dict(root_before=transfers[0]["root_before"], root_after=transfers[-1]["root_after"],
                roots=[t["root_after"] for t in transfers[:-1]],
                **{k: [t[k] for t in transfers] for k in TRANSFER_FIELDS})


def test_transfer_circuit_matches_the_reference_example():
    """At the example's depth 2: the port's TransferCircuit compiles to
    examples/rollup.py's system (21,351 constraints); the port's operator
    gives the JAX example's witness; the two native solvers give the same
    wires; an overdraft (one more than the sender holds) and a signature
    with s + 1 are refused by both."""
    ex = example()
    assert ex.DEPTH == 2
    port = transfer_circuit(PKGS[0], ex.DEPTH)
    systems = [mod(PKGS[0], "frontend").compile_circuit(Q, port),
               mod(PKGS[1], "frontend").compile_circuit(Q, ex.TransferCircuit)]
    assert systems[0].nb_constraints == 21_351
    assert_same_system(*systems)
    ref = ex.Operator().transfer(0, 1, 250)
    good = [Operator(PKGS[0], ex.DEPTH).transfer(0, 1, 250),
            {k: getattr(ref, k) for k in ("root_before", "root_after") + TRANSFER_FIELDS}]
    assert good[0] == good[1]
    overdraft = Operator(PKGS[0], ex.DEPTH).transfer(2, 3, 1001)
    forged = {**good[0], "sig_s": good[0]["sig_s"] + 1}
    wires = []
    for pkg, cs, Circuit in zip(PKGS, systems, (port, ex.TransferCircuit)):
        solver = mod(pkg, "constraint.solver")
        wires.append(list(solver.solve(cs, *Circuit(**good[0]).witness_values(Q)).wires))
        for bad in (overdraft, forged):
            with pytest.raises(solver.UnsatisfiedConstraintError):
                solver.solve(cs, *Circuit(**bad).witness_values(Q))
    assert wires[0] == wires[1]


def batch_systems(depth: int, transfers: int) -> list:
    """RollupBatch compiled in both packages, one system at a time in
    memory: per package (constraints, secret inputs, its system's fields as
    sha256 digests of their plain data), the port's system last."""
    out = []
    for pkg in reversed(PKGS):
        cs = mod(pkg, "frontend").compile_circuit(Q, rollup_batch(pkg, depth, transfers))
        out.append((cs.nb_constraints, cs.nb_secret, {
            k: hashlib.sha256(pickle.dumps(_plain(v), protocol=5)).hexdigest()
            for k, v in cs.__getstate__().items() if not k.startswith("_")}))
    return out + [cs]


def test_rollup_batch_chains_transfers_as_the_reference():
    """Two transfers at depth 2 chained through a secret root: twice the
    transfer's constraints, the same system in both packages; the port's
    solver accepts two operator transfers in a row and refuses the batch
    with a wrong intermediate root."""
    ref, port, cs = batch_systems(2, 2)
    assert ref == port and port[0] == 2 * 21_351 and port[1] == 1 + 2 * (12 + 4 * 2)
    op_ = Operator(PKGS[0], 2)
    values = batch_values([op_.transfer(0, 1, 250), op_.transfer(1, 2, 300)])
    Batch = rollup_batch(PKGS[0], 2, 2)
    solver = mod(PKGS[0], "constraint.solver")
    solver.solve(cs, *Batch(**values).witness_values(Q))
    with pytest.raises(solver.UnsatisfiedConstraintError):
        solver.solve(cs, *Batch(**{**values, "roots": [values["roots"][0] + 1]})
                     .witness_values(Q))


@pytest.mark.slow
def test_full_rollup_batch_and_r1cs_keccak_compile_to_the_reference():
    """chip_smoke.py's RollupBatch at full size (8 transfers at depth 24:
    637,208 constraints, 871 secret inputs) and keccak256 of 64 bytes under
    the R1CS builder (189,664 constraints): the same systems in both
    packages. About a minute of compile in each package."""
    ref, port, _ = batch_systems(24, 8)
    assert ref == port and port[:2] == (637_208, 871)
    systems = [mod(pkg, "frontend").compile_circuit(Q, hash_circuit(pkg, "keccak256", 64))
               for pkg in PKGS]
    assert systems[0].nb_constraints == 189_664
    assert_same_system(*systems)
