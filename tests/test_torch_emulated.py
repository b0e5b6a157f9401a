"""The emulated-field layer of the port's std/ against the JAX package's, on
the CPU.

gnark_icicle_tpu_torch/std/ holds copies of the JAX package's emulated
arithmetic (``emulated.py``: the deferred mulcheck and its hints, every
``EmulatedParams`` preset), the gadgets it stands on (``math_cmp.py``,
``multicommit.py``, ``logderivlookup.py``, ``rangecheck.py``), the curves
over it (``sw_emulated.py``) and the BN254 towers and pairing
(``algebra_towers.bn254_towers``, ``pairing_bn254.py``). The same circuits,
built over each package's frontend and gadgets, give the same systems
(R1CS and SCS) and the same wires; the Engine accepts and rejects the same
witnesses; every hint has the JAX package's id and outputs. Inputs come from
numpy seeds, the commitment's hiding mask is fixed (``fixed_mask``, as in
tests/test_torch_bsb22.py); every comparison is exact.
"""

import dataclasses
import importlib
import secrets

import numpy as np
import pytest

from gnark_icicle_tpu_torch.curves import bn254

Q = bn254.R
PKGS = ("gnark_icicle_tpu_torch", "gnark_icicle_tpu")
FIELDS = ("SECP256K1_FP", "BN254_FP")
# the hints of the new modules, by module and registered name
HINTS = {"std.emulated": ("emulated.mulmod", "emulated.mulcheck", "emulated.varmulcheck",
                          "emulated.ltdec", "emulated.invmod"),
         "std.math_cmp": ("cmp.is_less",),
         "std.logderivlookup": ("logderivlookup.lookup", "logderivlookup.count"),
         "std.rangecheck": ("rangecheck.decompose",),
         "std.evmprecompiles": ("evm.ecrecover",)}


@pytest.fixture(autouse=True)
def fixed_mask(monkeypatch):
    """Both packages' api.commit mask (secrets.randbelow) fixed, so that
    the two solves see one witness."""
    monkeypatch.setattr(secrets, "randbelow", lambda m: 0x5EED % m)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def limbs(value: int, params) -> list:
    return [(value >> (params.limb_bits * i)) & ((1 << params.limb_bits) - 1)
            for i in range(params.n_limbs)]


def rand_below(seed: int, bound: int, n: int) -> list:
    """n values below bound from a numpy seed."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, -(-bound.bit_length() // 32)), dtype=np.uint64)
    return [int.from_bytes(w.astype("<u4").tobytes(), "little") % bound for w in words]


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {k: _plain(x) for k, x in vars(v).items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


def state(cs) -> dict:
    """A compiled system as plain data (an R1CS by its pickled state, an SCS
    by its fields), hint records and commitments as dicts."""
    raw = cs.__getstate__() if hasattr(cs, "nb_constraints") else vars(cs)
    return {k: _plain(v) for k, v in raw.items() if not k.startswith("_")}


def emulated_op(pkg: str, field: str, op: str):
    """z == op(x[, y]) over an emulated field; ``canonical`` asks
    from_limbs to hold x below the modulus."""
    fe = mod(pkg, "frontend")
    em = mod(pkg, "std.emulated")
    params = getattr(em, field)
    k = params.n_limbs

    class EmulOp(fe.Circuit):
        x = fe.Secret(shape=k)
        y = fe.Secret(shape=k)
        z = fe.Public(shape=k)

        def define(self, api):
            f = em.EmulatedField(api, params, Q)
            a = f.from_limbs(self.x, canonical=op == "canonical")
            b = f.from_limbs(self.y)
            got = {"mul": lambda: f.mul(a, b), "div": lambda: f.div(a, b),
                   "inverse": lambda: f.inverse(a), "canonical": lambda: f.add(a, b)}[op]()
            f.assert_equal(got, f.from_limbs(self.z))

    return EmulOp, params


def op_witness(params, op: str, seed: int, wrong: bool = False) -> tuple:
    p = params.modulus
    x, y = rand_below(seed, p - 1, 2)
    x, y = x + 1, y + 1
    z = {"mul": x * y, "div": x * pow(y, -1, p), "inverse": pow(x, -1, p),
         "canonical": x + y}[op] % p
    return x, y, (z + wrong) % p


def values(Circuit, params, x, y, z) -> tuple:
    return Circuit(x=limbs(x, params), y=limbs(y, params),
                   z=limbs(z, params)).witness_values(Q)


@pytest.mark.parametrize("builder", ["r1cs", "scs"])
@pytest.mark.parametrize("op", ["mul", "div", "inverse"])
@pytest.mark.parametrize("field", FIELDS)
def test_emulated_ops_compile_and_solve_as_the_reference(field, op, builder):
    """The same system under each builder, the same wires from each
    package's solver (the port's native one for an R1CS), and a wrong result
    refused by both; the R1CS of a mul is the JAX package's 391 constraints
    (latest_stats.csv) and every system stays under 6,000."""
    systems, wires = [], []
    for pkg in PKGS:
        Circuit, params = emulated_op(pkg, field, op)
        cs = mod(pkg, "frontend").compile_circuit(Q, Circuit, builder=builder)
        systems.append(cs)
        pub, sec = values(Circuit, params, *op_witness(params, op, 1))
        bpub, bsec = values(Circuit, params, *op_witness(params, op, 1, wrong=True))
        if builder == "r1cs":
            solver = mod(pkg, "constraint.solver")
            native = {"native": True} if pkg == PKGS[0] else {"native": False}
            wires.append(solver.solve(cs, pub, sec, **native).wires)
            with pytest.raises(solver.UnsatisfiedConstraintError):
                solver.solve(cs, bpub, bsec, **native)
        else:
            scs = mod(pkg, "constraint.scs")
            wires.append(list(scs.solve_scs(cs, pub, sec)[0]))
            with pytest.raises(scs.SparseUnsatisfiedError):
                scs.solve_scs(cs, bpub, bsec)
    assert state(systems[0]) == state(systems[1])
    assert wires[0] == wires[1]
    if builder == "r1cs":
        assert systems[0].nb_constraints < 6000
        if op == "mul":
            assert systems[0].nb_constraints == 391


@pytest.mark.parametrize("field", FIELDS)
def test_engine_accepts_and_rejects_as_the_reference(field):
    """The Engine (the frontend's direct evaluator) of both packages: a
    mul, div and inverse solved, a wrong product refused."""
    for op in ("mul", "div", "inverse"):
        for seed, wrong in ((2, False), (3, True)):
            got = []
            for pkg in PKGS:
                Circuit, params = emulated_op(pkg, field, op)
                x, y, z = op_witness(params, op, seed, wrong)
                w = Circuit(x=limbs(x, params), y=limbs(y, params), z=limbs(z, params))
                got.append(mod(pkg, "frontend").is_solved(w, Q))
            assert got == [not wrong] * 2, (op, seed)


def test_assert_canonical_rejects_as_the_reference():
    """from_limbs(canonical=True): n − 1 accepted, n, n + 5 and 2^256 − 1
    refused by both Engines; compiled, x = p + 1 (non-canonical, still in
    range) and a limb of 2^64 (out of range) leave both systems unsolved."""
    for pkg in PKGS:
        em = mod(pkg, "std.emulated")
        engine = mod(pkg, "frontend.engine")
        n = em.SECP256K1_FR.modulus
        f = em.EmulatedField(engine.Engine(Q), em.SECP256K1_FR, Q)
        f.from_limbs(limbs(n - 1, em.SECP256K1_FR), canonical=True)
        for bad in (n, n + 5, (1 << 256) - 1):
            with pytest.raises(Exception):
                em.EmulatedField(engine.Engine(Q), em.SECP256K1_FR, Q).from_limbs(
                    limbs(bad, em.SECP256K1_FR), canonical=True)
    systems = []
    for pkg in PKGS:
        Circuit, params = emulated_op(pkg, "SECP256K1_FP", "canonical")
        cs = mod(pkg, "frontend").compile_circuit(Q, Circuit)
        systems.append(cs)
        solver = mod(pkg, "constraint.solver")
        p = params.modulus
        solver.solve(cs, *values(Circuit, params, p - 1, 1, 0))
        for x in (p + 1,):
            with pytest.raises(solver.UnsatisfiedConstraintError):
                solver.solve(cs, *values(Circuit, params, x, 1, 2))
        pub, sec = values(Circuit, params, (1 << 64) + 5, 1, (1 << 64) + 6)
        sec = [sec[0] + (1 << 64), 0] + sec[2:]    # the same value, a limb of 65 bits
        with pytest.raises(solver.UnsatisfiedConstraintError):
            solver.solve(cs, pub, sec)
    assert state(systems[0]) == state(systems[1])


def range_lookup(pkg: str):
    """Four values range-checked to 8, 10, 16 and 20 bits, and two lookups
    into a table of five constants, under one multicommit api.commit."""
    fe = mod(pkg, "frontend")
    rc = mod(pkg, "std.rangecheck")
    ld = mod(pkg, "std.logderivlookup")

    class RangeLookup(fe.Circuit):
        xs = fe.Secret(shape=4)
        idx = fe.Secret(shape=2)
        out = fe.Public(shape=2)

        def define(self, api):
            checker = rc.RangeChecker(api)
            for x, bits in zip(self.xs, (8, 10, 16, 20)):
                checker.check(x, bits)
            table = ld.Table(api)
            for v in TABLE:
                table.insert(v)
            for got, want in zip(table.lookup(*self.idx), self.out):
                api.assert_is_equal(got, want)

    return RangeLookup


TABLE = (11, 13, 17, 19, 23)


def range_witness(seed: int, too_wide: bool = False) -> dict:
    xs = [v % (1 << b) for v, b in zip(rand_below(seed, 1 << 20, 4), (8, 10, 16, 20))]
    if too_wide:
        xs[2] = 1 << 16
    idx = [int(i) % len(TABLE) for i in rand_below(seed + 1, 5, 2)]
    return {"xs": xs, "idx": idx, "out": [TABLE[i] for i in idx]}


@pytest.mark.parametrize("builder", ["r1cs", "scs"])
def test_rangecheck_and_logderivlookup_match(builder):
    """rangecheck and logderivlookup: the same system and commitment under
    each builder, the same wires, and a value one bit too wide and a wrong
    lookup refused by both packages."""
    systems, wires = [], []
    for pkg in PKGS:
        Circuit = range_lookup(pkg)
        cs = mod(pkg, "frontend").compile_circuit(Q, Circuit, builder=builder)
        systems.append(cs)
        good = Circuit(**range_witness(4)).witness_values(Q)
        wide = Circuit(**range_witness(4, too_wide=True)).witness_values(Q)
        w = range_witness(4)
        w["out"] = [w["out"][0] + 1, w["out"][1]]
        lookup = Circuit(**w).witness_values(Q)
        if builder == "r1cs":
            solver = mod(pkg, "constraint.solver")
            wires.append(solver.solve(cs, *good).wires)
            err = solver.UnsatisfiedConstraintError
            run = solver.solve
        else:
            scs = mod(pkg, "constraint.scs")
            wires.append(list(scs.solve_scs(cs, *good)[0]))
            err, run = scs.SparseUnsatisfiedError, scs.solve_scs
        for bad in (wide, lookup):
            with pytest.raises(err):
                run(cs, *bad)
        assert len(cs.commitments) == 1
    assert state(systems[0]) == state(systems[1])
    assert wires[0] == wires[1]


def hint_circuits(pkg: str) -> dict:
    """Circuits that reach the hints emulated_op does not: a product under
    the "carry" strategy (emulated.mulmod) and a product modulo a witness
    modulus (emulated.varmulcheck, emulated.ltdec)."""
    fe = mod(pkg, "frontend")
    em = mod(pkg, "std.emulated")
    k = em.BN254_FP.n_limbs

    class CarryMul(fe.Circuit):
        x = fe.Secret(shape=k)
        y = fe.Secret(shape=k)
        z = fe.Public(shape=k)

        def define(self, api):
            f = em.EmulatedField(api, em.BN254_FP, Q, strategy="carry")
            f.assert_equal(f.mul(f.from_limbs(self.x), f.from_limbs(self.y)),
                           f.from_limbs(self.z))

    class ModMul(fe.Circuit):
        x = fe.Secret(shape=k)
        y = fe.Secret(shape=k)
        z = fe.Public(shape=k)

        def define(self, api):
            f = em.EmulatedField(api, em.BN254_FP, Q)
            m = f.from_limbs([api.add(v, 0) for v in self.z])
            f.mod_mul(f.from_limbs(self.x), f.from_limbs(self.y), m)

    return {"carry": CarryMul, "modmul": ModMul}


def _recorded_hint_calls(monkeypatch) -> tuple:
    """(name, q, inputs) of every call of the new hints while the JAX
    package's Python solver runs this file's circuits on seeded witnesses
    (each hint's inputs as its gadget lays them out) and evm.ecrecover's on
    signatures of the port's host secp256k1; and the JAX hints by name."""
    ref_hints = mod(PKGS[1], "constraint.hints")
    for module in HINTS:
        mod(PKGS[1], module)
    calls, originals = [], {}
    names = {n for ns in HINTS.values() for n in ns}
    for hid, fn in list(ref_hints._REGISTRY.items()):
        name = ref_hints._NAMES[hid]
        if name in names:
            originals[name] = fn

            def rec(q, inputs, fn=fn, name=name):
                calls.append((name, q, list(inputs)))
                return fn(q, inputs)

            monkeypatch.setitem(ref_hints._REGISTRY, hid, rec)
    fe, solver = mod(PKGS[1], "frontend"), mod(PKGS[1], "constraint.solver")
    em = mod(PKGS[1], "std.emulated")

    def run(Circuit, **w):
        solver.solve(fe.compile_circuit(Q, Circuit), *Circuit(**w).witness_values(Q),
                     native=False)

    extra = hint_circuits(PKGS[1])
    for seed in (5, 6):
        for field in FIELDS:
            for op in ("mul", "div", "inverse", "canonical"):
                Circuit, params = emulated_op(PKGS[1], field, op)
                x, y, z = op_witness(params, op, seed)
                run(Circuit, x=limbs(x, params), y=limbs(y, params), z=limbs(z, params))
        run(range_lookup(PKGS[1]), **range_witness(seed))
        p = em.BN254_FP.modulus
        x, y = rand_below(seed, p, 2)
        run(extra["carry"], x=limbs(x, em.BN254_FP), y=limbs(y, em.BN254_FP),
            z=limbs(x * y % p, em.BN254_FP))
        m = rand_below(seed + 9, p, 1)[0] | 1
        run(extra["modmul"], x=limbs(x, em.BN254_FP), y=limbs(y, em.BN254_FP),
            z=limbs(m, em.BN254_FP))
    secp = mod(PKGS[0], "curves.secp256k1")
    evm = mod(PKGS[1], "std.evmprecompiles")
    for seed in (5, 6):
        priv, pub = secp.keygen(_Rng(seed))
        msg = rand_below(seed, secp.N - 1, 1)[0] + 1
        r, s = secp.sign(priv, msg)
        v = next(v for v in (0, 1) if evm._recover_host(msg, v, r, s) == pub)
        w = [(x >> (64 * i)) & ((1 << 64) - 1) for x in (msg, r, s) for i in range(4)]
        ref_hints.get_hint(ref_hints.hint_id("evm.ecrecover"))(Q, w + [v, 4, 64])
    return calls, originals


class _Rng:
    """random.Random's randrange over a numpy seed (keygen's interface)."""

    def __init__(self, seed):
        self.seed = seed

    def randrange(self, lo, hi):
        return lo + rand_below(self.seed, hi - lo, 1)[0]


def test_hints_have_the_reference_ids_and_outputs(monkeypatch):
    """Every hint of the new modules is registered under the JAX package's
    name, so its id (FNV-1a of the name) is the same, and gives the same
    outputs on the inputs its gadgets lay out (_recorded_hint_calls)."""
    hints, ref_hints = mod(PKGS[0], "constraint.hints"), mod(PKGS[1], "constraint.hints")
    for module, names in HINTS.items():
        port_mod, ref_mod = mod(PKGS[0], module), mod(PKGS[1], module)
        port_ids = {v for v in vars(port_mod).values() if isinstance(v, int)
                    and v in hints._REGISTRY}
        ref_ids = {v for v in vars(ref_mod).values() if isinstance(v, int)
                   and v in ref_hints._REGISTRY}
        assert port_ids == ref_ids == {hints.hint_id(n) for n in names}, module
        for n in names:
            assert hints.hint_name(hints.hint_id(n)) == n
    calls, originals = _recorded_hint_calls(monkeypatch)
    assert {c[0] for c in calls} == set(originals) == {n for ns in HINTS.values() for n in ns}
    for name, q, inputs in calls:
        assert hints.get_hint(hints.hint_id(name))(q, list(inputs)) == \
            originals[name](q, list(inputs)), name


def curve_ops(pkg: str):
    """P + Q, 2·P and 5·P over emulated secp256k1, held to given points."""
    fe = mod(pkg, "frontend")
    sw = mod(pkg, "std.sw_emulated")
    k = sw.SECP256K1.fp.n_limbs

    class CurveOps(fe.Circuit):
        pts = fe.Secret(shape=5 * 2 * k)

        def define(self, api):
            c = sw.EmulatedCurve(api, sw.SECP256K1, Q)
            pts = [c.witness_point(self.pts[2 * k * i:2 * k * i + k],
                                   self.pts[2 * k * i + k:2 * k * (i + 1)]) for i in range(5)]
            p, q, sum_, dbl, five = pts
            c.assert_is_equal(c.add(p, q), sum_)
            c.assert_is_equal(c.double(p), dbl)
            s = c.fr.constant(5)
            c.assert_is_equal(c.scalar_mul(p, s, n_bits=3), five)

    return CurveOps


def test_sw_emulated_add_double_and_small_scalar_mul_in_the_engine():
    """sw_emulated's add, double and a 3-bit scalar multiplication over
    secp256k1 in both Engines: the host's points accepted, a wrong sum
    refused."""
    secp = mod(PKGS[0], "curves.secp256k1")
    g = secp.G1
    a, b = rand_below(7, secp.N - 1, 2)
    p, q = g.scalar_mul(g.generator, a + 1), g.scalar_mul(g.generator, b + 1)
    want = [p, q, g.add(p, q), g.add(p, p), g.scalar_mul(p, 5)]
    wrong = want[:2] + [g.add(want[2], g.generator)] + want[3:]
    for pkg in PKGS:
        sw = mod(pkg, "std.sw_emulated")
        Circuit = curve_ops(pkg)
        fe = mod(pkg, "frontend")
        for pts, ok in ((want, True), (wrong, False)):
            flat = [w for pt in pts for c in pt for w in limbs(c, sw.SECP256K1.fp)]
            assert fe.is_solved(Circuit(pts=flat), Q) is ok, (pkg, ok)


def test_bn254_towers_match_the_host_tower():
    """E2, E6 and E12 products, squares and inverses over emulated BN254 Fp
    (algebra_towers.bn254_towers) in both Engines equal the host tower's."""
    tower = mod(PKGS[0], "curves.tower")
    tp = bn254.TOWER
    vals = rand_below(8, bn254.P, 36)

    def fp2(i):
        return tower.Fp2(tp, vals[2 * i], vals[2 * i + 1])

    def fp6(i):
        return tower.Fp6(tp, fp2(3 * i), fp2(3 * i + 1), fp2(3 * i + 2))

    a12, b12 = tower.Fp12(tp, fp6(0), fp6(1)), tower.Fp12(tp, fp6(2), fp6(3))
    results = []
    for pkg in PKGS:
        towers = mod(pkg, "std.algebra_towers")
        eng = mod(pkg, "frontend.engine").Engine(Q)
        fp, e2, e6, e12 = towers.bn254_towers(eng, Q)

        def g2(v):
            return (fp.constant(v.c0), fp.constant(v.c1))

        def g6(v):
            return (g2(v.b0), g2(v.b1), g2(v.b2))

        def g12(v):
            return (g6(v.a0), g6(v.a1))

        def val(x):
            if isinstance(x, tuple):
                return tuple(val(y) for y in x)
            return fp.value_hint(fp.reduce(x))

        a, b = g12(a12), g12(b12)
        results.append([val(e2.mul(a[0][0], b[0][0])), val(e2.inverse(a[0][0])),
                        val(e6.mul(a[0], b[0])), val(e6.square(a[1])), val(e6.inverse(a[1])),
                        val(e12.mul(a, b)), val(e12.square(a)), val(e12.inverse(b))])

    def host(x):
        if isinstance(x, tower.Fp2):
            return (x.c0, x.c1)
        if isinstance(x, tower.Fp6):
            return (host(x.b0), host(x.b1), host(x.b2))
        return (host(x.a0), host(x.a1))

    want = [host(a12.a0.b0 * b12.a0.b0), host(a12.a0.b0.inv()), host(a12.a0 * b12.a0),
            host(a12.a1.square()), host(a12.a1.inv()), host(a12 * b12), host(a12.square()),
            host(b12.inv())]
    assert results[0] == results[1] == want
