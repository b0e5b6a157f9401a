"""Circuit declaration + compilation (≙ frontend.Compile + schema walk).

Role parity: reference frontend/compile.go:36-133 (parseCircuit: schema walk
→ public/secret wire allocation → user Define → builder.Compile) and
frontend/schema (struct-tag reflection). The Python shape: inputs are
declared as class attributes ``x = Secret()`` / ``y = Public(shape=(4,))``;
``define(self, api)`` is the user hook (≙ frontend.Circuit.Define,
frontend/circuit.go:39). Public wires are allocated before secret wires in
declaration order, matching the reference's witness ordering so witness
serialization stays compatible.

Copied from gnark_icicle_tpu/frontend/compile.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import itertools

from .api import Builder, Var


class _Input:
    """Declaration marker for a circuit input (≙ gnark:",public/secret" tag)."""

    _counter = itertools.count()

    def __init__(self, public: bool, shape=None):
        self.public = public
        self.shape = shape  # None = scalar, int n = vector, tuple = nd
        self.order = next(self._counter)
        self.name = None  # filled by __set_name__

    def __set_name__(self, owner, name):
        self.name = name

    def leaf_names(self):
        if self.shape is None:
            return [self.name]
        dims = (self.shape,) if isinstance(self.shape, int) else tuple(self.shape)
        names = []
        for idx in itertools.product(*(range(d) for d in dims)):
            names.append(self.name + "".join(f"[{i}]" for i in idx))
        return names

    def pack(self, leaves):
        """Flat leaf list -> scalar / (nested) list matching the shape."""
        if self.shape is None:
            return leaves[0]
        dims = (self.shape,) if isinstance(self.shape, int) else tuple(self.shape)

        def build(d, it):
            if d == len(dims):
                return next(it)
            return [build(d + 1, it) for _ in range(dims[d])]

        return build(0, iter(leaves))

    def flatten(self, value):
        """User-assigned value -> flat leaf list (validates the shape)."""
        if self.shape is None:
            return [value]
        dims = (self.shape,) if isinstance(self.shape, int) else tuple(self.shape)
        flat = []

        def walk(v, d):
            if d == len(dims):
                flat.append(v)
                return
            if len(v) != dims[d]:
                raise ValueError(
                    f"{self.name}: expected length {dims[d]} at depth {d}"
                )
            for x in v:
                walk(x, d + 1)

        walk(value, 0)
        return flat


def Public(shape=None) -> _Input:
    return _Input(public=True, shape=shape)


def Secret(shape=None) -> _Input:
    return _Input(public=False, shape=shape)


class Circuit:
    """Base class for circuits (≙ frontend.Circuit).

    Subclasses declare inputs as class attributes and implement
    ``define(self, api)``. Instances built with keyword values act as witness
    assignments (the gnark pattern of one struct for both roles).
    """

    def __init__(self, **values):
        for k, v in values.items():
            if not isinstance(getattr(type(self), k, None), _Input):
                raise ValueError(f"{type(self).__name__} has no input {k!r}")
            setattr(self, k, v)

    def define(self, api):  # pragma: no cover - abstract
        raise NotImplementedError

    # -- declaration introspection ---------------------------------------
    @classmethod
    def _inputs(cls):
        seen = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, _Input):
                    seen[k] = v
        return sorted(seen.values(), key=lambda d: d.order)

    # -- witness extraction -----------------------------------------------
    def witness_values(self, modulus: int):
        """(public_leaves, secret_leaves) in wire-allocation order."""
        pub, sec = [], []
        for decl in self._inputs():
            v = getattr(self, decl.name, None)
            if v is None or isinstance(v, _Input):
                raise ValueError(f"input {decl.name!r} not assigned")
            leaves = [int(x) % modulus for x in decl.flatten(v)]
            (pub if decl.public else sec).extend(leaves)
        return pub, sec

    def public_values(self, modulus: int):
        return self.witness_values(modulus)[0]


def compile_circuit(modulus: int, circuit_cls, builder: str = "r1cs", **kwargs):
    """Compile a circuit class to a constraint system (≙ frontend.Compile).

    builder: "r1cs" (Groth16, ≙ r1cs.NewBuilder) or "scs" (PLONK,
    ≙ scs.NewBuilder). Returns the constraint system; input wire layout is
    recorded in the CS's public/secret name lists.
    """
    if builder == "r1cs":
        builder = Builder(modulus)
    elif builder == "scs":
        from .scs_builder import ScsBuilder

        builder = ScsBuilder(modulus)
    else:
        raise ValueError(f"unknown builder {builder!r}")
    inst = circuit_cls.__new__(circuit_cls)  # no witness values needed

    decls = circuit_cls._inputs()
    # public wires first, then secret (frontend/compile.go:83-112 order)
    for decl in decls:
        if decl.public:
            leaves = [builder.public_variable(n) for n in decl.leaf_names()]
            setattr(inst, decl.name, decl.pack(leaves))
    for decl in decls:
        if not decl.public:
            leaves = [builder.secret_variable(n) for n in decl.leaf_names()]
            setattr(inst, decl.name, decl.pack(leaves))

    inst.define(builder)
    _run_deferred(builder)
    return builder.cs


def _run_deferred(api):
    """Run deferred gadget finalizers (≙ callDeferred, frontend/compile.go:133
    and internal/circuitdefer). Callbacks may defer more callbacks."""
    pending = getattr(api, "_deferred", None)
    if not pending:
        return
    i = 0
    while i < len(pending):
        pending[i](api)
        i += 1
    pending.clear()


def defer_circuit(api, cb):
    """Register cb(api) to run after define returns (≙ api.Defer /
    circuitdefer.Put). Works on builders and the test engine."""
    if not hasattr(api, "_deferred"):
        api._deferred = []
    api._deferred.append(cb)
