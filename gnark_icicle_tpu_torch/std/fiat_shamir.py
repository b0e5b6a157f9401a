"""In-circuit Fiat-Shamir transcript (≙ reference std/fiat-shamir —
transcript.go:37-55: named challenges bound to all prior absorptions via a
field hasher; MiMC is the hasher here as in the reference's tests).

Copied from gnark_icicle_tpu/std/fiat_shamir.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from .hash.mimc import MiMC


class NamedTranscript:
    """In-circuit mirror of backend.transcript.MiMCTranscript — gnark's
    fiat-shamir schedule (≙ std/fiat-shamir/transcript.go:106-160): each
    challenge hashes its OWN bindings plus the previous challenge,
    challenge_i = MiMC(tag_i, value_{i-1}?, bindings_i...). Bit-identical
    to the host transcript, so recursion verifiers replay the inner
    prover's challenges natively."""

    def __init__(self, api, modulus: int, challenge_names: list):
        self.api = api
        self.q = modulus
        self._names = [n if isinstance(n, str) else n.decode()
                       for n in challenge_names]
        self._bindings = {n: [] for n in self._names}
        self._values: dict = {}
        self._next = 0

    def bind(self, name: str, values):
        if name not in self._names:
            raise ValueError(f"unknown challenge {name!r}")
        if name in self._values:
            raise ValueError(f"challenge {name!r} already computed")
        self._bindings[name].extend(values)

    def compute_challenge(self, name: str):
        if name in self._values:
            return self._values[name]
        pos = self._names.index(name)
        if pos != self._next:
            raise ValueError(f"challenge order violated at {name!r}")
        h = MiMC(self.api, self.q)
        tag = int.from_bytes(name.encode(), "big") % self.q
        h.write(tag)
        if pos > 0:
            h.write(self._values[self._names[pos - 1]])
        if self._bindings[name]:
            h.write(*self._bindings[name])
        c = h.sum()
        self._values[name] = c
        self._next = pos + 1
        return c


class CircuitTranscript:
    def __init__(self, api, modulus: int, challenge_names: list):
        self.api = api
        self.q = modulus
        self._names = list(challenge_names)
        self._bindings: list = []
        self._done: set = set()

    def bind(self, name: str, values):
        if name not in self._names:
            raise ValueError(f"unknown challenge {name!r}")
        if name in self._done:
            raise ValueError(f"challenge {name!r} already computed")
        self._bindings.extend(values)

    def compute_challenge(self, name: str):
        """Hash everything bound so far (+ a domain tag for the name)."""
        idx = self._names.index(name)
        for prev in self._names[:idx]:
            if prev not in self._done:
                raise ValueError(
                    f"challenge order violated: {prev!r} before {name!r}"
                )
        h = MiMC(self.api, self.q)
        tag = int.from_bytes(name.encode(), "big") % self.q
        h.write(tag, *self._bindings)
        c = h.sum()
        self._done.add(name)
        self._bindings.append(c)  # later challenges bind earlier ones
        return c


class EmulatedNamedTranscript:
    """NamedTranscript over an EMULATED field — the cross-curve replay of
    backend.transcript.MiMCTranscript (an outer circuit recomputing an
    inner prover's fs_hash="mimc" challenges when the inner Fr is not the
    outer native field; ≙ the reference's nonnative fiat-shamir transcript
    in std/recursion with sw_bls12381).

    Bindings may be emulated Elements of the inner field (absorbed
    directly), host ints (bound as constants), or NATIVE variables —
    e.g. 64-bit coordinate limbs — which are embedded via from_native
    (requires inner-fr ≥ native field, true for BLS12-381-in-BN254).
    Challenges come back as emulated Elements, bit-identical to the host
    transcript's values."""

    def __init__(self, fp, challenge_names: list):
        """fp: EmulatedField for the inner scalar field."""
        from .emulated import Element  # local: avoid import cycle

        self._el = Element
        self.fp = fp
        self._names = [n if isinstance(n, str) else n.decode()
                       for n in challenge_names]
        self._bindings = {n: [] for n in self._names}
        self._values: dict = {}
        self._next = 0

    def _embed(self, v):
        if isinstance(v, self._el):
            return v
        if isinstance(v, int):
            return self.fp.constant(v)
        return self.fp.from_native(v)

    def bind(self, name: str, values):
        if name not in self._names:
            raise ValueError(f"unknown challenge {name!r}")
        if name in self._values:
            raise ValueError(f"challenge {name!r} already computed")
        self._bindings[name].extend(self._embed(v) for v in values)

    def compute_challenge(self, name: str):
        from .hash.mimc import EmulatedMiMC

        if name in self._values:
            return self._values[name]
        pos = self._names.index(name)
        if pos != self._next:
            raise ValueError(f"challenge order violated at {name!r}")
        h = EmulatedMiMC(self.fp)
        tag = int.from_bytes(name.encode(), "big") % self.fp.p
        h.write(self.fp.constant(tag))
        if pos > 0:
            h.write(self._values[self._names[pos - 1]])
        if self._bindings[name]:
            h.write(*self._bindings[name])
        c = h.sum()
        self._values[name] = c
        self._next = pos + 1
        return c
