"""In-circuit polynomial evaluation (univariate, multilinear, LDE).

Role parity: reference std/math/polynomial (polynomial.go —
EvalUnivariate Horner (:94), EvalMultilinear via partial folds (:106,158),
InterpolateLDE barycentric over 0..n−1 (:216), EvalEqual (:231)). The
reference is generic over emulated fields for recursion; here both a native
variant (plain api values) and an emulated variant (std.emulated Elements)
are provided — the native one is what sumcheck/GKR over the proving field
uses, the emulated one what cross-curve recursion uses.

Copied from gnark_icicle_tpu/std/polynomial.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations


class Polynomial:
    """Native-field polynomial evaluator over circuit variables."""

    def __init__(self, api):
        self.api = api

    def eval_univariate(self, coeffs, at):
        """Σ coeffs[i]·atⁱ by Horner (≙ EvalUnivariate)."""
        api = self.api
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = api.add(api.mul(acc, at), c)
        return acc

    def eval_multilinear(self, at, values):
        """Multilinear extension of `values` (length 2^k) evaluated at the
        point `at` (length k), folding one variable per pass
        (≙ EvalMultilinear/partialMultilinearEval)."""
        api = self.api
        assert len(values) == 1 << len(at)
        vals = list(values)
        # fold from the FIRST variable: M(x0..xk) = (1−x0)·M0 + x0·M1
        for x in at:
            half = len(vals) // 2
            vals = [
                api.add(vals[i], api.mul(x, api.sub(vals[half + i], vals[i])))
                for i in range(half)
            ]
        return vals[0]

    def interpolate_lde(self, at, values):
        """Evaluate the unique degree-(n−1) polynomial through
        (i, values[i]) for i = 0..n−1 at `at` (≙ InterpolateLDE /
        computeDeltaAtNaive). Division-free product form — total, including
        at in-domain points (δ collapses to the indicator there).
        """
        api = self.api
        n = len(values)
        q = api.q
        # δ_i(at) = w_i · Π_{j≠i}(at − j), w_i = 1/Π_{j≠i}(i − j) constant
        diffs = [api.sub(at, i) for i in range(n)]
        prefix = [1] * n  # Π_{j<i} diffs[j]
        for i in range(1, n):
            prefix[i] = api.mul(prefix[i - 1], diffs[i - 1])
        suffix = [1] * n  # Π_{j>i} diffs[j]
        for i in range(n - 2, -1, -1):
            suffix[i] = api.mul(suffix[i + 1], diffs[i + 1])
        acc = None
        for i in range(n):
            w = 1
            for j in range(n):
                if j != i:
                    w = w * ((i - j) % q) % q
            w_inv = pow(w, -1, q)
            delta = api.mul(prefix[i], suffix[i], w_inv)
            term = api.mul(values[i], delta)
            acc = term if acc is None else api.add(acc, term)
        return acc

    def eval_equal(self, xs, ys):
        """eq(x, y) = Π (xᵢyᵢ + (1−xᵢ)(1−yᵢ)) (≙ EvalEqual)."""
        api = self.api
        acc = 1
        for x, y in zip(xs, ys):
            term = api.add(
                api.mul(x, y), api.mul(api.sub(1, x), api.sub(1, y))
            )
            acc = api.mul(acc, term)
        return acc


class EmulatedPolynomial:
    """Same operations over non-native field elements
    (≙ polynomial.Polynomial[FR] with emulated arithmetic)."""

    def __init__(self, field):
        self.f = field  # std.emulated.EmulatedField

    def eval_univariate(self, coeffs, at):
        f = self.f
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = f.add(f.mul(acc, at), c)
        return acc

    def eval_multilinear(self, at, values):
        f = self.f
        assert len(values) == 1 << len(at)
        vals = list(values)
        for x in at:
            half = len(vals) // 2
            vals = [
                f.add(vals[i], f.mul(x, f.sub(vals[half + i], vals[i])))
                for i in range(half)
            ]
        return vals[0]
