"""Batched fixed-base scalar multiplication on the card (Groth16 setup, the SRS).

Port of gnark_icicle_tpu/ops/fixed_base.py (``FixedBaseMul`` :23,
``batch_normalize`` :95, ``batch_scalar_mul_host`` :118). The reference
runs a ``lax.scan`` of masked mixed adds over the host ladder 2^i·G, one
step per scalar bit; on a TPU each step is the fused tile of K6
(gnark_icicle_tpu/ops/ec_pallas.py:440 ``PallasEC._build``, reached through
ops/ec.py:217-227 for batches of 2048 or more), and the affine conversion
is ``batch_normalize`` (a Fermat inversion per lane) or, on the way to the
host, ``DevCurve.to_affine_host``.

Here the product is a fixed-base comb: a table of d·2^(w·j)·G for every
window j < ⌈bits / w⌉ and digit d < 2^w, built on the host once per (curve,
group, base, bits, w, device) and kept (``comb_table``), and one launch of
the group's ``fixed_base`` kernel, each lane adding the rows of its
scalar's nonzero w-bit digits; then one ``normalize`` launch turns the
projective points into affine plain words (Montgomery's trick), so the host
only decodes limbs to ints. The affine points are the reference's: None
for a zero scalar.
"""

from __future__ import annotations

import time

import torch

from .ec_t import _TCurveBase
from .field import ints_to_limbs32, to_lanes

# The comb's window width. gnark_icicle_tpu_torch/fixed_base_ab.py timed w =
# 4, 5 and 6 on an H100 at each path's batch widths (PERF.md §6): w = 6
# takes the kernel 30-40 % less time than w = 4 on every curve and group,
# but its table, built on the host, costs more than that gains (2709 rows
# against 960), so a setup in a fresh process, which builds each table once
# and runs one batch on it, is fastest at w = 4 for every (curve, group).
WINDOW = 4

# (modulus, b3 words, NP, base, bits, w, device) -> the table on that device
_TABLES: dict = {}


def _batch_affine(group, jac: list) -> list:
    """Jacobian (X, Y, Z), Z ≠ 0, -> affine (X/Z², Y/Z³), one field
    inversion for all of them (Montgomery's trick)."""
    f = group.f
    prefix = [f.one()]
    for X, Y, Z in jac:
        prefix.append(f.mul(prefix[-1], Z))
    inv = f.inv(prefix[-1])
    out = [None] * len(jac)
    for i in range(len(jac) - 1, -1, -1):
        X, Y, Z = jac[i]
        zi = f.mul(inv, prefix[i])
        inv = f.mul(inv, Z)
        zi2 = f.mul(zi, zi)
        out[i] = (f.mul(X, zi2), f.mul(Y, f.mul(zi2, zi)))
    return out


def comb_table(tc: _TCurveBase, host_group, base, bits: int, w: int, device) -> torch.Tensor:
    """Row j·(2^w − 1) + d − 1 = d·2^(w·j)·base (affine, Montgomery rows of
    ``tc.table``) for j < ⌈bits / w⌉ and 1 ≤ d < 2^w, built once per (curve,
    group, base, bits, w, device) and kept. The base has prime order r, which
    divides no d·2^(w·j), so no row is the identity. Host work: per window
    2^w − 2 Jacobian mixed adds and w doublings, and one inversion for all
    rows."""
    device = torch.device(device)
    key = (tc.F.modulus, tuple(tc._b3_words), tc.NP, repr(base), bits, w, device)
    if key not in _TABLES:
        f = host_group.f
        jac = []
        b = base
        for _ in range(-(-bits // w)):
            run = (b[0], b[1], f.one())
            jac.append(run)
            for _ in range(2, 1 << w):
                run = host_group._jadd_affine(run, b)
                jac.append(run)
            top = jac[-1]                                # (2^w − 1)·b
            b = host_group._to_affine(host_group._jadd_affine(top, b))  # 2^w·b
        _TABLES[key] = tc.table(_batch_affine(host_group, jac), device)
    return _TABLES[key]


class FixedBaseMul:
    """scalars × one base point, batched over the scalars: the comb of
    ``tc``'s group with the window ``w``."""

    def __init__(self, tc: _TCurveBase, host_group, base, scalar_bits: int, device,
                 w: int = WINDOW):
        self.tc = tc
        self.bits = scalar_bits
        self.w = w
        self.table = comb_table(tc, host_group, base, scalar_bits, w, device)

    def mul(self, scalars: torch.Tensor) -> torch.Tensor:
        """(Wr, N) plain 32-bit limbs -> (planes, W, N) projective products."""
        return self.tc.fixed_base(scalars, self.table, self.w, self.bits)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def batch_scalar_mul_host(tc: _TCurveBase, host_group, base, scalars,
                          scalar_bits: int, device, chunk: int = 1 << 20,
                          times: dict | None = None):
    """Host ints -> host affine points (None for a zero scalar).

    Each chunk of at most ``chunk`` scalars is one ``fixed_base`` and one
    ``normalize`` launch; 2^20 takes the Chain's 656,677 G1 scalars at
    once: device memory for them is about 21 MB of scalars, 168 MB of the
    comb's row scratch, 63 MB of projective points and 44 MB of affine
    words and flags at BN254 (8-word Fp and Fr, w = 4). ``times``, where given, gains the seconds of each part:
    "table" (the comb table, on the host, once per base), "encode" (ints to
    limbs on the card), "comb", "normalize" and "decode" (limbs to host
    ints); the device parts end in a synchronize."""
    t = {"table": 0.0, "encode": 0.0, "comb": 0.0, "normalize": 0.0, "decode": 0.0}
    t0 = time.perf_counter()

    def lap(part):
        nonlocal t0
        now = time.perf_counter()
        t[part] += now - t0
        t0 = now

    fb = FixedBaseMul(tc, host_group, base, scalar_bits, device)
    lap("table")
    out = []
    n_words = -(-scalar_bits // 32)
    for lo in range(0, len(scalars), chunk):
        part = to_lanes(ints_to_limbs32([int(s) for s in scalars[lo:lo + chunk]], n_words),
                        device)
        lap("encode")
        P = fb.mul(part)
        _sync(device)
        lap("comb")
        xy, inf = tc.normalize(P)
        _sync(device)
        lap("normalize")
        out.extend(tc.affine_host(xy, inf))
        lap("decode")
    if times is not None:
        for k, v in t.items():
            times[k] = times.get(k, 0.0) + v
    return out
