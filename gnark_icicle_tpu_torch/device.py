"""Device context: one curve's fields, domains, group laws and MSMs on one
torch device.

Port of gnark_icicle_tpu/device.py ``DeviceCtx`` (:47) for the curves whose
kernels are built: BN254, BLS12-381, BLS12-377 and BW6-761. G2 lies over Fp2
for the first three and over Fp itself for BW6-761 (embedding degree 6: the
sextic twist is defined over the base field), as in the reference (:69-78).
The context takes a ``torch.device``
(default: the first CUDA card; there is no fallback to the CPU, which a
caller asks for with ``"cpu"``); proving-key points are staged once per key
(``backend/groth16/keys.py``) as Montgomery-form row tables. The uint16
tunnel staging of the reference (``_mont_chunked`` :22-44) is gone: it
existed for a remote TPU's transfer bandwidth.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves.tower import Fp2
from .ops.cuda import default_device, resolve_device  # noqa: F401
from .ops.ec_t import TCurve, TCurve2
from .ops.field import field_for, ints_to_limbs32, to_lanes
from .ops.field_t import TField
from .ops.msm import MSMKernel
from .ops.ntt import Domain, domain_for


# the curves whose kernels are built
CURVES = ("bn254", "bls12-381", "bls12-377", "bw6-761")


class DeviceCtx:
    """Device-side kernels and conversions for one host curve on one device
    (None: the first CUDA card).

    One context per (curve name, resolved device) in a process, as the
    reference keeps one per curve (gnark_icicle_tpu/device.py:50-55,
    :111-113): every prove, setup and KZG of a curve on a device, and so a
    resident prover, builds it once. A construction that raises leaves no
    entry."""

    _cache: dict = {}

    def __new__(cls, curve, device=None):
        ctx = cls._cache.get((curve.name, resolve_device(device)))
        return ctx if ctx is not None else super().__new__(cls)

    def __init__(self, curve, device=None):
        if getattr(self, "_initialized", False):
            return
        if curve.name not in CURVES:
            raise NotImplementedError(
                f"the port's kernels cover {', '.join(CURVES)}, not {curve.name}")
        self.curve = curve
        self.device = resolve_device(device)
        self.fp = field_for(curve.fp.modulus)
        self.fr = field_for(curve.fr.modulus)
        p = curve.fp.modulus
        self.g1 = TCurve(self.fp, 3 * curve.g1.b % p)
        # G2 over Fp2 (its b has c0/c1) or, for BW6-761, over Fp
        self.g2_fp2 = hasattr(curve.g2.b, "c0")
        self.g2 = (TCurve2(self.fp, curve.tower.beta, curve.g2.b * 3)
                   if self.g2_fp2 else TCurve(self.fp, 3 * curve.g2.b % p))
        bits = curve.fr.modulus.bit_length()
        self.msm_g1 = MSMKernel(self.g1, bits)
        self.msm_g2 = MSMKernel(self.g2, bits)
        self._initialized = True
        DeviceCtx._cache[(curve.name, self.device)] = self

    def domain(self, log_n: int, coset: bool = False) -> Domain:
        """The Fr domain of 2^log_n on this device (ops/ntt.py caches it
        across contexts, so a prove builds no table that an earlier one did)."""
        return domain_for(self.fr, self.curve.fr, log_n, self.device, coset=coset)

    def sync(self) -> None:
        """Wait for the device (phase timings)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host <-> device conversions ----------------------------------------
    def fr_scalars(self, limbs_u32: np.ndarray) -> torch.Tensor:
        """(N, Wr) uint32 plain-form limbs -> (Wr, N) device scalars."""
        return to_lanes(limbs_u32, self.device)

    def fr_plain(self, values) -> torch.Tensor:
        """Host ints -> (Wr, N) plain-form device scalars."""
        q = self.curve.fr.modulus
        return self.fr_scalars(ints_to_limbs32([int(v) % q for v in values], self.fr.n32))

    def fr_mont(self, values) -> torch.Tensor:
        """Host ints -> (Wr, N) Montgomery form on the device (≙
        gnark_icicle_tpu/device.py:130 fr_mont): the plain words are copied
        over and multiplied by R² there (one ``fr_mont_mul``), with no host
        modular product per value."""
        return TField(self.fr).to_mont(self.fr_plain(values))

    def _points(self, tc, points_host, filler):
        """Host affine points (None = infinity) -> (row table, inf mask).
        Infinity rows hold a filler and are masked to the MSM's trash bucket."""
        inf = torch.tensor([p is None for p in points_host], dtype=torch.bool,
                           device=self.device)
        filled = [p if p is not None else filler for p in points_host]
        return tc.table(filled, self.device), inf

    def g1_points(self, points_host):
        return self._points(self.g1, points_host, (0, 1))

    def g2_points(self, points_host):
        if not self.g2_fp2:  # BW6-761: G2 coordinates live in Fp
            return self._points(self.g2, points_host, (0, 1))
        tp = self.curve.tower
        return self._points(self.g2, points_host, (Fp2.zero(tp), Fp2.one(tp)))

    def g1_to_host(self, P):
        """(3, W, 1) projective -> host affine / None."""
        return self.g1.to_affine_host(P)[0]

    def g2_to_host(self, P):
        res = self.g2.to_affine_host(P)[0]
        if res is None or not self.g2_fp2:
            return res
        tp = self.curve.tower
        return (Fp2(tp, *res[0]), Fp2(tp, *res[1]))
