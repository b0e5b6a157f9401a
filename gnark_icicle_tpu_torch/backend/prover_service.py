"""Resident prover service: pay a process's one-time costs once, then prove
at the marginal latency.

Port of gnark_icicle_tpu/backend/prover_service.py (``Groth16Prover`` :25,
``PlonkProver`` :62) over the port's ``groth16.prove`` and ``plonk.prove``.
On the card the one-time costs of a process are the kernels' build
(``ops/cuda.py``), the device context (``device.py``, one per curve and
device), the proving key's staged point tables (cached on the key), the
domain and quotient tables (``ops/ntt.py``, ``backend/plonk/prove.py``) and
the solver's schedule (cached on the constraint system). A prover holds
(cs, pk, curve, device) for its lifetime, so that all of them are paid by
its first prove (``warmup``) and every later ``prove`` runs warm. Keep one
prover process alive per (circuit, key) pair rather than one per proof.

The device is resolved once, at construction: the first CUDA card unless the
caller passes another (``device="cpu"`` runs the plain PyTorch versions);
without a card and without ``device`` the constructor raises. Only the
device engine is ported: ``engine="host"`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import time

from ..device import DeviceCtx
from . import groth16, plonk


class _Prover:
    """What both provers share: the bound objects, the resolved device and
    the warm-up prove."""

    def __init__(self, cs, pk, curve, engine: str = "device", device=None):
        if engine != "device":
            raise NotImplementedError(
                "only engine='device' is ported; the host engine is "
                "gnark_icicle_tpu's")
        self.cs = cs
        self.pk = pk
        self.curve = curve
        self.engine = engine
        self.device = DeviceCtx(curve, device).device

    def warmup(self, public_values, secret_values, rng=None) -> float:
        """One throwaway prove that pays every one-time cost (see the module
        docstring). Returns its seconds, the first-proof latency. Optional:
        without it the first ``prove`` pays the same."""
        t0 = time.perf_counter()
        self.prove(public_values, secret_values, rng=rng)
        return time.perf_counter() - t0


class Groth16Prover(_Prover):
    """Long-lived Groth16 prover bound to one (cs, pk, curve, device)
    (≙ groth16.Prove with WithIcicleAcceleration called repeatedly in a
    resident service, icicle.go:145-150)."""

    def prove(self, public_values, secret_values, rng=None,
              checkpoint_dir=None, commitment_hash="sha256"):
        return groth16.prove(self.cs, self.pk, public_values, secret_values, self.curve,
                             rng=rng, engine=self.engine, checkpoint_dir=checkpoint_dir,
                             commitment_hash=commitment_hash, device=self.device)


class PlonkProver(_Prover):
    """Long-lived PLONK prover bound to one (cs, pk, curve, device), with the
    same amortization as Groth16Prover."""

    def prove(self, public_values, secret_values, rng=None,
              checkpoint_dir=None, fs_hash: str = "sha256"):
        return plonk.prove(self.cs, self.pk, public_values, secret_values, self.curve,
                           rng=rng, engine=self.engine, checkpoint_dir=checkpoint_dir,
                           fs_hash=fs_hash, device=self.device)
