"""Number-theoretic transform over the scalar field, one kernel per stage.

Port of gnark_icicle_tpu/ops/ntt.py (``bitrev_indices`` :34, ``_pow_table``
:45, ``Domain`` :58, ``domain_for`` :377): the transforms computeH uses —
``intt_nat_to_rev`` (:317), ``coset_ntt_rev_in`` (:351) and
``coset_intt_nat_to_rev`` (:371) —, PLONK's 4n coset forms
``coset_ntt_nat`` (:360) and ``coset_intt_nat`` (:366), plus ``ntt`` and
``intt``. Data is one
``(W, n)`` Montgomery tensor (``ops/field.py``); the reference's
``(n, 2W)`` arrays act along axis -2, these along the last axis.

Each radix-2 stage is one launch of ``csrc/fr.cu`` ``ntt_stage`` (the
butterfly add/sub with the twiddle product inline, replacing the
reference's per-stage K1 products, ops/ntt.py:204 ``_butterflies_t``) of
the domain's scalar field (BN254, BLS12-381, BLS12-377 or BW6-761 r), in
place on a copy of the input: unlike the reference, transforms never consume
their argument. The
MXU twiddle path and ``FourStepNTT`` are TPU devices and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda import Kernel, is_cuda, require, stream
from .field import Field, to16, to32
from .field_t import FR_KERNELS, TField, check_lanes

# scalar-field modulus -> its ntt_stage entry
NTT_STAGE = {q: Kernel("fr", ks["fr_mont_mul"].curve, "ntt_stage",
                       "gnark_icicle_tpu/ops/field_t.py:353")
             for q, ks in FR_KERNELS.items()}


def bitrev_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation indices for size n = 2^k."""
    k = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for _ in range(k):
        out = (out << 1) | (idx & 1)
        idx >>= 1
    return out


def ntt_stage_plain(F: Field, x: torch.Tensor, m: int, stride: int,
                    tw: torch.Tensor, dif: bool) -> None:
    """The plain version of ``ntt_stage``: the same stage in place on x."""
    W, K = F.n32, F.n16
    v = x.view(W, -1, 2, m)
    g = v.shape[1]
    w = to16(tw[:, ::stride][:, :m].contiguous())                 # (K, m)
    w = w[:, None, :].expand(K, g, m).reshape(K, -1)
    a = to16(v[:, :, 0, :].reshape(W, -1))
    b = to16(v[:, :, 1, :].reshape(W, -1))
    if dif:
        lo, hi = F.add16(a, b), F.mont_mul16(F.sub16(a, b), w)
    else:
        bw = F.mont_mul16(b, w)
        lo, hi = F.add16(a, bw), F.sub16(a, bw)
    v[:, :, 0, :] = to32(lo).view(W, g, m)
    v[:, :, 1, :] = to32(hi).view(W, g, m)


def ntt_stage(F: Field, x: torch.Tensor, m: int, stride: int,
              tw: torch.Tensor, dif: bool) -> None:
    """One radix-2 DIF or DIT stage of half-width m, in place on (W, n) x.

    Butterfly j of each 2m-group uses tw[:, j * stride] of the (W, n/2)
    twiddle table."""
    if not is_cuda(x, tw):
        return ntt_stage_plain(F, x, m, stride, tw, dif)
    if F.modulus not in NTT_STAGE:
        raise NotImplementedError(
            f"no ntt_stage kernel is built for the modulus {F.modulus:#x}")
    check_lanes(F.n32, x, tw)
    n = x.shape[1]
    require(n % (2 * m) == 0 and (m - 1) * stride < tw.shape[1],
            "stage width does not match the data or the twiddle table")
    NTT_STAGE[F.modulus].launch(x.data_ptr(), n, m, stride, tw.data_ptr(),
                                tw.shape[1], int(dif), stream(x))


def _pow_table(tf: TField, base_mont: torch.Tensor, n: int) -> torch.Tensor:
    """[base^0, ..., base^(n-1)] in Montgomery form as (W, n), log-depth."""
    F = tf.F
    table = F.const(1, base_mont.device)
    cur = base_mont
    while table.shape[1] < n:
        table = torch.cat([table, tf.mont_mul(table, cur)], dim=1)
        cur = tf.mont_mul(cur, cur)
    return table[:, :n].contiguous()


class Domain:
    """Evaluation domain of size 2^log_n over Fr on one device.

    Twiddle tables are built lazily on the device; the coset tables (for
    the coset generator ``coset_gen``) are built with the domain."""

    def __init__(self, F: Field, log_n: int, two_adic_root: int,
                 coset_gen: int | None, device):
        self.F = F
        self.tf = TField(F)
        self.device = torch.device(device)
        self.log_n = log_n
        self.n = 1 << log_n
        q = F.modulus
        self.omega = two_adic_root
        assert pow(two_adic_root, self.n, q) == 1
        if self.n > 1:
            assert pow(two_adic_root, self.n // 2, q) == q - 1
        self._tw: dict = {}
        self.n_inv = F.const(pow(self.n, -1, q), self.device)
        self._rev = torch.from_numpy(bitrev_indices(self.n)).to(self.device)
        self.coset_gen = coset_gen
        if coset_gen is not None:
            g = F.const(coset_gen, self.device)
            gi = F.const(pow(coset_gen, -1, q), self.device)
            self.coset_pows = _pow_table(self.tf, g, self.n)
            self.coset_inv_pows = _pow_table(self.tf, gi, self.n)
            self._coset_pows_rev = self.bit_reverse(self.coset_pows)
            self._coset_inv_pows_rev = self.bit_reverse(self.coset_inv_pows)

    def _table(self, key: str) -> torch.Tensor:
        if key not in self._tw:
            q = self.F.modulus
            w = self.omega if key == "f" else pow(self.omega, -1, q)
            self._tw[key] = _pow_table(self.tf, self.F.const(w, self.device),
                                       max(self.n // 2, 1))
        return self._tw[key]

    @property
    def tw_fwd(self) -> torch.Tensor:
        return self._table("f")

    @property
    def tw_inv(self) -> torch.Tensor:
        return self._table("i")

    # -- stage loops ---------------------------------------------------------
    def _dif(self, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
        """Natural-order input -> bit-reversed output, on a copy of x."""
        x = x.clone()
        for s in range(self.log_n - 1, -1, -1):
            m = 1 << s
            ntt_stage(self.F, x, m, self.n // (2 * m), tw, dif=True)
        return x

    def _dit(self, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
        """Bit-reversed input -> natural-order output, on a copy of x."""
        x = x.clone()
        for s in range(self.log_n):
            m = 1 << s
            ntt_stage(self.F, x, m, self.n // (2 * m), tw, dif=False)
        return x

    # -- public transforms ---------------------------------------------------
    def ntt_nat_to_rev(self, coeffs):
        """coefficients (natural) -> evaluations (bit-reversed)."""
        return self._dif(coeffs, self.tw_fwd)

    def intt_nat_to_rev(self, evals):
        """evaluations (natural) -> coefficients (bit-reversed), incl. 1/N."""
        return self.tf.mont_mul(self._dif(evals, self.tw_inv), self.n_inv)

    def bit_reverse(self, x):
        return x.index_select(1, self._rev)

    def ntt(self, coeffs):
        """natural -> natural forward transform."""
        return self.bit_reverse(self.ntt_nat_to_rev(coeffs))

    def intt(self, evals):
        """natural -> natural inverse transform."""
        return self.bit_reverse(self.intt_nat_to_rev(evals))

    def coset_ntt_rev_in(self, coeffs_rev):
        """bit-reversed coefficients -> natural evals on the coset g·<omega>."""
        return self._dit(self.tf.mont_mul(coeffs_rev, self._coset_pows_rev),
                         self.tw_fwd)

    def coset_ntt_nat(self, coeffs):
        """natural coefficients -> natural evals on the coset g·<omega>."""
        return self.bit_reverse(self._dif(self.tf.mont_mul(coeffs, self.coset_pows),
                                          self.tw_fwd))

    def coset_intt_nat(self, evals):
        """natural coset evals -> natural coefficients (incl. 1/N, g^-i)."""
        x = self.tf.mont_mul(self.bit_reverse(self._dif(evals, self.tw_inv)),
                             self.coset_inv_pows)
        return self.tf.mont_mul(x, self.n_inv)

    def coset_intt_nat_to_rev(self, evals):
        """natural coset evals -> bit-reversed coefficients (incl. 1/N, g^-i)."""
        x = self.tf.mont_mul(self._dif(evals, self.tw_inv),
                             self._coset_inv_pows_rev)
        return self.tf.mont_mul(x, self.n_inv)


def domain_for(F: Field, prime_field, log_n: int, device,
               coset: bool = False) -> Domain:
    """Build a Domain from a curves.PrimeField parameter object."""
    root = prime_field.root_of_unity(log_n)
    gen = prime_field.multiplicative_generator if coset else None
    return Domain(F, log_n, root, gen, device)
