"""Number-theoretic transform over the scalar field, in 1-3 passes a transform.

Port of gnark_icicle_tpu/ops/ntt.py (``bitrev_indices`` :34, ``_pow_table``
:45, ``Domain`` :58 with its cache :66-73, ``domain_for`` :377): the
transforms computeH uses — ``intt_nat_to_rev`` (:317), ``coset_ntt_rev_in``
(:351) and ``coset_intt_nat_to_rev`` (:371) —, PLONK's 4n coset forms
``coset_ntt_nat`` (:360) and ``coset_intt_nat`` (:366), plus ``ntt`` and
``intt``. Data is one ``(W, n)`` Montgomery tensor (``ops/field.py``); the
reference's ``(n, 2W)`` arrays act along axis -2, these along the last axis.
The reference's leading batch axes (:150-152, :216-246) are a ``(W, G·n)``
tensor of G transforms, each n consecutive elements, through ``ntt``,
``intt``, their ``*_nat_to_rev`` forms and ``bit_reverse`` (the sharded
NTT's sub-transforms, ``parallel/ntt.py``): stage s < log n reads columns
2^s .. 2^(s+1) − 1 of the stage-major table, which hold ω_{2^(s+1)}^j
whatever the data's width, so a batch is the same passes over G times the
tiles, reading the n-wide table of one transform (``ntt_pass``'s ``tw_ld``).

A transform of 2^k is the reference's radix-2 stages (its per-stage K1
products, ops/ntt.py:204 ``_butterflies_t``) cut into the passes of
:func:`pass_split`, each one launch of ``csrc/fr.cu`` ``ntt_pass`` of the
domain's scalar field (BN254, BLS12-381, BLS12-377 or BW6-761 r): up to 11
stages on a tile in shared memory. The scalings ride the passes — the coset
powers the first pass's load, 1/n and g⁻ⁱ·n⁻¹ the last pass's store, and
computeH's pointwise ``(a·b − c)·den`` the first load of its coset INTT —
so a transform is 1-3 launches and no elementwise pass of its own. The
first pass writes a new tensor: transforms never consume their argument.
Domains are cached, as the reference's are, by (modulus, log_n, coset,
device), and each builds its tables once: the stage-major twiddles (the
2^s twiddles of stage s consecutive, at columns 2^s..2^(s+1) − 1) and, on a
coset, the coset powers in natural and bit-reversed order and g⁻ⁱ·n⁻¹ in
bit-reversed order. The MXU twiddle path and ``FourStepNTT`` are TPU
devices and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda import is_cuda, require, stream
from .field import Field, to16, to32
from .field_t import TField, check_lanes, fr_kernels

# A pass's tile: at most 2^11 elements in shared memory (64 KB at 8 words,
# 96 KB at 12), fewer below 2^18 elements, so that a transform has 128 tiles
# for the 132 SMs, but at least 2^9 (three passes reach 2^21); at least 2^3
# consecutive columns (32-byte runs of each limb) in the passes that gather
# strided rows. Up to 2^10 elements a transform is one pass.
LOG_TILE = 11
MIN_LOG_TILE = 9
TILES_LOG = 7
ONE_PASS_LOG = 10
LOG_COLS = 3


class NttPass(NamedTuple):
    """Stages s_lo .. s_lo + c − 1 of a transform on tiles of G = 2^log_g
    groups × 2^c rows × T = 2^log_t columns (csrc/field.cuh "the NTT pass")."""
    s_lo: int
    c: int
    log_t: int
    log_g: int


def split_stages(log_n: int, log_tile: int, log_cols: int) -> list:
    """The passes of a transform of 2^log_n on tiles of 2^log_tile elements,
    from the lowest stages up. One pass when the array fits a tile; else the
    passes above the lowest take log_tile − log_cols stages each, with
    2^log_cols columns, and the lowest takes the rest (at most log_tile
    stages, on contiguous chunks of 2^c, as many as fill a tile)."""
    if log_n <= log_tile:
        return [NttPass(0, log_n, 0, 0)]
    up = log_tile - log_cols
    n_up = -(-(log_n - log_tile) // up)
    low = log_n - n_up * up
    return [NttPass(0, low, 0, log_tile - low)] + [
        NttPass(low + i * up, up, log_cols, 0) for i in range(n_up)]


def pass_split(log_n: int) -> list:
    """The passes of a transform of 2^log_n (:func:`split_stages`), for 8-
    and 12-word elements alike: one up to 2^10; on tiles of 2^(log_n − 7)
    between 2^9 and 2^11, two at 2^11-2^15 and 2^17-2^19, three at 2^16
    and 2^20-2^27."""
    if log_n <= ONE_PASS_LOG:
        return split_stages(log_n, log_n, LOG_COLS)
    log_tile = min(LOG_TILE, max(log_n - TILES_LOG, MIN_LOG_TILE))
    return split_stages(log_n, log_tile, LOG_COLS)


def bitrev_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation indices for size n = 2^k."""
    k = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for _ in range(k):
        out = (out << 1) | (idx & 1)
        idx >>= 1
    return out


def stage_major_indices(n: int) -> np.ndarray:
    """Where each twiddle of the stage-major table lies in the natural
    (W, n/2) table: column 2^s + j of stage s (half-width 2^s) holds
    ω^(j·n/2^(s+1)), natural column j·n/2^(s+1); column 0 holds ω^0."""
    idx = np.zeros(max(n, 1), dtype=np.int64)
    for s in range(n.bit_length() - 1):
        idx[1 << s:2 << s] = np.arange(1 << s) * (n >> (s + 1))
    return idx


def ntt_stage_plain(F: Field, x: torch.Tensor, m: int, stride: int,
                    tw: torch.Tensor, dif: bool) -> None:
    """One radix-2 DIF or DIT stage of half-width m, in place on (W, n) x:
    butterfly j of each 2m-group uses tw[:, j * stride]. The inner step of
    :func:`ntt_pass_plain`."""
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


def ntt_pass_plain(F: Field, x: torch.Tensor, tws: torch.Tensor, p: NttPass, dif: bool,
                   mul=None, sub=None, scale=None, post=None, out=None) -> torch.Tensor:
    """The plain version of :func:`ntt_pass`: the load's scalings, the
    pass's stages one :func:`ntt_stage_plain` each (stage s reads its
    twiddles at columns 2^s.. of the stage-major table), the store's."""
    v = x.clone()
    if mul is not None:
        v = F.mont_mul(v, mul)
    if sub is not None:
        v = F.sub(v, sub)
    if scale is not None:
        v = F.mont_mul(v, scale)
    stages = range(p.s_lo, p.s_lo + p.c)
    for s in (reversed(stages) if dif else stages):
        m = 1 << s
        ntt_stage_plain(F, v, m, 1, tws[:, m:2 * m], dif)
    if post is not None:
        v = F.mont_mul(v, post)
    if out is None:
        return v
    out.copy_(v)
    return out


def ntt_pass(F: Field, x: torch.Tensor, tws: torch.Tensor, p: NttPass, dif: bool,
             mul=None, sub=None, scale=None, post=None, out=None) -> torch.Tensor:
    """One pass of a transform over (W, n) x: each element loaded as
    ((x·mul − sub)·scale), stages p.s_lo .. p.s_lo + p.c − 1 (DIF from the
    highest down, DIT from the lowest up), stored times post, into out (a
    new tensor where out is None; out may be x). mul and sub are (W, n),
    scale and post (W, n) or one (W, 1) column; each may be None. tws is the
    (W, m) stage-major twiddle table (:func:`stage_major_indices`) of a
    transform of m: m = n, or a power of two m | n with 2^(p.s_lo + p.c) ≤ m
    for a pass over a batch of n / m transforms of m consecutive elements."""
    ops = (mul, sub, scale, post, out)
    if not is_cuda(x, tws, *ops):
        return ntt_pass_plain(F, x, tws, p, dif, mul, sub, scale, post, out)
    n, m = x.shape[1], tws.shape[1]
    check_lanes(F.n32, x, tws, *[t for t in ops if t is not None])
    require(all(t is None or t.shape[1] == n for t in (mul, sub, out))
            and all(t is None or t.shape[1] in (1, n) for t in (scale, post)),
            "ntt_pass takes (W, n) operands, and scale and post may be (W, 1)")
    require(m & (m - 1) == 0 and n % m == 0 and m >= 1 << (p.s_lo + p.c),
            "the twiddle table is not one of a transform of the pass's stages dividing n")
    require(p.log_t <= p.s_lo and (n >> (p.log_g + p.c + p.log_t)) << (p.log_g + p.c + p.log_t) == n,
            "the pass's tile does not divide the data")
    if out is None:
        out = torch.empty_like(x)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def ld(t):
        return 0 if t is None else t.shape[1]

    fr_kernels(F.modulus)["ntt_pass"].launch(
        x.data_ptr(), out.data_ptr(), tws.data_ptr(), m, ptr(mul), ptr(sub), ptr(scale), ld(scale),
        ptr(post), ld(post), n, p.s_lo, p.c, p.log_t, p.log_g, int(dif), stream(x))
    return out


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

    The stage-major twiddle tables are built on first use, once; the coset
    tables (for the coset generator ``coset_gen``) with the domain."""

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
        self._revs = {self.n: self._rev}    # data width -> per-block bit reversal
        self.coset_gen = coset_gen
        if coset_gen is not None:
            g = F.const(coset_gen, self.device)
            gi = F.const(pow(coset_gen, -1, q), self.device)
            self.coset_pows = _pow_table(self.tf, g, self.n)
            self.coset_inv_pows = _pow_table(self.tf, gi, self.n)
            self._coset_pows_rev = self.bit_reverse(self.coset_pows)
            # g^-i · n^-1 in bit-reversed order: one product a row on the
            # last store of the coset INTTs (the same value as the
            # reference's two products, each canonical)
            self._coset_unscale_rev = self.tf.mont_mul(
                self.bit_reverse(self.coset_inv_pows), self.n_inv)

    def _twiddles(self, key: str) -> torch.Tensor:
        """The (W, n) stage-major table of ω ("f") or ω⁻¹ ("i")."""
        if key not in self._tw:
            q = self.F.modulus
            w = self.omega if key == "f" else pow(self.omega, -1, q)
            natural = _pow_table(self.tf, self.F.const(w, self.device), max(self.n // 2, 1))
            idx = torch.from_numpy(stage_major_indices(self.n)).to(self.device)
            self._tw[key] = natural.index_select(1, idx)
        return self._tw[key]

    @property
    def tw_fwd(self) -> torch.Tensor:
        """ω^j, j < n/2: the top stage's half of the stage-major table."""
        return self._twiddles("f")[:, self.n // 2:]

    @property
    def tw_inv(self) -> torch.Tensor:
        return self._twiddles("i")[:, self.n // 2:]

    def _transform(self, x: torch.Tensor, key: str, dif: bool, mul=None, sub=None,
                   scale=None, post=None) -> torch.Tensor:
        """The passes of pass_split in order (DIF from the highest stages
        down: natural in, bit-reversed out; DIT from the lowest up), the
        load's scalings on the first and post on the last. x is (W, G·n):
        G transforms of n consecutive elements; mul, sub, scale and post
        are (W, 1) columns or as wide as x."""
        if x.shape[1] % self.n:
            raise ValueError(f"a batch of transforms of 2^{self.log_n} takes a multiple of "
                             f"{self.n} columns, not {x.shape[1]}")
        passes = pass_split(self.log_n)
        if dif:
            passes = passes[::-1]
        tws = self._twiddles(key)
        y = None
        for i, p in enumerate(passes):
            last = i == len(passes) - 1
            if i == 0:
                y = ntt_pass(self.F, x, tws, p, dif, mul, sub, scale,
                             post if last else None)
            else:
                y = ntt_pass(self.F, y, tws, p, dif, post=post if last else None, out=y)
        return y

    # -- public transforms ---------------------------------------------------
    def ntt_nat_to_rev(self, coeffs):
        """coefficients (natural) -> evaluations (bit-reversed)."""
        return self._transform(coeffs, "f", True)

    def intt_nat_to_rev(self, evals):
        """evaluations (natural) -> coefficients (bit-reversed), incl. 1/N."""
        return self._transform(evals, "i", True, post=self.n_inv)

    def bit_reverse(self, x):
        """Each block of n columns in bit-reversed order (one index_select)."""
        width = x.shape[1]
        if width not in self._revs:
            if width % self.n:
                raise ValueError(f"{width} columns are no batch of 2^{self.log_n}")
            base = torch.arange(0, width, self.n, device=self.device)
            self._revs[width] = (base[:, None] + self._rev[None, :]).reshape(-1)
        return x.index_select(1, self._revs[width])

    def ntt(self, coeffs):
        """natural -> natural forward transform."""
        return self.bit_reverse(self.ntt_nat_to_rev(coeffs))

    def intt(self, evals):
        """natural -> natural inverse transform."""
        return self.bit_reverse(self.intt_nat_to_rev(evals))

    def coset_ntt_rev_in(self, coeffs_rev):
        """bit-reversed coefficients -> natural evals on the coset g·<omega>."""
        return self._transform(coeffs_rev, "f", False, mul=self._coset_pows_rev)

    def coset_ntt_nat(self, coeffs):
        """natural coefficients -> natural evals on the coset g·<omega>."""
        return self.bit_reverse(self._transform(coeffs, "f", True, mul=self.coset_pows))

    def coset_intt_nat(self, evals):
        """natural coset evals -> natural coefficients (incl. 1/N, g^-i)."""
        return self.bit_reverse(self._transform(evals, "i", True,
                                                post=self._coset_unscale_rev))

    def coset_intt_nat_to_rev(self, evals):
        """natural coset evals -> bit-reversed coefficients (incl. 1/N, g^-i)."""
        return self._transform(evals, "i", True, post=self._coset_unscale_rev)

    def coset_intt_nat_to_rev_pointwise(self, a, b, c, d):
        """``coset_intt_nat_to_rev((a·b − c)·d)`` with the pointwise on the
        first pass's load: a, b, c natural coset evals (W, n), d one (W, 1)
        Montgomery column (computeH's 1/Z on the coset)."""
        return self._transform(a, "i", True, mul=b, sub=c, scale=d,
                               post=self._coset_unscale_rev)


_DOMAINS: dict = {}


def domain_for(F: Field, prime_field, log_n: int, device,
               coset: bool = False) -> Domain:
    """The Domain of a curves.PrimeField parameter object on a device, one
    per (modulus, log_n, coset, device), whoever asks (the reference's
    ``Domain._cache``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (F.modulus, log_n, coset, device)
    if key not in _DOMAINS:
        root = prime_field.root_of_unity(log_n)
        gen = prime_field.multiplicative_generator if coset else None
        _DOMAINS[key] = Domain(F, log_n, root, gen, device)
    return _DOMAINS[key]
