"""The port's wire formats (gnark_icicle_tpu_torch/io/) held to the JAX
package's on the CPU.

The same objects, encoded by both packages, give the same bytes: points,
Groth16 proving keys, verifying keys and proofs, PLONK verifying keys and
proofs, witnesses (binary and JSON), the length-prefixed key and
constraint-system dumps, and gnark's ``.r1cs``/``.scs`` of one circuit
compiled by each package's frontend; on BN254, BLS12-381 (zcash flags) and
BLS12-377, compressed and not. The objects are made in the JAX package
(small multiples of its generators, from a numpy seed, with infinity among
them), and the JAX encoder's bytes decode in the port to the values of
``from_reference`` of them. The limits are the JAX package's: a BW6-761
proof (G2 over Fp) encodes in neither, and a compressed point decodes in
neither where p ≡ 1 (mod 4) (BLS12-377). ``cbor`` and ``intcomp`` take
tests/test_gnark_cs.py's vectors in both packages. ``dummy_setup`` gives
the JAX one's points. A served prove through these bytes is in
tests/test_torch_service.py.
"""

import dataclasses

import numpy as np
import pytest

from gnark_icicle_tpu import frontend as ref_frontend
from gnark_icicle_tpu.backend.groth16 import keys as ref_g16
from gnark_icicle_tpu.backend.groth16.setup import dummy_setup as ref_dummy_setup
from gnark_icicle_tpu.backend.pedersen import PedersenProvingKey, PedersenVerifyingKey
from gnark_icicle_tpu.backend.plonk import keys as ref_plonk
from gnark_icicle_tpu.io import cbor as ref_cbor
from gnark_icicle_tpu.io import gnark_cs as ref_gnark_cs
from gnark_icicle_tpu.io import intcomp as ref_intcomp
from gnark_icicle_tpu.io import keys as ref_keys
from gnark_icicle_tpu.io import plonk_serialize as ref_plonk_io
from gnark_icicle_tpu.io import serialize as ref_io
from gnark_icicle_tpu_torch import frontend
from gnark_icicle_tpu_torch import io as port_io_pkg
from gnark_icicle_tpu_torch.backend.groth16 import keys as g16
from gnark_icicle_tpu_torch.backend.groth16.setup import dummy_setup
from gnark_icicle_tpu_torch.backend.plonk import keys as plonk_keys
from gnark_icicle_tpu_torch.io import cbor, gnark_cs, intcomp, keys, plonk_serialize
from gnark_icicle_tpu_torch.io import serialize as io

from test_torch_common import CURVES, ref_curve

PKGS = {"jax": (ref_cbor, ref_intcomp), "port": (cbor, intcomp)}
CURVE_IDS = ("bn254", "bls12_381", "bls12_377")


def plain(v):
    """Keys, proofs and points of either package as plain data: dataclasses
    as dicts of their public fields, Fp2 coordinates as (c0, c1)."""
    if dataclasses.is_dataclass(v):
        return {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)
                if not f.name.startswith("_")}
    if hasattr(v, "c0"):
        return (v.c0, v.c1)
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    return v


# -- cbor and intcomp: tests/test_gnark_cs.py's vectors, in both packages ----

CBOR_VECTORS = [
    (0, "00"), (1, "01"), (10, "0a"), (23, "17"), (24, "1818"),
    (100, "1864"), (1000, "1903e8"), (1000000, "1a000f4240"),
    (-1, "20"), (-10, "29"), (-100, "3863"),
    (b"", "40"), (b"\x01\x02\x03\x04", "4401020304"),
    ("", "60"), ("a", "6161"), ("IETF", "6449455446"),
    ([], "80"), ([1, 2, 3], "83010203"),
    ([1, [2, 3], [4, 5]], "8301820203820405"),
    ({}, "a0"),
    ({"a": 1, "b": [2, 3]}, "a26161016162820203"),
    (False, "f4"), (True, "f5"), (None, "f6"),
    ("tag", "da00510528a0"),     # Tagged(5309736, {})
    ({"aa": 2, "z": 1}, "a2617a0162616102"),      # keys sorted by their bytes
    ({100: 1, 10: 2}, "a20a02186401"),
]


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("i", range(len(CBOR_VECTORS)))
def test_cbor_vectors(pkg, i):
    mod = PKGS[pkg][0]
    obj, hexpect = CBOR_VECTORS[i]
    if obj == "tag":
        obj = mod.Tagged(5309736, {})
    assert mod.encode(obj).hex() == hexpect
    back, off = mod.decode(bytes.fromhex(hexpect))
    assert off == len(hexpect) // 2
    if isinstance(obj, mod.Tagged):
        assert (back.tag, back.value) == (obj.tag, obj.value)
    else:
        assert back == obj


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_cbor_nested_roundtrip(pkg):
    mod = PKGS[pkg][0]
    obj = {"GnarkVersion": "0.11.0",
           "Blueprints": [mod.Tagged(5309735, {}), mod.Tagged(5309736, {})],
           "MDebug": {}, "Nested": [{"CID": 5, "VID": 7}, None, True],
           "Bytes": b"\x00\xff"}
    enc = mod.encode(obj)
    assert enc == ref_cbor.encode({**obj, "Blueprints": [ref_cbor.Tagged(5309735, {}),
                                                         ref_cbor.Tagged(5309736, {})]})
    back, off = mod.decode(enc)
    assert off == len(enc) and mod.encode(back) == enc


def _intcomp_cases():
    rng = np.random.default_rng(32)
    cases = {f"random{n}": [int(v) for v in rng.integers(0, 1 << 32, size=n)]
             for n in (0, 1, 2, 127, 128, 129, 255, 256, 1000)}
    cases.update({"sequential": list(range(500)), "decreasing": list(range(500, 0, -1)),
                  "constant": [7] * 300, "extremes": [0, 0xFFFFFFFF] * 64,
                  "top": [0xFFFFFFFF] * 130, "powers": [1 << i for i in range(32)] * 4})
    return cases


INTCOMP = _intcomp_cases()


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(INTCOMP))
def test_intcomp_u32_streams(pkg, case):
    """Each case round-trips in both packages, varint and bit-packed, with
    the JAX package's words and framed bytes."""
    mod = PKGS[pkg][1]
    vals = INTCOMP[case]
    for bitpack in (False, True):
        words = mod.compress_u32(vals, bitpack=bitpack)
        assert words == ref_intcomp.compress_u32(vals, bitpack=bitpack)
        assert mod.uncompress_u32(words) == vals
    buf = bytearray()
    mod.write_u32_stream(buf, vals)
    mod.write_u64_stream(buf, [v << 31 for v in vals[:65]])
    ref = bytearray()
    ref_intcomp.write_u32_stream(ref, vals)
    ref_intcomp.write_u64_stream(ref, [v << 31 for v in vals[:65]])
    assert buf == ref
    got, off = mod.read_u32_stream(bytes(buf), 0)
    got64, off = mod.read_u64_stream(bytes(buf), off)
    assert (got, got64, off) == (vals, [v << 31 for v in vals[:65]], len(buf))


def test_intcomp_rejects_malformed():
    words = intcomp.compress_u32(list(range(200)), bitpack=True)
    for width in (33, (words[2] + 1) % 33):
        bad = list(words)
        bad[2] = width
        with pytest.raises(ValueError):
            intcomp.uncompress_u32(bad)


def test_calldata_uvarints_match_the_scalar_loops():
    """The port's one-pass uvarints (gnark_cs._uvarints, _read_uvarints) give
    the JAX package's per-value loops' bytes and 32-bit values, offset and
    errors: 1-10 byte values, 2^32 and 2^35 edges, a truncated and an
    overlong one."""
    rng = np.random.default_rng(5)
    vals = [0, 1, 127, 128, 16383, 16384, 2**32 - 1, 2**32, 2**35 - 1, 2**35, 2**63,
            2**64 - 1] + [int(v) >> int(s) for v, s in zip(
                rng.integers(0, 1 << 63, size=2000, dtype=np.uint64), rng.integers(0, 63, 2000))]
    ref = bytearray()
    for v in vals:
        ref_gnark_cs._uvarint(ref, v)
    assert gnark_cs._uvarints(vals) == bytes(ref)
    buf = b"\x07" + bytes(ref) + b"\x05"
    off, want = 1, []
    for _ in vals:
        v, off = ref_gnark_cs._read_uvarint(buf, off)
        want.append(v & 0xFFFFFFFF)
    assert gnark_cs._read_uvarints(buf, 1, len(vals)) == (want, off)
    for bad in (b"\x80\x80", b"\x80" * 10 + b"\x01"):
        for read in (lambda: gnark_cs._read_uvarints(bad, 0, 1),
                     lambda: ref_gnark_cs._read_uvarint(bad, 0)):
            with pytest.raises(ValueError):
                read()


# -- points, keys, proofs and witnesses ---------------------------------------

def ref_objects(name: str) -> dict:
    """A Groth16 proving key, verifying key and proof and a PLONK verifying
    key and proof of the JAX package's classes on one curve, over four G1
    and three G2 points (multiples of the generators by 62-bit scalars from
    a numpy seed) and infinity."""
    c = ref_curve(name)
    rng = np.random.default_rng(7)
    ks = [int(k) for k in rng.integers(2, 1 << 62, size=7)]
    a, b, d, e = (c.g1.scalar_mul(c.g1.generator, k) for k in ks[:4])
    u, v, w = (c.g2.scalar_mul(c.g2.generator, k) for k in ks[4:])
    fr = [int(x) % c.fr.modulus for x in rng.integers(0, 1 << 63, size=8)] + [c.fr.modulus - 1]
    pk = ref_g16.ProvingKey(
        g1_alpha=a, g1_beta=b, g1_delta=d, g2_beta=u, g2_delta=v,
        g1_a=[a, None, e], g1_b=[b, d, None], g2_b=[w, None, u], g1_k=[e, a],
        g1_z=[b, d, e, None], domain_log_n=2,
        commitment_keys=[PedersenProvingKey(basis=[a, d], basis_exp_sigma=[e, None])])
    vk = ref_g16.VerifyingKey(
        g1_alpha=a, g2_beta=u, g2_gamma=v, g2_delta=w, g1_k=[b, d, e], nb_public=2,
        commitment_keys=[PedersenVerifyingKey(g=u, g_sigma_neg=w)],
        public_and_commitment_committed=[[1, 3]])
    proof = ref_g16.Proof(ar=a, krs=b, bs=w, commitments=[e], commitment_pok=d)
    names = ("ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3", "qcp0")
    plonk_vk = ref_plonk.VerifyingKey(
        commitments={n: (a, b, d, e, None)[i % 5] for i, n in enumerate(names)},
        log_n=5, k1=fr[0], k2=fr[1], nb_public=1, g2_gen=u, g2_tau=v, omega=fr[2],
        commitment_constraint_indexes=[3])
    plonk_proof = ref_plonk.Proof(
        lro=(a, b, None), z_com=d, h_coms=(e, a, b), batch_h=d, batch_claimed=fr[3:],
        z_shifted_h=e, z_shifted_claimed=fr[0], bsb22_commitments=[a])
    return {"pk": pk, "vk": vk, "proof": proof, "plonk_vk": plonk_vk, "plonk_proof": plonk_proof}


# name -> (the JAX encoder, its decoder, the port's encoder, its decoder, the
# port's class); the proving key's decoders return the key alone
CODECS = {
    "pk": (ref_keys.pk_to_bytes, lambda c, b: (ref_keys.pk_from_bytes(c, b), None),
           keys.pk_to_bytes, lambda c, b: (keys.pk_from_bytes(c, b), None), g16.ProvingKey),
    "vk": (ref_io.vk_to_bytes, ref_io.vk_from_bytes, io.vk_to_bytes, io.vk_from_bytes,
           g16.VerifyingKey),
    "proof": (ref_io.proof_to_bytes, ref_io.proof_from_bytes, io.proof_to_bytes,
              io.proof_from_bytes, g16.Proof),
    "plonk_vk": (ref_plonk_io.plonk_vk_to_bytes, ref_plonk_io.plonk_vk_from_bytes,
                 plonk_serialize.plonk_vk_to_bytes, plonk_serialize.plonk_vk_from_bytes,
                 plonk_keys.VerifyingKey),
    "plonk_proof": (ref_plonk_io.plonk_proof_to_bytes, ref_plonk_io.plonk_proof_from_bytes,
                    plonk_serialize.plonk_proof_to_bytes, plonk_serialize.plonk_proof_from_bytes,
                    plonk_keys.Proof),
}


@pytest.fixture(scope="module")
def objects():
    return {name: ref_objects(name) for name in CURVE_IDS}


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "compressed"])
@pytest.mark.parametrize("kind", sorted(CODECS))
@pytest.mark.parametrize("name", CURVE_IDS)
def test_objects_encode_alike_and_decode_to_from_reference(objects, name, kind, compressed):
    ref_enc, ref_dec, enc, dec, cls = CODECS[kind]
    ref_obj = objects[name][kind]
    port_obj = cls.from_reference(ref_obj)
    curve, rc = CURVES[name], ref_curve(name)
    data = ref_enc(rc, ref_obj, compressed)
    assert enc(curve, port_obj, compressed) == data
    if compressed and name == "bls12_377":   # p ≡ 1 (mod 4): no square root in either
        for decode, c in ((dec, curve), (ref_dec, rc)):
            with pytest.raises(AssertionError):
                decode(c, data)
        return
    got, off = dec(curve, data)
    assert off in (None, len(data))
    assert isinstance(got, cls)
    assert plain(got) == plain(port_obj) == plain(ref_obj) == plain(ref_dec(rc, data)[0])


@pytest.mark.parametrize("name", CURVE_IDS)
def test_points_and_witnesses(objects, name):
    """Single points with their offsets, a flipped coordinate bit refused,
    and witnesses in binary and JSON form, against the JAX package."""
    curve, rc = CURVES[name], ref_curve(name)
    vk = objects[name]["vk"]
    for pt, to_b, from_b, ref_to in ((vk.g1_alpha, io.g1_to_bytes, io.g1_from_bytes,
                                      ref_io.g1_to_bytes),
                                     (vk.g2_beta, io.g2_to_bytes, io.g2_from_bytes,
                                      ref_io.g2_to_bytes), (None, io.g1_to_bytes,
                                                            io.g1_from_bytes, ref_io.g1_to_bytes)):
        data = to_b(curve, pt, False)
        assert data == ref_to(rc, pt, False)
        got, n = from_b(curve, b"\x00" + data, 1)
        assert n == len(data) and plain(got) == plain(pt)
        if pt is not None:
            bad = bytearray(data)
            bad[-1] ^= 1
            with pytest.raises(ValueError):
                from_b(curve, bytes(bad))
    q = curve.fr.modulus
    pub, sec = [5, q - 1], [0, 1, 1 << 200]
    data = io.witness_to_bytes(curve, pub, sec)
    assert data == ref_io.witness_to_bytes(rc, pub, sec)
    assert io.witness_from_bytes(curve, data) == (pub, [v % q for v in sec])
    cs = frontend.compile_circuit(q, Cubic)
    text = io.witness_to_json(cs, [35], [3])
    assert text == ref_io.witness_to_json(ref_frontend.compile_circuit(q, ref_cubic()), [35], [3])
    assert io.witness_from_json(text) == ([35], [3])


def test_bw6_761_proof_raises_in_both_packages():
    """The proof encoding covers G2 over Fp2 only, in both packages."""
    c = CURVES["bw6_761"]
    proof = g16.Proof(ar=c.g1.generator, krs=c.g1.generator, bs=c.g2.generator)
    for enc, curve in ((io.proof_to_bytes, c), (ref_io.proof_to_bytes, ref_curve("bw6_761"))):
        with pytest.raises(AttributeError):
            enc(curve, proof)


def test_io_exports_the_jax_packages_names():
    import gnark_icicle_tpu.io as ref_io_pkg

    assert port_io_pkg.__all__ == ref_io_pkg.__all__


# -- constraint systems --------------------------------------------------------

class Cubic(frontend.Circuit):
    x = frontend.Secret()
    y = frontend.Public()

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(self.y, api.add(x3, self.x, 5))


def circuit(fe, name: str):
    """The circuits of the constraint-system cases over one frontend: the
    Cubic, one with hints (a bit decomposition and an inverse), and one with
    a BSB22 commitment."""
    class Hints(fe.Circuit):
        x = fe.Secret()
        low = fe.Public()

        def define(self, api):
            bits = api.to_binary(self.x, 16)
            acc = api.mul(api.div(1, self.x), 0)
            for i in range(8):
                acc = api.add(acc, api.mul(bits[i], 1 << i))
            api.assert_is_equal(acc, self.low)

    class Commit(fe.Circuit):
        x = fe.Secret()
        y = fe.Public()

        def define(self, api):
            x2 = api.mul(self.x, self.x)
            api.assert_is_different(api.commit(self.x, x2), 0)
            api.assert_is_equal(api.add(api.mul(x2, self.x), self.x, 5), self.y)

    return {"hints": Hints, "commit": Commit}[name]


def ref_cubic():
    class RefCubic(ref_frontend.Circuit):
        x = ref_frontend.Secret()
        y = ref_frontend.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))

    return RefCubic


def _compile_both(name, curve, builder):
    q = CURVES[curve].fr.modulus
    if name == "cubic":
        return (frontend.compile_circuit(q, Cubic, builder=builder),
                ref_frontend.compile_circuit(q, ref_cubic(), builder=builder))
    return (frontend.compile_circuit(q, circuit(frontend, name), builder=builder),
            ref_frontend.compile_circuit(q, circuit(ref_frontend, name), builder=builder))


CS_FIELDS = {"r1cs": ("nb_public", "nb_secret", "nb_internal", "term_wire", "l_off", "r_off",
                      "o_off", "solved_wire", "instructions"),
             "scs": ("nb_public", "nb_secret", "nb_internal", "xa", "xb", "xc", "ql", "qr",
                     "qm", "qo", "qc", "solved_wire", "instructions", "commitment_tags")}


@pytest.mark.parametrize("builder", ["r1cs", "scs"])
@pytest.mark.parametrize("name", ["cubic", "hints", "commit"])
@pytest.mark.parametrize("curve", CURVE_IDS)
def test_constraint_system_bytes(curve, name, builder):
    """gnark's .r1cs/.scs and the length-prefixed dump of one circuit
    compiled by each package's frontend: the same bytes; decode → encode
    gives the bytes back; the decoded system has the original's columns
    (its coefficient ids may differ, their values may not), commitments
    and hint ids, as the JAX reader's has."""
    cs, ref_cs = _compile_both(name, curve, builder)
    write, read, ref_write, ref_read, dump, load, ref_dump = {
        "r1cs": (gnark_cs.write_r1cs, gnark_cs.read_r1cs, ref_gnark_cs.write_r1cs,
                 ref_gnark_cs.read_r1cs, keys.r1cs_to_bytes, keys.r1cs_from_bytes,
                 ref_keys.r1cs_to_bytes),
        "scs": (gnark_cs.write_scs, gnark_cs.read_scs, ref_gnark_cs.write_scs,
                ref_gnark_cs.read_scs, keys.scs_to_bytes, keys.scs_from_bytes,
                ref_keys.scs_to_bytes)}[builder]
    blob = write(cs)
    assert blob == ref_write(ref_cs)
    assert gnark_cs.encode(gnark_cs.decode(blob)) == blob
    back, ref_back = read(blob), ref_read(blob)
    for f in CS_FIELDS[builder]:
        assert getattr(back, f) == getattr(ref_back, f) == getattr(cs, f), f
    if builder == "r1cs":
        assert ([back.coeffs[c] for c in back.term_coeff]
                == [cs.coeffs[c] for c in cs.term_coeff])
    assert plain(back.commitments) == plain(cs.commitments)
    assert [h.hint_id for h in back.hints] == [h.hint_id for h in cs.hints]
    data = dump(cs)
    assert data == ref_dump(ref_cs)
    loaded = load(data)
    for f in CS_FIELDS[builder] + ("coeffs",) * (builder == "r1cs"):
        assert getattr(loaded, f) == getattr(cs, f), f
    assert plain(loaded.commitments) == plain(cs.commitments)


@pytest.mark.parametrize("name", ["cubic", "commit"])
@pytest.mark.parametrize("curve", CURVE_IDS)
def test_dummy_setup_matches_the_jax_package(curve, name):
    cs, ref_cs = _compile_both(name, curve, "r1cs")
    pk = dummy_setup(cs, CURVES[curve])
    assert plain(pk) == plain(ref_dummy_setup(ref_cs, ref_curve(curve)))
    assert len(pk.g1_z) == 1 << pk.domain_log_n
