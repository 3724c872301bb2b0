"""The port's C ABI boundary layer (celo_bls_snark_tpu_torch/ffi/c_abi):
load libbls_snark_tpu_torch.so via ctypes and exercise the full extern "C"
surface — the counterpart of tests/test_c_abi.py against the port's
library, with the same struct layouts and misuse cases: the signature fns
(opaque handles, signatures.rs parity), the serialization fns and the
pinned epoch-SNARK verification through the port's snark/api.py. Then byte
equality of the port's ffi/api.py with the JAX package's on the same seeded
keys, messages and extra data: keys, signatures, the hash_* outputs,
aggregates and serializations, through the library and in Python."""

import ctypes
import os
import shutil
import subprocess

import pytest

from celo_bls_snark_tpu.ffi import api as japi
from celo_bls_snark_tpu.utils.rngs import XorShiftRng as JXorShiftRng
from celo_bls_snark_tpu_torch.ffi import api as tapi
from celo_bls_snark_tpu_torch.utils.rngs import XorShiftRng

HERE = os.path.dirname(__file__)
LIB_DIR = os.path.join(HERE, "..", "celo_bls_snark_tpu_torch", "ffi", "c_abi")
LIB_PATH = os.path.join(LIB_DIR, "libbls_snark_tpu_torch.so")

BOOL_FNS = [
    "init", "free_vec", "destroy_private_key", "destroy_public_key",
    "destroy_signature", "generate_private_key", "private_key_to_public_key",
    "sign_message", "sign_pop", "hash_direct", "hash_direct_with_attempt",
    "hash_composite", "hash_composite_cip22", "hash_crh",
    "hash_direct_first_step", "verify_signature", "verify_pop",
    "batch_verify_signature", "batch_verify_strict", "aggregate_public_keys",
    "aggregate_public_keys_subtract", "aggregate_signatures",
    "deserialize_private_key", "serialize_private_key",
    "deserialize_public_key", "deserialize_public_key_cached",
    "serialize_public_key", "serialize_public_key_uncompressed",
    "deserialize_signature", "serialize_signature",
    "serialize_signature_uncompressed", "compress_signature",
    "compress_pubkey",
]


class Buffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_char_p), ("len", ctypes.c_size_t)]


class MessageFFI(ctypes.Structure):
    _fields_ = [
        ("data", Buffer),
        ("extra", Buffer),
        ("public_key", ctypes.c_void_p),
        ("sig", ctypes.c_void_p),
    ]


class BatchMessageFFI(ctypes.Structure):
    _fields_ = [
        ("data", Buffer),
        ("extra", Buffer),
        ("public_keys", ctypes.POINTER(ctypes.c_void_p)),
        ("public_keys_len", ctypes.c_size_t),
        ("signatures", ctypes.POINTER(ctypes.c_void_p)),
        ("signatures_len", ctypes.c_size_t),
    ]


@pytest.fixture(scope="module")
def lib():
    missing = [t for t in ("make", "g++", "python3-config") if shutil.which(t) is None]
    if missing:
        pytest.skip(f"cannot build the C ABI library without {', '.join(missing)}")
    if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < \
            os.path.getmtime(os.path.join(LIB_DIR, "bls_snark.cpp")):
        r = subprocess.run(["make", "-C", LIB_DIR], capture_output=True, text=True)
        # the tools are there: a failed build is the port's fault, not a skip
        assert r.returncode == 0, f"make failed:\n{r.stderr[-2000:]}"
    l = ctypes.CDLL(LIB_PATH)
    for fn in BOOL_FNS:
        getattr(l, fn).restype = ctypes.c_bool
    assert l.init()
    return l


def _out_buf():
    return ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_int32()


def _take(lib, ptr, ln) -> bytes:
    data = bytes(bytearray(ptr[i] for i in range(ln.value)))
    lib.free_vec(ptr, ln)
    return data


def _handle():
    return ctypes.c_void_p()


def _keypair(lib):
    sk = _handle()
    assert lib.generate_private_key(ctypes.byref(sk))
    pk = _handle()
    assert lib.private_key_to_public_key(sk, ctypes.byref(pk))
    return sk, pk


def _sign(lib, sk, msg, extra=b"", composite=True, cip22=True):
    sig = _handle()
    assert lib.sign_message(
        sk, msg, len(msg), extra, len(extra), composite, cip22,
        ctypes.byref(sig),
    )
    return sig


def _buf(data: bytes) -> Buffer:
    return Buffer(data, len(data))


class TestKeysAndSignatures:
    def test_generate_sign_verify(self, lib):
        sk, pk = _keypair(lib)
        msg = b"hello from C"
        sig = _sign(lib, sk, msg)
        ok = ctypes.c_bool()
        assert lib.verify_signature(
            pk, msg, len(msg), b"", 0, sig, True, True, ctypes.byref(ok)
        )
        assert ok.value
        assert lib.verify_signature(
            pk, b"other", 5, b"", 0, sig, True, True, ctypes.byref(ok)
        )
        assert not ok.value
        # bad hasher combination (direct + cip22) errors
        assert not lib.verify_signature(
            pk, msg, len(msg), b"", 0, sig, False, True, ctypes.byref(ok)
        )
        for h in (sig, pk):
            lib.destroy_signature(h)
        lib.destroy_private_key(sk)

    def test_pop(self, lib):
        sk, pk = _keypair(lib)
        # PoP message is the compressed pubkey
        ptr, ln = _out_buf()
        assert lib.serialize_public_key(pk, ctypes.byref(ptr), ctypes.byref(ln))
        pk_bytes = _take(lib, ptr, ln)
        sig = _handle()
        assert lib.sign_pop(sk, pk_bytes, len(pk_bytes), ctypes.byref(sig))
        ok = ctypes.c_bool()
        assert lib.verify_pop(
            pk, pk_bytes, len(pk_bytes), sig, ctypes.byref(ok)
        )
        assert ok.value

    def test_aggregate_and_subtract(self, lib):
        sk1, pk1 = _keypair(lib)
        sk2, pk2 = _keypair(lib)
        pks = (ctypes.c_void_p * 2)(pk1, pk2)
        apk = _handle()
        assert lib.aggregate_public_keys(pks, 2, ctypes.byref(apk))
        sub_list = (ctypes.c_void_p * 1)(pk2)
        back = _handle()
        assert lib.aggregate_public_keys_subtract(
            apk, sub_list, 1, ctypes.byref(back)
        )
        ptr, ln = _out_buf()
        assert lib.serialize_public_key(back, ctypes.byref(ptr), ctypes.byref(ln))
        back_bytes = _take(lib, ptr, ln)
        ptr, ln = _out_buf()
        assert lib.serialize_public_key(pk1, ctypes.byref(ptr), ctypes.byref(ln))
        assert back_bytes == _take(lib, ptr, ln)

    def test_aggregate_signatures_verifies(self, lib):
        msg = b"same message"
        sk1, pk1 = _keypair(lib)
        sk2, pk2 = _keypair(lib)
        s1 = _sign(lib, sk1, msg)
        s2 = _sign(lib, sk2, msg)
        sigs = (ctypes.c_void_p * 2)(s1, s2)
        asig = _handle()
        assert lib.aggregate_signatures(sigs, 2, ctypes.byref(asig))
        pks = (ctypes.c_void_p * 2)(pk1, pk2)
        apk = _handle()
        assert lib.aggregate_public_keys(pks, 2, ctypes.byref(apk))
        ok = ctypes.c_bool()
        assert lib.verify_signature(
            apk, msg, len(msg), b"", 0, asig, True, True, ctypes.byref(ok)
        )
        assert ok.value


class TestHashes:
    def test_hash_direct_matches_python(self, lib):
        from celo_bls_snark_tpu_torch.ffi import api

        msg = b"hash me"
        ptr, ln = _out_buf()
        assert lib.hash_direct(msg, len(msg), ctypes.byref(ptr),
                               ctypes.byref(ln), False)
        assert _take(lib, ptr, ln) == api.hash_direct(msg, False)

        att = ctypes.c_int32()
        ptr, ln = _out_buf()
        assert lib.hash_direct_with_attempt(
            msg, len(msg), ctypes.byref(ptr), ctypes.byref(ln),
            ctypes.byref(att), True,
        )
        exp_bytes, exp_att = api.hash_direct_with_attempt(msg, True)
        assert _take(lib, ptr, ln) == exp_bytes
        assert att.value == exp_att

    def test_hash_composite_and_cip22(self, lib):
        from celo_bls_snark_tpu_torch.ffi import api

        msg, extra = b"composite msg", b"extra"
        ptr, ln = _out_buf()
        assert lib.hash_composite(msg, len(msg), extra, len(extra),
                                  ctypes.byref(ptr), ctypes.byref(ln))
        assert _take(lib, ptr, ln) == api.hash_composite(msg, extra)

        counter = ctypes.c_uint8()
        ptr, ln = _out_buf()
        assert lib.hash_composite_cip22(
            msg, len(msg), extra, len(extra), ctypes.byref(ptr),
            ctypes.byref(ln), ctypes.byref(counter),
        )
        exp_bytes, exp_c = api.hash_composite_cip22(msg, extra)
        assert _take(lib, ptr, ln) == exp_bytes
        assert counter.value == exp_c

    def test_hash_crh_and_first_step(self, lib):
        from celo_bls_snark_tpu_torch.ffi import api

        msg = b"crh input"
        ptr, ln = _out_buf()
        assert lib.hash_crh(msg, len(msg), 64, ctypes.byref(ptr),
                            ctypes.byref(ln))
        assert _take(lib, ptr, ln) == api.hash_crh(msg, 64)
        ptr, ln = _out_buf()
        assert lib.hash_direct_first_step(msg, len(msg), 64, ctypes.byref(ptr),
                                          ctypes.byref(ln))
        assert _take(lib, ptr, ln) == api.hash_direct_first_step(msg, 64)


class TestBatchVerify:
    def test_batch_verify_signature(self, lib):
        entries = []
        for i in range(3):
            sk, pk = _keypair(lib)
            msg = b"block %d" % i
            entries.append((msg, pk, _sign(lib, sk, msg)))
        msgs = (MessageFFI * 3)(*[
            MessageFFI(_buf(m), _buf(b""), pk, sig) for m, pk, sig in entries
        ])
        ok = ctypes.c_bool()
        assert lib.batch_verify_signature(msgs, 3, True, True,
                                          ctypes.byref(ok))
        assert ok.value
        # swapping signatures BETWEEN entries keeps the aggregate unchanged
        # -> screening still passes (reference semantics: one aggregate sig)
        msgs[0].sig, msgs[1].sig = msgs[1].sig, msgs[0].sig
        assert lib.batch_verify_signature(msgs, 3, True, True,
                                          ctypes.byref(ok))
        assert ok.value
        # tamper: replace one signature with one over a different message
        sk, _pk = _keypair(lib)
        msgs[2].sig = _sign(lib, sk, b"unrelated message")
        assert lib.batch_verify_signature(msgs, 3, True, True,
                                          ctypes.byref(ok))
        assert not ok.value

    def test_batch_verify_null_buffers(self, lib):
        """(NULL, 0) Buffers are legal in the reference's convention
        (utils.rs:8-24) and must behave as empty slices, not fail."""
        sk, pk = _keypair(lib)
        msg = b"null-extra block"
        sig = _sign(lib, sk, msg)
        entry = MessageFFI(_buf(msg), Buffer(None, 0), pk, sig)
        msgs = (MessageFFI * 1)(entry)
        ok = ctypes.c_bool()
        assert lib.batch_verify_signature(msgs, 1, True, True,
                                          ctypes.byref(ok))
        assert ok.value

    def test_batch_verify_strict(self, lib):
        msg = b"one message"
        sks_pks = [_keypair(lib) for _ in range(3)]
        sigs = [_sign(lib, sk, msg) for sk, _ in sks_pks]
        pks_arr = (ctypes.c_void_p * 3)(*[pk for _, pk in sks_pks])
        sigs_arr = (ctypes.c_void_p * 3)(*sigs)
        good = BatchMessageFFI(_buf(msg), _buf(b""), pks_arr, 3, sigs_arr, 3)
        # a second batch with a planted bad signature
        bad_sigs = (ctypes.c_void_p * 3)(sigs[1], sigs[0], sigs[2])
        bad = BatchMessageFFI(_buf(msg), _buf(b""), pks_arr, 3, bad_sigs, 3)
        batches = (BatchMessageFFI * 2)(good, bad)
        results = (ctypes.c_bool * 2)()
        # returns false because one batch failed, but per-batch results land
        assert not lib.batch_verify_strict(batches, 2, True, True, results)
        assert results[0] and not results[1]
        only_good = (BatchMessageFFI * 1)(good)
        res1 = (ctypes.c_bool * 1)()
        assert lib.batch_verify_strict(only_good, 1, True, True, res1)
        assert res1[0]


class TestSerialization:
    def test_roundtrips(self, lib):
        sk, pk = _keypair(lib)
        sig = _sign(lib, sk, b"ser msg")
        for obj, ser_fn, deser_fn, size in (
            (sk, "serialize_private_key", "deserialize_private_key", 32),
            (pk, "serialize_public_key", "deserialize_public_key", 96),
            (pk, "serialize_public_key", "deserialize_public_key_cached", 96),
            (sig, "serialize_signature", "deserialize_signature", 48),
        ):
            ptr, ln = _out_buf()
            assert getattr(lib, ser_fn)(obj, ctypes.byref(ptr), ctypes.byref(ln))
            blob = _take(lib, ptr, ln)
            assert len(blob) == size
            h = _handle()
            assert getattr(lib, deser_fn)(blob, len(blob), ctypes.byref(h))
            ptr, ln = _out_buf()
            assert getattr(lib, ser_fn)(h, ctypes.byref(ptr), ctypes.byref(ln))
            assert _take(lib, ptr, ln) == blob

    def test_uncompressed_and_compress(self, lib):
        sk, pk = _keypair(lib)
        sig = _sign(lib, sk, b"compress me")
        ptr, ln = _out_buf()
        assert lib.serialize_public_key_uncompressed(
            pk, ctypes.byref(ptr), ctypes.byref(ln)
        )
        pk_unc = _take(lib, ptr, ln)
        assert len(pk_unc) == 192
        ptr, ln = _out_buf()
        assert lib.compress_pubkey(pk_unc, len(pk_unc), ctypes.byref(ptr),
                                   ctypes.byref(ln))
        pk_comp = _take(lib, ptr, ln)
        ptr, ln = _out_buf()
        assert lib.serialize_public_key(pk, ctypes.byref(ptr), ctypes.byref(ln))
        assert pk_comp == _take(lib, ptr, ln)

        ptr, ln = _out_buf()
        assert lib.serialize_signature_uncompressed(
            sig, ctypes.byref(ptr), ctypes.byref(ln)
        )
        sig_unc = _take(lib, ptr, ln)
        assert len(sig_unc) == 96
        ptr, ln = _out_buf()
        assert lib.compress_signature(sig_unc, len(sig_unc), ctypes.byref(ptr),
                                      ctypes.byref(ln))
        sig_comp = _take(lib, ptr, ln)
        ptr, ln = _out_buf()
        assert lib.serialize_signature(sig, ctypes.byref(ptr), ctypes.byref(ln))
        assert sig_comp == _take(lib, ptr, ln)

    def test_misuse_short_slices_fail_cleanly(self, lib):
        h = _handle()
        assert not lib.deserialize_private_key(b"\x01\x02", 2, ctypes.byref(h))
        assert not lib.deserialize_public_key(b"\x00" * 5, 5, ctypes.byref(h))
        assert not lib.deserialize_signature(b"", 0, ctypes.byref(h))
        ptr, ln = _out_buf()
        assert not lib.compress_pubkey(b"\x00" * 3, 3, ctypes.byref(ptr),
                                       ctypes.byref(ln))
        assert not lib.compress_signature(b"\x00" * 3, 3, ctypes.byref(ptr),
                                          ctypes.byref(ln))


class TestSnark:
    def test_snark_verify_pinned(self, lib):
        import vectors_snark

        def grab(name):
            return bytes.fromhex(getattr(vectors_snark, name))

        class EpochBlockFFI(ctypes.Structure):
            _fields_ = [
                ("index", ctypes.c_uint16),
                ("round", ctypes.c_uint8),
                ("epoch_entropy", ctypes.c_char_p),
                ("parent_entropy", ctypes.c_char_p),
                ("maximum_non_signers", ctypes.c_uint32),
                ("pubkeys_num", ctypes.c_uint32),
                ("maximum_validators", ctypes.c_uint32),
                ("pubkeys", ctypes.c_char_p),
            ]

        vk = grab("ENTROPY_VK")
        proof = grab("ENTROPY_PROOF")
        first = EpochBlockFFI(
            0, 0, bytes.fromhex("01" * 16), bytes.fromhex("02" * 16),
            1, 4, 4, grab("ENTROPY_FIRST_PUBKEYS"),
        )
        last = EpochBlockFFI(
            2, 0, bytes.fromhex("03" * 16), bytes.fromhex("02" * 16),
            1, 4, 4, grab("ENTROPY_LAST_PUBKEYS"),
        )
        lib.verify.restype = ctypes.c_bool
        lib.verify.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
            EpochBlockFFI, EpochBlockFFI,
        ]
        assert lib.verify(vk, len(vk), proof, len(proof), first, last)
        # swapped epochs must fail
        assert not lib.verify(vk, len(vk), proof, len(proof), last, first)


class TestEncodeEpochBlock:
    """encode_epoch_block_to_bytes[_cip22] with the reference's unpacked
    argument ABI (snark/epoch_block.rs:17-105): pubkeys as handle arrays,
    entropy as 16-byte buffers or NULL, two output buffers for CIP22."""

    def _pk_handles(self, lib, n):
        handles = []
        for _ in range(n):
            sk, pk = _keypair(lib)
            lib.destroy_private_key(sk)
            handles.append(pk)
        arr = (ctypes.c_void_p * n)(*[h.value for h in handles])
        return handles, arr

    def _pk_objs(self, lib, handles):
        """Round-trip each handle through serialize to rebuild the host-side
        PublicKey oracle objects."""
        from celo_bls_snark_tpu_torch.ffi.api import deserialize_public_key

        objs = []
        for h in handles:
            ptr, ln = _out_buf()
            assert lib.serialize_public_key(h, ctypes.byref(ptr),
                                            ctypes.byref(ln))
            objs.append(deserialize_public_key(_take(lib, ptr, ln)))
        return objs

    def test_encode_cip22_matches_native(self, lib):
        from celo_bls_snark_tpu_torch.snark.epoch_block import EpochBlock

        handles, arr = self._pk_handles(lib, 3)
        ee = bytes(range(16))
        pe = bytes(range(16, 32))
        ptr, ln = _out_buf()
        eptr, eln = _out_buf()
        assert lib.encode_epoch_block_to_bytes_cip22(
            ctypes.c_uint16(7), ctypes.c_uint8(3), ee, pe,
            ctypes.c_uint32(1), ctypes.c_uint32(5), arr, 3,
            ctypes.byref(ptr), ctypes.byref(ln),
            ctypes.byref(eptr), ctypes.byref(eln),
        )
        inner = _take(lib, ptr, ln)
        extra = _take(lib, eptr, eln)
        block = EpochBlock(7, 3, ee, pe, 1, 5, self._pk_objs(lib, handles))
        exp_inner, exp_extra = block.encode_inner_to_bytes_cip22()
        assert inner == exp_inner
        assert extra == exp_extra
        for h in handles:
            lib.destroy_public_key(h)

    def test_encode_pre_cip22_matches_native(self, lib):
        from celo_bls_snark_tpu_torch.snark.epoch_block import EpochBlock

        handles, arr = self._pk_handles(lib, 2)
        ptr, ln = _out_buf()
        assert lib.encode_epoch_block_to_bytes(
            ctypes.c_uint16(9), ctypes.c_uint32(1), arr, 2,
            ctypes.byref(ptr), ctypes.byref(ln),
        )
        out = _take(lib, ptr, ln)
        block = EpochBlock(9, 0, None, None, 1, 2, self._pk_objs(lib, handles))
        assert out == block.encode_to_bytes()
        for h in handles:
            lib.destroy_public_key(h)


class TestBytesEqualJax:
    """The port's ffi/api.py and its library against the JAX package's
    ffi/api.py, byte for byte, on keys from one seeded rng."""

    SEED = b"c-abi-torch-test"
    MESSAGES = [(b"epoch 1", b""), (b"epoch 2", b"extra data")]
    MODES = [(True, True), (True, False), (False, False)]

    @pytest.fixture(scope="class")
    def sks(self):
        jr, tr = JXorShiftRng(self.SEED), XorShiftRng(self.SEED)
        jsk = [japi.generate_private_key(jr) for _ in range(2)]
        tsk = [tapi.generate_private_key(tr) for _ in range(2)]
        assert jsk == tsk
        return tsk

    def test_keys_signatures_and_aggregates(self, lib, sks):
        pks = [tapi.private_key_to_public_key(sk) for sk in sks]
        assert pks == [japi.private_key_to_public_key(sk) for sk in sks]
        for msg, extra in self.MESSAGES:
            for composite, cip22 in self.MODES:
                sigs = [tapi.sign_message(sk, msg, extra, composite, cip22) for sk in sks]
                assert sigs == [japi.sign_message(sk, msg, extra, composite, cip22)
                                for sk in sks]
        for sk, pk in zip(sks, pks):
            assert tapi.sign_pop(sk, pk) == japi.sign_pop(sk, pk)
        assert tapi.aggregate_public_keys(pks) == japi.aggregate_public_keys(pks)
        assert tapi.aggregate_signatures(sigs) == japi.aggregate_signatures(sigs)
        apk = tapi.aggregate_public_keys(pks)
        assert tapi.aggregate_public_keys_subtract(apk, pks[1:]) == \
            japi.aggregate_public_keys_subtract(apk, pks[1:]) == pks[0]
        # through the library: a handle from the seeded key signs the same bytes
        h = _handle()
        assert lib.deserialize_private_key(sks[0], len(sks[0]), ctypes.byref(h))
        msg, extra = self.MESSAGES[1]
        sig = _sign(lib, h, msg, extra)
        ptr, ln = _out_buf()
        assert lib.serialize_signature(sig, ctypes.byref(ptr), ctypes.byref(ln))
        assert _take(lib, ptr, ln) == japi.sign_message(sks[0], msg, extra, True, True)

    def test_hashes(self, lib):
        for msg, extra in self.MESSAGES:
            for use_pop in (False, True):
                assert tapi.hash_direct(msg, use_pop) == japi.hash_direct(msg, use_pop)
                assert tapi.hash_direct_with_attempt(msg, use_pop) == \
                    japi.hash_direct_with_attempt(msg, use_pop)
            assert tapi.hash_composite(msg, extra) == japi.hash_composite(msg, extra)
            assert tapi.hash_composite_cip22(msg, extra) == \
                japi.hash_composite_cip22(msg, extra)
            assert tapi.hash_crh(msg, 64) == japi.hash_crh(msg, 64)
            assert tapi.hash_direct_first_step(msg, 64) == \
                japi.hash_direct_first_step(msg, 64)
            ptr, ln = _out_buf()
            assert lib.hash_composite(msg, len(msg), extra, len(extra),
                                      ctypes.byref(ptr), ctypes.byref(ln))
            assert _take(lib, ptr, ln) == japi.hash_composite(msg, extra)

    def test_serializations_and_verdicts(self, sks):
        msg, extra = self.MESSAGES[0]
        pks = [tapi.private_key_to_public_key(sk) for sk in sks]
        sigs = [tapi.sign_message(sk, msg, extra, True, True) for sk in sks]
        for pk_b, sig_b in zip(pks, sigs):
            t_pk, j_pk = tapi.deserialize_public_key(pk_b), japi.deserialize_public_key(pk_b)
            t_sig, j_sig = tapi.deserialize_signature(sig_b), japi.deserialize_signature(sig_b)
            pk_unc = tapi.serialize_public_key_uncompressed(t_pk)
            sig_unc = tapi.serialize_signature_uncompressed(t_sig)
            assert pk_unc == japi.serialize_public_key_uncompressed(j_pk)
            assert sig_unc == japi.serialize_signature_uncompressed(j_sig)
            assert tapi.compress_pubkey(pk_unc) == japi.compress_pubkey(pk_unc) == pk_b
            assert tapi.compress_signature(sig_unc) == japi.compress_signature(sig_unc) == sig_b
            assert tapi.verify_signature(pk_b, msg, extra, sig_b, True, True) is \
                japi.verify_signature(pk_b, msg, extra, sig_b, True, True) is True
        entries = [(msg, extra, [pk], [sig]) for pk, sig in zip(pks, sigs)]
        assert tapi.batch_verify_signature(entries, True, True) is \
            japi.batch_verify_signature(entries, True, True) is True
        bad = [(msg, extra, list(zip(pks, sigs))), (msg, extra, list(zip(pks, sigs[::-1])))]
        assert tapi.batch_verify_strict(bad, True, True) == \
            japi.batch_verify_strict(bad, True, True) == [True, False]

    def test_pinned_proof_verifies_through_the_port(self):
        import vectors_snark
        from celo_bls_snark_tpu_torch.ffi.c_abi_support import make_epoch_block

        def grab(name):
            return bytes.fromhex(getattr(vectors_snark, name))

        first = make_epoch_block(0, 0, b"\x01" * 16, b"\x02" * 16, 1, 4,
                                 grab("ENTROPY_FIRST_PUBKEYS"))
        last = make_epoch_block(2, 0, b"\x03" * 16, b"\x02" * 16, 1, 4,
                                grab("ENTROPY_LAST_PUBKEYS"))
        vk, proof = grab("ENTROPY_VK"), grab("ENTROPY_PROOF")
        assert tapi.verify(vk, proof, first, last)
        assert not tapi.verify(vk, proof, last, first)
