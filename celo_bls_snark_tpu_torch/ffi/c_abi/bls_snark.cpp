// C ABI boundary layer for celo_bls_snark_tpu_torch.
//
// Native equivalent of crates/bls-snark-sys (which compiles Rust to a C
// staticlib for the Celo blockchain client): the same extern "C" surface —
// opaque key/signature HANDLES (the reference passes *const PrivateKey /
// PublicKey / Signature, signatures.rs:19-90,244-505), byte-buffer outputs
// with explicit destructors, bool returns (convert_result_to_bool) —
// implemented in C++ over the embedded CPython runtime hosting the PyTorch
// framework. Function names, argument orders, struct layouts (MessageFFI /
// BatchMessageFFI / Buffer — utils.rs:8-97; EpochBlockFFI —
// snark/epoch_block.rs:109-127) and buffer conventions mirror the
// reference so a client linking against its ABI can relink unchanged.
//
// Build: see Makefile in this directory (produces libbls_snark_tpu_torch.so).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <mutex>

namespace {

std::once_flag g_init_flag;
PyObject *g_api = nullptr;  // celo_bls_snark_tpu_torch.ffi.api module
bool g_owns_interpreter = false;

void ensure_python() {
  std::call_once(g_init_flag, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      g_owns_interpreter = true;
    }
  });
}

// RAII GIL holder usable from foreign threads.
class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject *api() {
  if (g_api == nullptr) {
    g_api = PyImport_ImportModule("celo_bls_snark_tpu_torch.ffi.api");
    if (g_api == nullptr) {
      PyErr_Print();
    }
  }
  return g_api;
}

// convert_result_to_bool equivalent: clear the Python error and return false
bool fail() {
  if (PyErr_Occurred()) PyErr_Print();
  PyErr_Clear();
  return false;
}

// Copy `bytes` out into a malloc'd buffer handed to the caller
// (freed via free_vec, mirroring the leaked-Vec convention).
bool emit_bytes(PyObject *bytes, uint8_t **out, int32_t *out_len) {
  if (bytes == nullptr || !PyBytes_Check(bytes)) return false;
  Py_ssize_t n = PyBytes_GET_SIZE(bytes);
  auto *buf = static_cast<uint8_t *>(std::malloc(n ? n : 1));
  std::memcpy(buf, PyBytes_AS_STRING(bytes), n);
  *out = buf;
  *out_len = static_cast<int32_t>(n);
  return true;
}

PyObject *call(const char *fn, PyObject *args) {
  PyObject *mod = api();
  if (mod == nullptr) return nullptr;
  PyObject *f = PyObject_GetAttrString(mod, fn);
  if (f == nullptr) return nullptr;
  PyObject *res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  return res;
}

// NULL-tolerant byte pointer: (NULL, 0) buffers (legal in the reference's
// Buffer convention, utils.rs:8-24) must become b"" not None — Py_BuildValue
// "y#" maps a NULL pointer to None regardless of length.
const uint8_t *nn(const uint8_t *p) {
  static const uint8_t empty = 0;
  return p ? p : &empty;
}

// Opaque handles are PyObject* (PrivateKey / PublicKey / Signature).
PyObject *handle(const void *h) {
  return const_cast<PyObject *>(static_cast<const PyObject *>(h));
}

// [handles] -> new PyList (INCREFs each element).
PyObject *handle_list(const void *const *hs, Py_ssize_t n) {
  PyObject *list = PyList_New(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *o = handle(hs[i]);
    Py_INCREF(o);
    PyList_SET_ITEM(list, i, o);
  }
  return list;
}

// call returning an object handle
bool obj_out(const char *fn, PyObject *args, void **out) {
  PyObject *res = call(fn, args);
  Py_XDECREF(args);
  if (res == nullptr) return fail();
  *out = res;  // ownership to caller (destroy_* decrefs)
  return true;
}

// call returning bytes
bool bytes_out(const char *fn, PyObject *args, uint8_t **out,
               int32_t *out_len) {
  PyObject *res = call(fn, args);
  Py_XDECREF(args);
  if (res == nullptr) return fail();
  bool ok = emit_bytes(res, out, out_len);
  Py_DECREF(res);
  return ok;
}

}  // namespace

extern "C" {

// -------------------------------------------------------------------------
// FFI structs (utils.rs:8-97)
// -------------------------------------------------------------------------

struct Buffer {
  const uint8_t *ptr;
  uintptr_t len;
};

struct MessageFFI {
  Buffer data;
  Buffer extra;
  const void *public_key;  // PublicKey handle
  const void *sig;         // Signature handle
};

struct BatchMessageFFI {
  Buffer data;
  Buffer extra;
  const void *const *public_keys;
  uintptr_t public_keys_len;
  const void *const *signatures;
  uintptr_t signatures_len;
};

// -------------------------------------------------------------------------
// lifecycle (lib.rs:29-34) + destructors (serialization.rs:220-266)
// -------------------------------------------------------------------------

bool init() {
  ensure_python();
  Gil gil;
  PyObject *res = call("init", nullptr);
  if (res == nullptr) return fail();
  Py_DECREF(res);
  return true;
}

bool free_vec(uint8_t *ptr, int32_t /*len*/) {
  std::free(ptr);
  return true;
}

bool destroy_private_key(void *ptr) {
  if (!ptr) return true;
  Gil gil;
  Py_DECREF(static_cast<PyObject *>(ptr));
  return true;
}
bool destroy_public_key(void *ptr) { return destroy_private_key(ptr); }
bool destroy_signature(void *ptr) { return destroy_private_key(ptr); }

// -------------------------------------------------------------------------
// signatures.rs surface (18 extern fns; opaque handles)
// -------------------------------------------------------------------------

bool generate_private_key(void **out_private_key) {
  ensure_python();
  Gil gil;
  return obj_out("generate_private_key_obj", nullptr, out_private_key);
}

bool private_key_to_public_key(const void *in_private_key,
                               void **out_public_key) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(O)", handle(in_private_key));
  return obj_out("private_key_to_public_key_obj", args, out_public_key);
}

bool sign_message(const void *in_private_key, const uint8_t *in_message,
                  int32_t in_message_len, const uint8_t *in_extra_data,
                  int32_t in_extra_data_len, bool should_use_composite,
                  bool should_use_cip22, void **out_signature) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue(
      "(Oy#y#OO)", handle(in_private_key), nn(in_message),
      (Py_ssize_t)in_message_len, nn(in_extra_data), (Py_ssize_t)in_extra_data_len,
      should_use_composite ? Py_True : Py_False,
      should_use_cip22 ? Py_True : Py_False);
  return obj_out("sign_message_obj", args, out_signature);
}

bool sign_pop(const void *in_private_key, const uint8_t *in_message,
              int32_t in_message_len, void **out_signature) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(Oy#)", handle(in_private_key), nn(in_message),
                                 (Py_ssize_t)in_message_len);
  return obj_out("sign_pop_obj", args, out_signature);
}

bool hash_direct(const uint8_t *in_message, int32_t in_message_len,
                 uint8_t **out_hash, int32_t *out_len, bool use_pop) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(y#O)", nn(in_message),
                                 (Py_ssize_t)in_message_len,
                                 use_pop ? Py_True : Py_False);
  return bytes_out("hash_direct", args, out_hash, out_len);
}

bool hash_direct_with_attempt(const uint8_t *in_message,
                              int32_t in_message_len, uint8_t **out_hash,
                              int32_t *out_len, int32_t *out_attempt,
                              bool use_pop) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(y#O)", nn(in_message),
                                 (Py_ssize_t)in_message_len,
                                 use_pop ? Py_True : Py_False);
  PyObject *res = call("hash_direct_with_attempt", args);
  Py_DECREF(args);
  if (res == nullptr || !PyTuple_Check(res)) {
    Py_XDECREF(res);
    return fail();
  }
  bool ok = emit_bytes(PyTuple_GetItem(res, 0), out_hash, out_len);
  *out_attempt = (int32_t)PyLong_AsLong(PyTuple_GetItem(res, 1));
  Py_DECREF(res);
  return ok;
}

bool hash_composite(const uint8_t *in_message, int32_t in_message_len,
                    const uint8_t *in_extra_data, int32_t in_extra_data_len,
                    uint8_t **out_hash, int32_t *out_len) {
  ensure_python();
  Gil gil;
  PyObject *args =
      Py_BuildValue("(y#y#)", nn(in_message), (Py_ssize_t)in_message_len,
                    nn(in_extra_data), (Py_ssize_t)in_extra_data_len);
  return bytes_out("hash_composite", args, out_hash, out_len);
}

bool hash_composite_cip22(const uint8_t *in_message, int32_t in_message_len,
                          const uint8_t *in_extra_data,
                          int32_t in_extra_data_len, uint8_t **out_hash,
                          int32_t *out_len, uint8_t *attempt_counter) {
  ensure_python();
  Gil gil;
  PyObject *args =
      Py_BuildValue("(y#y#)", nn(in_message), (Py_ssize_t)in_message_len,
                    nn(in_extra_data), (Py_ssize_t)in_extra_data_len);
  PyObject *res = call("hash_composite_cip22", args);
  Py_DECREF(args);
  if (res == nullptr || !PyTuple_Check(res)) {
    Py_XDECREF(res);
    return fail();
  }
  bool ok = emit_bytes(PyTuple_GetItem(res, 0), out_hash, out_len);
  *attempt_counter = (uint8_t)PyLong_AsLong(PyTuple_GetItem(res, 1));
  Py_DECREF(res);
  return ok;
}

bool hash_crh(const uint8_t *in_message, int32_t in_message_len,
              int32_t hash_bytes, uint8_t **out_hash, int32_t *out_len) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(y#i)", nn(in_message),
                                 (Py_ssize_t)in_message_len, hash_bytes);
  return bytes_out("hash_crh", args, out_hash, out_len);
}

bool hash_direct_first_step(const uint8_t *in_message, int32_t in_message_len,
                            int32_t hash_bytes, uint8_t **out_hash,
                            int32_t *out_len) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(y#i)", nn(in_message),
                                 (Py_ssize_t)in_message_len, hash_bytes);
  return bytes_out("hash_direct_first_step", args, out_hash, out_len);
}

bool verify_signature(const void *in_public_key, const uint8_t *in_message,
                      int32_t in_message_len, const uint8_t *in_extra_data,
                      int32_t in_extra_data_len, const void *in_signature,
                      bool should_use_composite, bool should_use_cip22,
                      bool *out_verified) {
  ensure_python();
  Gil gil;
  if (!should_use_composite && should_use_cip22) return false;  // bad combo
  PyObject *args = Py_BuildValue(
      "(Oy#y#OOO)", handle(in_public_key), nn(in_message),
      (Py_ssize_t)in_message_len, nn(in_extra_data), (Py_ssize_t)in_extra_data_len,
      handle(in_signature), should_use_composite ? Py_True : Py_False,
      should_use_cip22 ? Py_True : Py_False);
  PyObject *res = call("verify_signature_obj", args);
  Py_DECREF(args);
  if (res == nullptr) return fail();
  *out_verified = PyObject_IsTrue(res) == 1;
  Py_DECREF(res);
  return true;
}

bool verify_pop(const void *in_public_key, const uint8_t *in_message,
                int32_t in_message_len, const void *in_signature,
                bool *out_verified) {
  ensure_python();
  Gil gil;
  PyObject *args =
      Py_BuildValue("(Oy#O)", handle(in_public_key), nn(in_message),
                    (Py_ssize_t)in_message_len, handle(in_signature));
  PyObject *res = call("verify_pop_obj", args);
  Py_DECREF(args);
  if (res == nullptr) return fail();
  *out_verified = PyObject_IsTrue(res) == 1;
  Py_DECREF(res);
  return true;
}

bool batch_verify_signature(const MessageFFI *messages_ptr,
                            uintptr_t messages_len, bool should_use_composite,
                            bool should_use_cip22, bool *verified) {
  ensure_python();
  Gil gil;
  if (!should_use_composite && should_use_cip22) return false;
  PyObject *list = PyList_New((Py_ssize_t)messages_len);
  for (uintptr_t i = 0; i < messages_len; i++) {
    const MessageFFI &m = messages_ptr[i];
    PyObject *entry = Py_BuildValue(
        "(y#y#OO)", nn(m.data.ptr), (Py_ssize_t)m.data.len, nn(m.extra.ptr),
        (Py_ssize_t)m.extra.len, handle(m.public_key), handle(m.sig));
    PyList_SET_ITEM(list, (Py_ssize_t)i, entry);
  }
  PyObject *args = Py_BuildValue(
      "(OOO)", list, should_use_composite ? Py_True : Py_False,
      should_use_cip22 ? Py_True : Py_False);
  Py_DECREF(list);
  PyObject *res = call("batch_verify_objs", args);
  Py_DECREF(args);
  if (res == nullptr) return fail();
  *verified = PyObject_IsTrue(res) == 1;
  Py_DECREF(res);
  return true;
}

bool batch_verify_strict(const BatchMessageFFI *in_batches_ptr,
                         uintptr_t in_batches_len, bool should_use_composite,
                         bool should_use_cip22, bool *out_results) {
  ensure_python();
  Gil gil;
  PyObject *list = PyList_New((Py_ssize_t)in_batches_len);
  for (uintptr_t i = 0; i < in_batches_len; i++) {
    const BatchMessageFFI &b = in_batches_ptr[i];
    PyObject *pks = handle_list(b.public_keys, (Py_ssize_t)b.public_keys_len);
    PyObject *sigs = handle_list(b.signatures, (Py_ssize_t)b.signatures_len);
    PyObject *entry =
        Py_BuildValue("(y#y#OO)", nn(b.data.ptr), (Py_ssize_t)b.data.len,
                      nn(b.extra.ptr), (Py_ssize_t)b.extra.len, pks, sigs);
    Py_DECREF(pks);
    Py_DECREF(sigs);
    PyList_SET_ITEM(list, (Py_ssize_t)i, entry);
  }
  PyObject *args = Py_BuildValue(
      "(OOO)", list, should_use_composite ? Py_True : Py_False,
      should_use_cip22 ? Py_True : Py_False);
  Py_DECREF(list);
  PyObject *res = call("batch_verify_strict_objs", args);
  Py_DECREF(args);
  if (res == nullptr || !PyList_Check(res) ||
      PyList_GET_SIZE(res) != (Py_ssize_t)in_batches_len) {
    Py_XDECREF(res);
    return fail();
  }
  bool all_valid = true;
  for (uintptr_t i = 0; i < in_batches_len; i++) {
    bool ok = PyObject_IsTrue(PyList_GET_ITEM(res, (Py_ssize_t)i)) == 1;
    out_results[i] = ok;
    all_valid = all_valid && ok;
  }
  Py_DECREF(res);
  // the reference errors (-> false) when any batch failed
  // (signatures.rs:398-401), after filling out_results
  return all_valid;
}

bool aggregate_public_keys(const void *const *in_public_keys,
                           int32_t in_public_keys_len,
                           void **out_public_key) {
  ensure_python();
  Gil gil;
  PyObject *list = handle_list(in_public_keys, in_public_keys_len);
  PyObject *args = Py_BuildValue("(O)", list);
  Py_DECREF(list);
  return obj_out("aggregate_public_keys_objs", args, out_public_key);
}

bool aggregate_public_keys_subtract(const void *in_aggregated_public_key,
                                    const void *const *in_public_keys,
                                    int32_t in_public_keys_len,
                                    void **out_public_key) {
  ensure_python();
  Gil gil;
  PyObject *list = handle_list(in_public_keys, in_public_keys_len);
  PyObject *args =
      Py_BuildValue("(OO)", handle(in_aggregated_public_key), list);
  Py_DECREF(list);
  return obj_out("aggregate_public_keys_subtract_objs", args, out_public_key);
}

bool aggregate_signatures(const void *const *in_signatures,
                          int32_t in_signatures_len, void **out_signature) {
  ensure_python();
  Gil gil;
  PyObject *list = handle_list(in_signatures, in_signatures_len);
  PyObject *args = Py_BuildValue("(O)", list);
  Py_DECREF(list);
  return obj_out("aggregate_signatures_objs", args, out_signature);
}

// -------------------------------------------------------------------------
// serialization.rs surface
// -------------------------------------------------------------------------

static bool deserialize_obj(const char *fn, const uint8_t *in, int32_t in_len,
                            void **out) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(y#)", in, (Py_ssize_t)in_len);
  return obj_out(fn, args, out);
}

static bool serialize_obj(const char *fn, const void *obj, uint8_t **out,
                          int32_t *out_len) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(O)", handle(obj));
  return bytes_out(fn, args, out, out_len);
}

bool deserialize_private_key(const uint8_t *in, int32_t in_len, void **out) {
  return deserialize_obj("deserialize_private_key", in, in_len, out);
}
bool serialize_private_key(const void *sk, uint8_t **out, int32_t *out_len) {
  return serialize_obj("serialize_private_key", sk, out, out_len);
}
bool deserialize_public_key(const uint8_t *in, int32_t in_len, void **out) {
  return deserialize_obj("deserialize_public_key", in, in_len, out);
}
bool deserialize_public_key_cached(const uint8_t *in, int32_t in_len,
                                   void **out) {
  return deserialize_obj("deserialize_public_key_cached", in, in_len, out);
}
bool serialize_public_key(const void *pk, uint8_t **out, int32_t *out_len) {
  return serialize_obj("serialize_public_key", pk, out, out_len);
}
bool serialize_public_key_uncompressed(const void *pk, uint8_t **out,
                                       int32_t *out_len) {
  return serialize_obj("serialize_public_key_uncompressed", pk, out, out_len);
}
bool deserialize_signature(const uint8_t *in, int32_t in_len, void **out) {
  return deserialize_obj("deserialize_signature", in, in_len, out);
}
bool serialize_signature(const void *sig, uint8_t **out, int32_t *out_len) {
  return serialize_obj("serialize_signature", sig, out, out_len);
}
bool serialize_signature_uncompressed(const void *sig, uint8_t **out,
                                      int32_t *out_len) {
  return serialize_obj("serialize_signature_uncompressed", sig, out, out_len);
}

bool compress_signature(const uint8_t *in, int32_t in_len, uint8_t **out,
                        int32_t *out_len) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(y#)", in, (Py_ssize_t)in_len);
  return bytes_out("compress_signature", args, out, out_len);
}

bool compress_pubkey(const uint8_t *in, int32_t in_len, uint8_t **out,
                     int32_t *out_len) {
  ensure_python();
  Gil gil;
  PyObject *args = Py_BuildValue("(y#)", in, (Py_ssize_t)in_len);
  return bytes_out("compress_pubkey", args, out, out_len);
}

// -------------------------------------------------------------------------
// snark/mod.rs surface
// -------------------------------------------------------------------------

// repr(C) mirror of EpochBlockFFI (snark/epoch_block.rs:109-127)
struct EpochBlockFFI {
  uint16_t index;
  uint8_t round;
  const uint8_t *epoch_entropy;   // 16 bytes or null
  const uint8_t *parent_entropy;  // 16 bytes or null
  uint32_t maximum_non_signers;
  uint32_t pubkeys_num;
  uint32_t maximum_validators;
  const uint8_t *pubkeys;  // pubkeys_num * 96 bytes (compressed G2)
};

static PyObject *epoch_block_to_py(const EpochBlockFFI *e) {
  PyObject *mod = PyImport_ImportModule("celo_bls_snark_tpu_torch.ffi.c_abi_support");
  if (mod == nullptr) return nullptr;
  PyObject *fn = PyObject_GetAttrString(mod, "make_epoch_block");
  Py_DECREF(mod);
  if (fn == nullptr) return nullptr;
  PyObject *epoch_entropy =
      e->epoch_entropy
          ? PyBytes_FromStringAndSize(
                reinterpret_cast<const char *>(e->epoch_entropy), 16)
          : (Py_INCREF(Py_None), Py_None);
  PyObject *parent_entropy =
      e->parent_entropy
          ? PyBytes_FromStringAndSize(
                reinterpret_cast<const char *>(e->parent_entropy), 16)
          : (Py_INCREF(Py_None), Py_None);
  PyObject *pubkeys = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(e->pubkeys),
      (Py_ssize_t)e->pubkeys_num * 96);
  PyObject *args = Py_BuildValue("(HBOOIIO)", e->index, e->round,
                                 epoch_entropy, parent_entropy,
                                 e->maximum_non_signers, e->maximum_validators,
                                 pubkeys);
  Py_DECREF(epoch_entropy);
  Py_DECREF(parent_entropy);
  Py_DECREF(pubkeys);
  PyObject *res = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_DECREF(args);
  return res;
}

bool verify(const uint8_t *vk, uint32_t vk_len, const uint8_t *proof,
            uint32_t proof_len, EpochBlockFFI first_epoch,
            EpochBlockFFI last_epoch) {
  ensure_python();
  Gil gil;
  PyObject *first = epoch_block_to_py(&first_epoch);
  PyObject *last = epoch_block_to_py(&last_epoch);
  if (first == nullptr || last == nullptr) {
    Py_XDECREF(first);
    Py_XDECREF(last);
    return fail();
  }
  PyObject *args = Py_BuildValue("(y#y#OO)", vk, (Py_ssize_t)vk_len, proof,
                                 (Py_ssize_t)proof_len, first, last);
  Py_DECREF(first);
  Py_DECREF(last);
  PyObject *res = call("verify", args);
  Py_DECREF(args);
  if (res == nullptr) return fail();
  bool ok = PyObject_IsTrue(res) == 1;
  Py_DECREF(res);
  return ok;
}

// Unpacked-field EpochBlock builder shared by the two encode entry points
// (snark/epoch_block.rs:17-46 and :69-105): public keys arrive as opaque
// HANDLES (const PublicKey* array), entropy as 16-byte buffers or NULL.
static PyObject *epoch_block_from_fields(
    uint16_t index, uint8_t round, const uint8_t *epoch_entropy,
    const uint8_t *parent_entropy, uint32_t maximum_non_signers,
    uint32_t maximum_validators, const void *const *pubkeys,
    int32_t pubkeys_len) {
  PyObject *mod = PyImport_ImportModule("celo_bls_snark_tpu_torch.ffi.c_abi_support");
  if (mod == nullptr) return nullptr;
  PyObject *fn = PyObject_GetAttrString(mod, "make_epoch_block_from_objs");
  Py_DECREF(mod);
  if (fn == nullptr) return nullptr;
  PyObject *ee =
      epoch_entropy ? PyBytes_FromStringAndSize(
                          reinterpret_cast<const char *>(epoch_entropy), 16)
                    : (Py_INCREF(Py_None), Py_None);
  PyObject *pe =
      parent_entropy ? PyBytes_FromStringAndSize(
                           reinterpret_cast<const char *>(parent_entropy), 16)
                     : (Py_INCREF(Py_None), Py_None);
  PyObject *pks = handle_list(pubkeys, pubkeys_len);
  PyObject *args = Py_BuildValue("(HBOOIIO)", index, round, ee, pe,
                                 maximum_non_signers, maximum_validators, pks);
  Py_DECREF(ee);
  Py_DECREF(pe);
  Py_DECREF(pks);
  PyObject *res = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_DECREF(args);
  return res;
}

// snark/epoch_block.rs:17-66: CIP22 inner encoding; emits BOTH the inner
// bytes and the extra_data bytes.
bool encode_epoch_block_to_bytes_cip22(
    uint16_t in_epoch_index, uint8_t in_round_number,
    const uint8_t *in_epoch_entropy, const uint8_t *in_parent_entropy,
    uint32_t in_maximum_non_signers, uint32_t in_maximum_validators,
    const void *const *in_added_public_keys, int32_t in_added_public_keys_len,
    uint8_t **out_bytes, int32_t *out_len, uint8_t **out_extra_data_bytes,
    int32_t *out_extra_data_len) {
  ensure_python();
  Gil gil;
  PyObject *block = epoch_block_from_fields(
      in_epoch_index, in_round_number, in_epoch_entropy, in_parent_entropy,
      in_maximum_non_signers, in_maximum_validators, in_added_public_keys,
      in_added_public_keys_len);
  if (block == nullptr) return fail();
  PyObject *args = Py_BuildValue("(O)", block);
  Py_DECREF(block);
  PyObject *res = call("encode_epoch_block_to_bytes_cip22", args);
  Py_DECREF(args);
  if (res == nullptr || !PyTuple_Check(res) || PyTuple_GET_SIZE(res) != 2) {
    Py_XDECREF(res);
    return fail();
  }
  bool ok = emit_bytes(PyTuple_GET_ITEM(res, 0), out_bytes, out_len) &&
            emit_bytes(PyTuple_GET_ITEM(res, 1), out_extra_data_bytes,
                       out_extra_data_len);
  Py_DECREF(res);
  return ok;
}

// snark/epoch_block.rs:69-105: pre-CIP22 encoding (round/entropy unused,
// maximum_validators == pubkey count).
bool encode_epoch_block_to_bytes(uint16_t in_epoch_index,
                                 uint32_t in_maximum_non_signers,
                                 const void *const *in_added_public_keys,
                                 int32_t in_added_public_keys_len,
                                 uint8_t **out_bytes, int32_t *out_len) {
  ensure_python();
  Gil gil;
  PyObject *block = epoch_block_from_fields(
      in_epoch_index, 0, nullptr, nullptr, in_maximum_non_signers,
      static_cast<uint32_t>(in_added_public_keys_len), in_added_public_keys,
      in_added_public_keys_len);
  if (block == nullptr) return fail();
  PyObject *args = Py_BuildValue("(O)", block);
  Py_DECREF(block);
  return bytes_out("encode_epoch_block_to_bytes", args, out_bytes, out_len);
}

}  // extern "C"
