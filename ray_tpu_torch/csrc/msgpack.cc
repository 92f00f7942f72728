// The runtime's msgpack codec as a CPython extension module.
//
// Writes the bytes that ``msgpack.packb(obj, use_bin_type=True,
// default=...)`` writes and reads them as ``msgpack.unpackb(data,
// raw=False, use_list=True, ext_hook=..., strict_map_key=False)`` does,
// value for value and error for error with the pure-Python codec
// ``ray_tpu_torch/_private/msgpack_plain.py``, which the tests hold it
// against. Built at first use by ``ray_tpu_torch/_private/msgpack.py``
// through ``native_build.load_extension``; ``_setup`` hands it the plain
// module's ``ExtType``, ``FormatError`` and ``ExtraData`` classes, so both
// codecs share them.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxDepth = 512;  // msgpack's default nesting limit

PyObject *g_ext_type = nullptr;
PyObject *g_format_error = nullptr;
PyObject *g_extra_data = nullptr;

// ---------------------------------------------------------------------------
// Packing: into one bytes object that grows by doubling and is cut to size
// at the end (no second copy of the output).
// ---------------------------------------------------------------------------

struct Packer {
  PyObject *out = nullptr;  // a bytes object owned while packing
  char *data = nullptr;
  Py_ssize_t len = 0;
  Py_ssize_t cap = 0;
  PyObject *default_fn = nullptr;  // borrowed; nullptr when None
};

int reserve(Packer *pk, Py_ssize_t extra) {
  if (pk->len + extra <= pk->cap) return 0;
  Py_ssize_t cap = pk->cap;
  while (cap < pk->len + extra) cap *= 2;
  if (_PyBytes_Resize(&pk->out, cap) < 0) return -1;
  pk->data = PyBytes_AS_STRING(pk->out);
  pk->cap = cap;
  return 0;
}

inline void put_be(char *p, uint64_t v, int n) {
  for (int i = n - 1; i >= 0; --i) {
    p[i] = static_cast<char>(v & 0xFF);
    v >>= 8;
  }
}

// a type byte followed by an n-byte big-endian value
int put_head(Packer *pk, uint8_t type, uint64_t v, int n) {
  if (reserve(pk, 1 + n) < 0) return -1;
  pk->data[pk->len] = static_cast<char>(type);
  put_be(pk->data + pk->len + 1, v, n);
  pk->len += 1 + n;
  return 0;
}

int put_byte(Packer *pk, uint8_t b) {
  if (reserve(pk, 1) < 0) return -1;
  pk->data[pk->len++] = static_cast<char>(b);
  return 0;
}

int put_raw(Packer *pk, const char *src, Py_ssize_t n) {
  if (reserve(pk, n) < 0) return -1;
  if (n) std::memcpy(pk->data + pk->len, src, n);
  pk->len += n;
  return 0;
}

int pack_int(Packer *pk, PyObject *obj) {
  int overflow = 0;
  long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
  if (overflow == 0) {
    if (v == -1 && PyErr_Occurred()) return -1;
    if (v >= 0) {
      uint64_t u = static_cast<uint64_t>(v);
      if (u < 0x80) return put_byte(pk, static_cast<uint8_t>(u));
      if (u <= 0xFF) return put_head(pk, 0xCC, u, 1);
      if (u <= 0xFFFF) return put_head(pk, 0xCD, u, 2);
      if (u <= 0xFFFFFFFFULL) return put_head(pk, 0xCE, u, 4);
      return put_head(pk, 0xCF, u, 8);
    }
    if (v >= -32) return put_byte(pk, static_cast<uint8_t>(v & 0xFF));
    uint64_t bits = static_cast<uint64_t>(v);
    if (v >= -0x80) return put_head(pk, 0xD0, bits, 1);
    if (v >= -0x8000) return put_head(pk, 0xD1, bits, 2);
    if (v >= -0x80000000LL) return put_head(pk, 0xD2, bits, 4);
    return put_head(pk, 0xD3, bits, 8);
  }
  if (overflow > 0) {
    unsigned long long u = PyLong_AsUnsignedLongLong(obj);
    if (!(u == static_cast<unsigned long long>(-1) && PyErr_Occurred()))
      return put_head(pk, 0xCF, u, 8);
    PyErr_Clear();
  }
  PyErr_SetString(PyExc_OverflowError, "Integer value out of range");
  return -1;
}

int pack_bin(Packer *pk, const char *src, Py_ssize_t n) {
  int rc;
  if (n <= 0xFF) {
    rc = put_head(pk, 0xC4, n, 1);
  } else if (n <= 0xFFFF) {
    rc = put_head(pk, 0xC5, n, 2);
  } else if (n <= 0xFFFFFFFFLL) {
    rc = put_head(pk, 0xC6, n, 4);
  } else {
    PyErr_SetString(PyExc_ValueError, "bin data too long");
    return -1;
  }
  return rc < 0 ? -1 : put_raw(pk, src, n);
}

// array and map headers: fixarray/fixmap below 16, then 16 and 32 bits
int pack_container_head(Packer *pk, Py_ssize_t n, uint8_t fix, uint8_t c16,
                        uint8_t c32) {
  if (n < 16) return put_byte(pk, static_cast<uint8_t>(fix | n));
  if (n <= 0xFFFF) return put_head(pk, c16, n, 2);
  if (n <= 0xFFFFFFFFLL) return put_head(pk, c32, n, 4);
  PyErr_SetString(PyExc_ValueError, "object too large");
  return -1;
}

int pack(Packer *pk, PyObject *obj, int depth);

int pack_ext(Packer *pk, PyObject *obj) {
  // ExtType's constructor checks its fields; _make and tuple.__new__ do not
  if (PyTuple_GET_SIZE(obj) != 2 || !PyBytes_Check(PyTuple_GET_ITEM(obj, 1))) {
    PyErr_SetString(PyExc_TypeError, "ExtType data must be bytes");
    return -1;
  }
  PyObject *code_obj = PyTuple_GET_ITEM(obj, 0);
  PyObject *data = PyTuple_GET_ITEM(obj, 1);
  long code = PyLong_AsLong(code_obj);
  if (code == -1 && PyErr_Occurred()) return -1;
  Py_ssize_t n = PyBytes_GET_SIZE(data);
  uint8_t c = static_cast<uint8_t>(code & 0xFF);
  int rc;
  switch (n) {
    case 1: rc = put_head(pk, 0xD4, c, 1); break;
    case 2: rc = put_head(pk, 0xD5, c, 1); break;
    case 4: rc = put_head(pk, 0xD6, c, 1); break;
    case 8: rc = put_head(pk, 0xD7, c, 1); break;
    case 16: rc = put_head(pk, 0xD8, c, 1); break;
    default:
      if (n <= 0xFF) {
        rc = put_head(pk, 0xC7, n, 1);
      } else if (n <= 0xFFFF) {
        rc = put_head(pk, 0xC8, n, 2);
      } else if (n <= 0xFFFFFFFFLL) {
        rc = put_head(pk, 0xC9, n, 4);
      } else {
        PyErr_SetString(PyExc_ValueError, "EXT data is too large");
        return -1;
      }
      if (rc == 0) rc = put_byte(pk, c);
  }
  return rc < 0 ? -1 : put_raw(pk, PyBytes_AS_STRING(data), n);
}

int pack_str(Packer *pk, PyObject *obj) {
  Py_ssize_t n;
  const char *s = PyUnicode_AsUTF8AndSize(obj, &n);
  if (s == nullptr) return -1;
  int rc;
  if (n < 32) {
    rc = put_byte(pk, static_cast<uint8_t>(0xA0 | n));
  } else if (n <= 0xFF) {
    rc = put_head(pk, 0xD9, n, 1);
  } else if (n <= 0xFFFF) {
    rc = put_head(pk, 0xDA, n, 2);
  } else if (n <= 0xFFFFFFFFLL) {
    rc = put_head(pk, 0xDB, n, 4);
  } else {
    PyErr_SetString(PyExc_ValueError, "unicode string is too large");
    return -1;
  }
  return rc < 0 ? -1 : put_raw(pk, s, n);
}

int pack_dict(Packer *pk, PyObject *obj, int depth) {
  if (pack_container_head(pk, PyDict_GET_SIZE(obj), 0x80, 0xDE, 0xDF) < 0)
    return -1;
  Py_ssize_t pos = 0;
  PyObject *k, *v;
  while (PyDict_Next(obj, &pos, &k, &v)) {
    Py_INCREF(k);
    Py_INCREF(v);
    int rc = pack(pk, k, depth + 1);
    if (rc == 0) rc = pack(pk, v, depth + 1);
    Py_DECREF(k);
    Py_DECREF(v);
    if (rc < 0) return -1;
  }
  return 0;
}

int pack_seq(Packer *pk, PyObject *obj, int depth) {
  bool is_list = PyList_Check(obj);
  Py_ssize_t n = is_list ? PyList_GET_SIZE(obj) : PyTuple_GET_SIZE(obj);
  if (pack_container_head(pk, n, 0x90, 0xDC, 0xDD) < 0) return -1;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *item;
    if (is_list) {
      if (i >= PyList_GET_SIZE(obj)) break;  // shrunk by a default call
      item = PyList_GET_ITEM(obj, i);
    } else {
      item = PyTuple_GET_ITEM(obj, i);
    }
    Py_INCREF(item);
    int rc = pack(pk, item, depth + 1);
    Py_DECREF(item);
    if (rc < 0) return -1;
  }
  return 0;
}

int pack(Packer *pk, PyObject *obj, int depth) {
  if (depth > kMaxDepth) {
    PyErr_SetString(PyExc_ValueError, "recursion limit exceeded.");
    return -1;
  }
  PyObject *owned = nullptr;  // default()'s result
  int rc;
  for (;;) {
    if (obj == Py_None) {
      rc = put_byte(pk, 0xC0);
    } else if (obj == Py_True) {
      rc = put_byte(pk, 0xC3);
    } else if (obj == Py_False) {
      rc = put_byte(pk, 0xC2);
    } else if (PyLong_Check(obj)) {
      rc = pack_int(pk, obj);
    } else if (PyFloat_Check(obj)) {
      double d = PyFloat_AS_DOUBLE(obj);
      uint64_t bits;
      std::memcpy(&bits, &d, 8);
      rc = put_head(pk, 0xCB, bits, 8);
    } else if (PyBytes_Check(obj)) {
      rc = pack_bin(pk, PyBytes_AS_STRING(obj), PyBytes_GET_SIZE(obj));
    } else if (PyByteArray_Check(obj)) {
      rc = pack_bin(pk, PyByteArray_AS_STRING(obj),
                    PyByteArray_GET_SIZE(obj));
    } else if (PyUnicode_Check(obj)) {
      rc = pack_str(pk, obj);
    } else if (PyDict_Check(obj)) {
      rc = pack_dict(pk, obj, depth);
    } else if (PyObject_TypeCheck(obj,
                                  reinterpret_cast<PyTypeObject *>(g_ext_type))) {
      rc = pack_ext(pk, obj);
    } else if (PyList_Check(obj) || PyTuple_Check(obj)) {
      rc = pack_seq(pk, obj, depth);
    } else if (PyMemoryView_Check(obj)) {
      PyObject *b = PyObject_CallMethod(obj, "tobytes", nullptr);
      if (b == nullptr) {
        rc = -1;
      } else {
        rc = pack_bin(pk, PyBytes_AS_STRING(b), PyBytes_GET_SIZE(b));
        Py_DECREF(b);
      }
    } else if (pk->default_fn != nullptr && owned == nullptr) {
      owned = PyObject_CallOneArg(pk->default_fn, obj);
      if (owned == nullptr) return -1;
      obj = owned;
      continue;
    } else {
      PyObject *name = PyType_GetName(Py_TYPE(obj));
      if (name != nullptr) {
        PyErr_Format(PyExc_TypeError, "can not serialize %R object", name);
        Py_DECREF(name);
      }
      rc = -1;
    }
    break;
  }
  Py_XDECREF(owned);
  return rc;
}

// ---------------------------------------------------------------------------
// Unpacking, in place from the caller's buffer.
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t *p;
  Py_ssize_t pos;
  Py_ssize_t len;
  PyObject *ext_hook;  // borrowed; nullptr when None
};

PyObject *incomplete() {
  PyErr_SetString(PyExc_ValueError, "Unpack failed: incomplete input");
  return nullptr;
}

// the next n bytes as a big-endian unsigned value; false when short
inline bool take_be(Reader *r, int n, uint64_t *out) {
  if (r->len - r->pos < n) return false;
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v = (v << 8) | r->p[r->pos + i];
  r->pos += n;
  *out = v;
  return true;
}

PyObject *read(Reader *r, int depth);

PyObject *read_str(Reader *r, uint64_t n) {
  if (static_cast<uint64_t>(r->len - r->pos) < n) return incomplete();
  PyObject *s = PyUnicode_DecodeUTF8(
      reinterpret_cast<const char *>(r->p + r->pos),
      static_cast<Py_ssize_t>(n), "strict");
  r->pos += static_cast<Py_ssize_t>(n);
  return s;
}

PyObject *read_bin(Reader *r, uint64_t n) {
  if (static_cast<uint64_t>(r->len - r->pos) < n) return incomplete();
  PyObject *b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(r->p + r->pos),
      static_cast<Py_ssize_t>(n));
  r->pos += static_cast<Py_ssize_t>(n);
  return b;
}

PyObject *read_ext(Reader *r, uint64_t n) {
  uint64_t code_bits;
  if (!take_be(r, 1, &code_bits)) return incomplete();
  long code = static_cast<int8_t>(code_bits);
  PyObject *data = read_bin(r, n);
  if (data == nullptr) return nullptr;
  PyObject *fn = r->ext_hook != nullptr ? r->ext_hook : g_ext_type;
  PyObject *out = PyObject_CallFunction(fn, "lN", code, data);
  return out;
}

PyObject *read_array(Reader *r, uint64_t n, int depth) {
  // a count beyond the bytes left cannot be met: read item by item until
  // the input runs out, as the plain codec does, instead of allocating it
  bool sized = n <= static_cast<uint64_t>(r->len - r->pos);
  PyObject *out = PyList_New(sized ? static_cast<Py_ssize_t>(n) : 0);
  if (out == nullptr) return nullptr;
  for (uint64_t i = 0; i < n; ++i) {
    PyObject *item = read(r, depth + 1);
    if (item == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    if (sized) {
      PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), item);
    } else {
      int rc = PyList_Append(out, item);
      Py_DECREF(item);
      if (rc < 0) {
        Py_DECREF(out);
        return nullptr;
      }
    }
  }
  return out;
}

PyObject *read_map(Reader *r, uint64_t n, int depth) {
  PyObject *out = PyDict_New();
  if (out == nullptr) return nullptr;
  for (uint64_t i = 0; i < n; ++i) {
    PyObject *k = read(r, depth + 1);
    if (k == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyObject *v = read(r, depth + 1);
    if (v == nullptr) {
      Py_DECREF(k);
      Py_DECREF(out);
      return nullptr;
    }
    int rc = PyDict_SetItem(out, k, v);
    Py_DECREF(k);
    Py_DECREF(v);
    if (rc < 0) {
      Py_DECREF(out);
      return nullptr;
    }
  }
  return out;
}

PyObject *read(Reader *r, int depth) {
  if (depth > kMaxDepth) {
    PyErr_SetString(PyExc_ValueError, "recursion limit exceeded.");
    return nullptr;
  }
  if (r->pos >= r->len) return incomplete();
  uint8_t b = r->p[r->pos++];
  if (b < 0x80) return PyLong_FromLong(b);
  if (b >= 0xE0) return PyLong_FromLong(static_cast<long>(b) - 0x100);
  if (b < 0x90) return read_map(r, b & 0x0F, depth);
  if (b < 0xA0) return read_array(r, b & 0x0F, depth);
  if (b < 0xC0) return read_str(r, b & 0x1F);
  uint64_t v;
  switch (b) {
    case 0xC0: Py_RETURN_NONE;
    case 0xC2: Py_RETURN_FALSE;
    case 0xC3: Py_RETURN_TRUE;
    case 0xC4: return take_be(r, 1, &v) ? read_bin(r, v) : incomplete();
    case 0xC5: return take_be(r, 2, &v) ? read_bin(r, v) : incomplete();
    case 0xC6: return take_be(r, 4, &v) ? read_bin(r, v) : incomplete();
    case 0xC7: return take_be(r, 1, &v) ? read_ext(r, v) : incomplete();
    case 0xC8: return take_be(r, 2, &v) ? read_ext(r, v) : incomplete();
    case 0xC9: return take_be(r, 4, &v) ? read_ext(r, v) : incomplete();
    case 0xCA: {
      if (!take_be(r, 4, &v)) return incomplete();
      uint32_t bits = static_cast<uint32_t>(v);
      float f;
      std::memcpy(&f, &bits, 4);
      return PyFloat_FromDouble(f);
    }
    case 0xCB: {
      if (!take_be(r, 8, &v)) return incomplete();
      double d;
      std::memcpy(&d, &v, 8);
      return PyFloat_FromDouble(d);
    }
    case 0xCC: return take_be(r, 1, &v) ? PyLong_FromUnsignedLongLong(v) : incomplete();
    case 0xCD: return take_be(r, 2, &v) ? PyLong_FromUnsignedLongLong(v) : incomplete();
    case 0xCE: return take_be(r, 4, &v) ? PyLong_FromUnsignedLongLong(v) : incomplete();
    case 0xCF: return take_be(r, 8, &v) ? PyLong_FromUnsignedLongLong(v) : incomplete();
    case 0xD0: return take_be(r, 1, &v) ? PyLong_FromLong(static_cast<int8_t>(v)) : incomplete();
    case 0xD1: return take_be(r, 2, &v) ? PyLong_FromLong(static_cast<int16_t>(v)) : incomplete();
    case 0xD2: return take_be(r, 4, &v) ? PyLong_FromLong(static_cast<int32_t>(v)) : incomplete();
    case 0xD3: return take_be(r, 8, &v) ? PyLong_FromLongLong(static_cast<int64_t>(v)) : incomplete();
    case 0xD4: return read_ext(r, 1);
    case 0xD5: return read_ext(r, 2);
    case 0xD6: return read_ext(r, 4);
    case 0xD7: return read_ext(r, 8);
    case 0xD8: return read_ext(r, 16);
    case 0xD9: return take_be(r, 1, &v) ? read_str(r, v) : incomplete();
    case 0xDA: return take_be(r, 2, &v) ? read_str(r, v) : incomplete();
    case 0xDB: return take_be(r, 4, &v) ? read_str(r, v) : incomplete();
    case 0xDC: return take_be(r, 2, &v) ? read_array(r, v, depth) : incomplete();
    case 0xDD: return take_be(r, 4, &v) ? read_array(r, v, depth) : incomplete();
    case 0xDE: return take_be(r, 2, &v) ? read_map(r, v, depth) : incomplete();
    case 0xDF: return take_be(r, 4, &v) ? read_map(r, v, depth) : incomplete();
    default:
      PyErr_Format(g_format_error, "Unpack failed: unknown first byte 0x%x",
                   static_cast<unsigned>(b));
      return nullptr;
  }
}

// ---------------------------------------------------------------------------
// Module functions
// ---------------------------------------------------------------------------

bool ready() {
  if (g_ext_type != nullptr) return true;
  PyErr_SetString(PyExc_RuntimeError, "call _setup before packing");
  return false;
}

// one optional argument, positional (second) or by the keyword ``name``
int optional_arg(PyObject *const *args, Py_ssize_t nargs, PyObject *kwnames,
                 const char *fn, const char *name, PyObject **out) {
  *out = nullptr;
  if (nargs < 1 || nargs > 2) {
    PyErr_Format(PyExc_TypeError, "%s() takes 1 or 2 positional arguments",
                 fn);
    return -1;
  }
  if (nargs == 2) *out = args[1];
  Py_ssize_t nkw = kwnames ? PyTuple_GET_SIZE(kwnames) : 0;
  for (Py_ssize_t i = 0; i < nkw; ++i) {
    PyObject *key = PyTuple_GET_ITEM(kwnames, i);
    if (PyUnicode_CompareWithASCIIString(key, name) != 0 || *out != nullptr) {
      PyErr_Format(PyExc_TypeError, "%s() got an unexpected keyword %R", fn,
                   key);
      return -1;
    }
    *out = args[nargs + i];
  }
  if (*out == Py_None) *out = nullptr;
  return 0;
}

PyObject *packb(PyObject *, PyObject *const *args, Py_ssize_t nargs,
                PyObject *kwnames) {
  Packer pk;
  if (!ready() ||
      optional_arg(args, nargs, kwnames, "packb", "default", &pk.default_fn) < 0)
    return nullptr;
  pk.cap = 256;
  pk.out = PyBytes_FromStringAndSize(nullptr, pk.cap);
  if (pk.out == nullptr) return nullptr;
  pk.data = PyBytes_AS_STRING(pk.out);
  if (pack(&pk, args[0], 0) < 0 || _PyBytes_Resize(&pk.out, pk.len) < 0) {
    Py_XDECREF(pk.out);
    return nullptr;
  }
  return pk.out;
}

PyObject *unpackb(PyObject *, PyObject *const *args, Py_ssize_t nargs,
                  PyObject *kwnames) {
  Reader r;
  if (!ready() ||
      optional_arg(args, nargs, kwnames, "unpackb", "ext_hook",
                   &r.ext_hook) < 0)
    return nullptr;
  Py_buffer view;
  if (PyObject_GetBuffer(args[0], &view, PyBUF_SIMPLE) < 0) return nullptr;
  r.p = static_cast<const uint8_t *>(view.buf);
  r.pos = 0;
  r.len = view.len;
  PyObject *value = read(&r, 0);
  if (value != nullptr && r.pos != r.len) {
    PyObject *extra = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(r.p + r.pos), r.len - r.pos);
    if (extra != nullptr) {
      PyObject *err = PyObject_CallFunctionObjArgs(g_extra_data, value, extra,
                                                   nullptr);
      if (err != nullptr) {
        PyErr_SetObject(g_extra_data, err);
        Py_DECREF(err);
      }
      Py_DECREF(extra);
    }
    Py_CLEAR(value);
  }
  PyBuffer_Release(&view);
  return value;
}

PyObject *setup(PyObject *, PyObject *args) {
  PyObject *ext_type, *format_error, *extra_data;
  if (!PyArg_ParseTuple(args, "O!OO", &PyType_Type, &ext_type, &format_error,
                        &extra_data))
    return nullptr;
  if (!PyType_IsSubtype(reinterpret_cast<PyTypeObject *>(ext_type),
                        &PyTuple_Type)) {
    PyErr_SetString(PyExc_TypeError, "ExtType must be a tuple type");
    return nullptr;
  }
  Py_INCREF(ext_type);
  Py_INCREF(format_error);
  Py_INCREF(extra_data);
  Py_XSETREF(g_ext_type, ext_type);
  Py_XSETREF(g_format_error, format_error);
  Py_XSETREF(g_extra_data, extra_data);
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"packb", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(packb)),
     METH_FASTCALL | METH_KEYWORDS,
     "packb(obj, default=None) -> bytes, as msgpack.packb(obj, "
     "use_bin_type=True, default=default)"},
    {"unpackb", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(unpackb)),
     METH_FASTCALL | METH_KEYWORDS,
     "unpackb(data, ext_hook=None), as msgpack.unpackb(data, raw=False, "
     "ext_hook=ext_hook, strict_map_key=False)"},
    {"_setup", setup, METH_VARARGS,
     "_setup(ExtType, FormatError, ExtraData): the classes to build and raise"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "ray_tpu_torch_msgpack",
                       "The runtime's msgpack codec.", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_ray_tpu_torch_msgpack(void) {
  return PyModule_Create(&kModule);
}
