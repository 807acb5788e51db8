// The Python entry point of each kernel library in this directory.
//
// Every source here defines its kernels, a plain C launcher
// (extern "C" int name(...), returning the cudaError_t of its launches)
// and, through MXT_PY_MODULE below, a CPython extension module
// _mxt_<name> whose one function, launch(*args), converts its Python
// arguments, calls the launcher with the GIL released, and returns its
// error code. mxnet_tpu_torch/ops/_kernels.py builds each source with
// nvcc against the running Python's headers and imports the module once;
// a wrapper then calls launch() directly, with no ctypes conversion of
// each argument on the way (mxnet_tpu_torch/tools/launch_cost_probe.py
// times both on the card's host).
//
// Include this header first: Python.h must come before any standard
// header.

#pragma once

#define PY_SSIZE_T_CLEAN
#include <Python.h>

namespace mxt_py {

// argument converters; a failed conversion leaves a Python error set,
// which the caller checks once with PyErr_Occurred() before launching
inline void* ptr(PyObject* o) {
  return o == Py_None ? nullptr : PyLong_AsVoidPtr(o);
}
inline int i32(PyObject* o) { return static_cast<int>(PyLong_AsLong(o)); }
inline long long i64(PyObject* o) { return PyLong_AsLongLong(o); }
inline float f32(PyObject* o) {
  return static_cast<float>(PyFloat_AsDouble(o));
}

// a tuple of n ints into out[0..n)
inline bool i64s(PyObject* o, long long* out, Py_ssize_t n) {
  if (!PyTuple_Check(o) || PyTuple_GET_SIZE(o) != n) {
    PyErr_Format(PyExc_TypeError, "expected a tuple of %zd ints", n);
    return false;
  }
  for (Py_ssize_t i = 0; i < n; ++i)
    out[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(o, i));
  return !PyErr_Occurred();
}

inline bool nargs(Py_ssize_t got, Py_ssize_t want, const char* name) {
  if (got == want) return true;
  PyErr_Format(PyExc_TypeError, "%s.launch takes %zd arguments, got %zd",
               name, want, got);
  return false;
}

}  // namespace mxt_py

// Defines module _mxt_<name> with launch = fn, a METH_FASTCALL function
// PyObject* fn(PyObject* self, PyObject* const* args, Py_ssize_t nargs).
#define MXT_PY_MODULE(name, fn)                                            \
  static PyMethodDef mxt_methods_[] = {                                    \
      {"launch",                                                           \
       reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(fn)), \
       METH_FASTCALL, "Launch the kernel; returns its cudaError_t."},      \
      {nullptr, nullptr, 0, nullptr}};                                     \
  static PyModuleDef mxt_module_ = {PyModuleDef_HEAD_INIT, "_mxt_" #name,  \
                                    nullptr, -1, mxt_methods_};            \
  PyMODINIT_FUNC PyInit__mxt_##name(void) {                               \
    return PyModule_Create(&mxt_module_);                                  \
  }
