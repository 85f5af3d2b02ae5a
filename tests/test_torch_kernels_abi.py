"""The C interface of the port's CUDA kernels against its ctypes binding.

Each ``csrc/<name>.cu`` exports plain ``extern "C"`` functions that
``grendel_tpu_torch/kernels.py`` binds with ``ctypes`` from
``kernels.SIGNATURES``. No compiler runs here, and a binding that passes
the wrong count or width of arguments shows on the card only as a crash,
so each prototype is parsed from the source and held to its binding:
the same functions, the same number of arguments, and each argument of
the same kind (pointer, 32-bit or 64-bit integer, 32-bit float), the
return type too.
"""

import ctypes
import re

import pytest

from grendel_tpu_torch import kernels

_INT32 = {"int", "int32_t", "uint32_t", "unsigned"}
_INT64 = {"int64_t", "uint64_t", "size_t"}
_FLOAT32 = {"float"}


def _c_kind(decl: str) -> str:
    """'ptr', 'i32', 'i64' or 'f32' of one C parameter or return
    declaration."""
    if "*" in decl:
        return "ptr"
    words = [w for w in re.findall(r"[A-Za-z_]\w*", decl) if w != "const"]
    # the last word is the parameter's name where there is one
    for w in words:
        if w in _INT32:
            return "i32"
        if w in _INT64:
            return "i64"
        if w in _FLOAT32:
            return "f32"
    raise AssertionError(f"unknown C type in {decl!r}")


def _ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or (isinstance(t, type)
                                and issubclass(t, ctypes._Pointer)):
        return "ptr"
    if t in (ctypes.c_int, ctypes.c_int32, ctypes.c_uint32):
        return "i32"
    if t in (ctypes.c_int64, ctypes.c_uint64):
        return "i64"
    if t is ctypes.c_float:
        return "f32"
    raise AssertionError(f"unknown ctypes type {t}")


def _extern_c_prototypes(source: str) -> dict:
    """{function: (return kind, [argument kinds])} of every function
    defined inside the source's ``extern "C" { ... }`` blocks."""
    source = re.sub(r"//[^\n]*", "", source)
    protos = {}
    for opening in re.finditer(r'extern\s+"C"\s*\{', source):
        depth, end = 1, opening.end()
        while depth:                      # the block's matching brace
            depth += {"{": 1, "}": -1}.get(source[end], 0)
            end += 1
        block = source[opening.end():end - 1]
        for ret, name, params in re.findall(
                r"([A-Za-z_][\w\s\*]*?)\s+(\w+)\s*\(([^)]*)\)\s*\{", block):
            params = params.strip()
            args = ([] if params in ("", "void")
                    else [_c_kind(p) for p in params.split(",")])
            protos[name] = (_c_kind(ret), args)
    return protos


@pytest.mark.parametrize("name", kernels.SOURCES)
def test_extern_c_prototypes_match_the_bindings(name):
    protos = _extern_c_prototypes((kernels.CSRC / f"{name}.cu").read_text())
    bound = kernels.SIGNATURES[name]
    assert sorted(protos) == sorted(bound), (name, sorted(protos))
    for fn, (restype, argtypes) in bound.items():
        ret, args = protos[fn]
        assert ret == _ctypes_kind(restype), (fn, ret, restype)
        assert args == [_ctypes_kind(t) for t in argtypes], (fn, args)


def test_the_parser_sees_a_mismatch():
    """A prototype with an argument too few, or one of another width, is
    told apart from its binding."""
    src = ('extern "C" {\n'
           "int gts_scan_i32(const void* const* ins, void* const* outs,\n"
           "                 int n_channels, int64_t m, void* status,\n"
           "                 void* counter, uint32_t ticket_base,\n"
           "                 uint32_t epoch, void* stream) {\n"
           "  return 0;\n}\n\n}  // extern \"C\"\n")
    want = [_ctypes_kind(t) for t in kernels.SIGNATURES["scan"]
            ["gts_scan_i32"][1]]
    assert _extern_c_prototypes(src)["gts_scan_i32"][1] == want
    fewer = src.replace("uint32_t epoch, ", "")
    assert _extern_c_prototypes(fewer)["gts_scan_i32"][1] != want
    wider = src.replace("int n_channels", "int64_t n_channels")
    assert _extern_c_prototypes(wider)["gts_scan_i32"][1] != want


def test_the_parser_tells_a_float_from_an_int():
    """A float argument (the projection's scale modifier) reads as one,
    and an int in its place is told apart from its binding."""
    src = ('extern "C" {\n'
           "int f(const float* x, int64_t n, float scale, void* stream) {\n"
           "  return 0;\n}\n\n}  // extern \"C\"\n")
    assert _extern_c_prototypes(src)["f"] == ("i32",
                                              ["ptr", "i64", "f32", "ptr"])
    assert _ctypes_kind(ctypes.c_float) == "f32"
    as_int = src.replace("float scale", "int scale")
    assert _extern_c_prototypes(as_int)["f"][1][2] == "i32"
