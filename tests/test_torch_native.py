"""The port's host C library (grendel_tpu_torch/native/) against the JAX
package and its own bindings.

  * the C ground-truth pack (``native.pack_gt_rows``) against the JAX
    package's numpy ``grendel_tpu.parallel.division.pack_gt_rows`` on
    tests/test_native.py's three shapes and its missing-image case;
  * the build: two processes that build the library at once both load
    it; a source that does not compile raises with the compiler's output;
    no compiler raises;
  * the C interface: each exported function of ``native/*.c`` parsed from
    the source and held to ``native.SIGNATURES`` (the same functions, the
    same number of arguments, each of the same kind), as
    tests/test_torch_kernels_abi.py holds ``csrc/*.cu`` (the resize
    kernel's ``csrc/resize.cu`` among them) to ``kernels.SIGNATURES``.

Nothing here skips: without a C compiler these tests fail.
"""

import ctypes
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from grendel_tpu.parallel.division import pack_gt_rows as j_pack
from grendel_tpu.testing import make_test_camera
from grendel_tpu_torch import native
from grendel_tpu_torch.parallel.division import pack_gt_rows as t_pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cams(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    cams = []
    for i in range(b):
        c = make_test_camera(w, h, angle=0.1 * i)
        c.gt_image_u8 = rng.integers(0, 255, (3, h, w), np.uint8)
        cams.append(c)
    return cams


@pytest.mark.parametrize("h,w,tile_h,d,bsz", [
    (48, 64, 16, 4, 2),      # whole tile rows
    (40, 64, 16, 3, 2),      # 2.5 tile rows: padding in the last
    (64, 48, 16, 8, 1),
])
def test_native_pack_matches_jax(h, w, tile_h, d, bsz):
    cams = _cams(bsz, h, w)
    total = bsz * -(-h // tile_h)
    rng = np.random.default_rng(1)
    cuts = np.sort(rng.integers(0, total + 1, d - 1))
    pos = np.concatenate([[0], cuts, [total]]).astype(np.int32)
    max_rows = int(max(np.diff(pos).max(), 1)) + 1
    want = j_pack(cams, pos, d, max_rows, tile_h, h, w)
    got = native.pack_gt_rows(cams, pos, d, max_rows, tile_h, h, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, t_pack(cams, pos, d, max_rows, tile_h, h, w))
    # into a given buffer holding other bytes, on one thread and on more
    # threads than devices, and with one device's rows cut at max_rows
    for n_threads in (1, 3, 64):
        out = np.full_like(want, 7)
        native.pack_gt_rows(cams, pos, d, max_rows, tile_h, h, w, out=out,
                            n_threads=n_threads)
        np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        native.pack_gt_rows(cams, pos, d, 1, tile_h, h, w),
        j_pack(cams, pos, d, 1, tile_h, h, w))


def test_native_pack_handles_missing_images():
    cams = _cams(2, 32, 32)
    pos = np.array([0, 2, 4], np.int32)
    got = native.pack_gt_rows(None, pos, 2, 3, 16, 32, 32,
                              gt_override=[cams[0].gt_image_u8, None])
    cams[1].gt_image_u8 = None
    np.testing.assert_array_equal(got, j_pack(cams, pos, 2, 3, 16, 32, 32))
    assert not got[1].any()


_BUILD_AT_ONCE = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    from grendel_tpu_torch import native
    native.BUILD_DIR = Path(sys.argv[2])
    while not os.path.exists(sys.argv[3]):
        time.sleep(0.001)
    raw = np.array([[1, 5, 6, 7]], np.uint8)     # Sub, 1 byte a pixel
    assert native.png_unfilter(raw, 1).tolist() == [[5, 11, 18]]
    print(native.library_path())
""")


def test_two_processes_build_at_once(tmp_path):
    """Two processes that find no library build it at once: each compiles
    to its own temporary file and moves it into place, so both load a
    whole library and the directory holds one."""
    go = tmp_path / "go"
    build = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AT_ONCE, ROOT, str(build), str(go)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    go.write_text("")
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs = sorted(os.listdir(build))
    assert len(libs) == 1 and libs[0].endswith(".so"), libs
    assert {out.strip() for out, _ in outs} == {str(build / libs[0])}


def test_a_build_failure_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.c").write_text("int gtn_broken(void) { return 0 }\n")
    monkeypatch.setattr(native, "NATIVE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="broken.c"):
        native.load()
    assert not [p for p in (tmp_path / "build").iterdir()]
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.load()


_INT32 = {"int", "int32_t", "uint32_t", "unsigned"}
_INT64 = {"int64_t", "uint64_t", "size_t"}


def _c_kind(decl: str) -> str:
    """'ptr', 'i32' or 'i64' of one C parameter or return declaration."""
    if "*" in decl:
        return "ptr"
    for w in re.findall(r"[A-Za-z_]\w*", decl):
        if w in _INT32:
            return "i32"
        if w in _INT64:
            return "i64"
    raise AssertionError(f"unknown C type in {decl!r}")


def _ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or (isinstance(t, type)
                                and issubclass(t, ctypes._Pointer)):
        return "ptr"
    if t in (ctypes.c_int, ctypes.c_int32, ctypes.c_uint32):
        return "i32"
    if t in (ctypes.c_int64, ctypes.c_uint64):
        return "i64"
    raise AssertionError(f"unknown ctypes type {t}")


def _exported_prototypes(source: str) -> dict:
    """{function: (return kind, [argument kinds])} of every function
    defined at file scope without ``static``."""
    source = re.sub(r"/\*.*?\*/", "", source, flags=re.S)
    protos = {}
    for ret, name, params in re.findall(
            r"^([A-Za-z_][\w \*]*?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{", source,
            flags=re.M):
        if re.search(r"\bstatic\b", ret):
            continue
        args = ([] if params.strip() in ("", "void")
                else [_c_kind(p) for p in params.split(",")])
        protos[name] = (_c_kind(ret), args)
    return protos


@pytest.mark.parametrize("name", sorted(native.SIGNATURES))
def test_c_prototypes_match_the_bindings(name):
    assert sorted(p.stem for p in native.sources()) == sorted(
        native.SIGNATURES)
    protos = _exported_prototypes((native.NATIVE / f"{name}.c").read_text())
    bound = native.SIGNATURES[name]
    assert sorted(protos) == sorted(bound), (name, sorted(protos))
    for fn, (restype, argtypes) in bound.items():
        ret, args = protos[fn]
        assert ret == _ctypes_kind(restype), (fn, ret, restype)
        assert args == [_ctypes_kind(t) for t in argtypes], (fn, args)
        getattr(native.load(), fn)      # exported under that name


def test_the_parser_sees_a_mismatch():
    """An argument too few, one of another width, or a static helper is
    told apart."""
    src = ("static int helper(int a) { return a; }\n"
           "/* a comment */\n"
           "int gtn_png_unfilter(const uint8_t *raw, uint8_t *out,\n"
           "                     int32_t height, int64_t row_bytes,\n"
           "                     int32_t bpp)\n{\n    return 0;\n}\n")
    want = [_ctypes_kind(t) for t in native.SIGNATURES["png_unfilter"]
            ["gtn_png_unfilter"][1]]
    protos = _exported_prototypes(src)
    assert sorted(protos) == ["gtn_png_unfilter"]
    assert protos["gtn_png_unfilter"][1] == want
    fewer = src.replace("int32_t height, ", "")
    assert _exported_prototypes(fewer)["gtn_png_unfilter"][1] != want
    wider = src.replace("int32_t bpp", "int64_t bpp")
    assert _exported_prototypes(wider)["gtn_png_unfilter"][1] != want
