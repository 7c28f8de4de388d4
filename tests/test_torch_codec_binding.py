"""The ctypes binding of the CUDA codec against the C prototypes it binds.

``load_library`` declares each entry's argument types from
``topk_compress.SIGNATURES``.  A table that disagrees with the prototype in
``csrc/topk_codec.cu`` is not an error ctypes can see: a pointer passed
where the C side reads an ``int`` is cut to 32 bits, and arguments shift.
So the table is held here against the ``extern "C"`` prototypes, parsed
from the source, on the CPU and without building anything.
"""
import ctypes
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import topk_compress as tk  # noqa: E402

SOURCE = (pathlib.Path(tk.__file__).resolve().parent / "csrc"
          / "topk_codec.cu")


def _prototypes():
    """{name: (return type, [argument types])} of the ``extern "C"`` block."""
    text = SOURCE.read_text()
    block = text[text.index('extern "C" {'):]
    block = re.sub(r"//[^\n]*", "", block)
    protos = {}
    for ret, name, args in re.findall(
            r"\b(int|void)\s+(\w+)\s*\(([^)]*)\)\s*\{", block):
        # each argument's type: everything before its name
        protos[name] = (ret, [re.sub(r"\w+\s*$", "", a).strip()
                              for a in args.split(",")])
    return protos


def _kind(c_type):
    """The ctypes kind a C argument type needs."""
    if "*" in c_type:
        return ctypes.c_void_p
    return {"long long": ctypes.c_longlong, "int": ctypes.c_int}[
        c_type.replace("const", "").strip()]


def test_every_c_entry_is_bound():
    assert sorted(_prototypes()) == sorted(tk.SIGNATURES)


@pytest.mark.parametrize("name", sorted(tk.SIGNATURES))
def test_signature_matches_the_c_prototype(name):
    ret, args = _prototypes()[name]
    assert ret == "int"
    assert list(tk.SIGNATURES[name]) == [_kind(a) for a in args]


def test_prototype_parser_reads_kinds():
    """The parser itself: pointers, ``long long`` and ``int`` apart."""
    ret, args = _prototypes()["topk_decode"]
    assert [_kind(a) for a in args] == [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
