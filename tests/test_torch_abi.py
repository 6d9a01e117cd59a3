"""The ctypes side of each CUDA library against its C side, on the CPU.

Each ``frei_tpu_torch/csrc/<name>.cu`` exports plain ``extern "C"``
launchers that the wrapper in ``frei_tpu_torch/ops/<name>_cuda.py``
loads with ctypes and types from its ``SIGNATURES``.  Nothing checks the
two against each other at a call: a parameter added on one side only
shifts every later argument.  This reads the launchers' parameter lists
from the sources (for ``sweep.cu``, the ``FREI_SWEEP_LAUNCHER`` macro's,
one list for the four names it is invoked with) and classifies each
parameter as a pointer, ``int``, 64-bit integer or ``double``, in order,
against the ``argtypes``; where a launcher takes an argument struct
(``IterArgs``, ``ChemArgs``) its fields, names, order and C types,
against the ``ctypes.Structure`` that mirrors it.  No compiler, no card.
"""

import ctypes
import importlib
import re

import pytest

pytest.importorskip("torch")

from frei_tpu_torch.ops.cuda_build import CSRC  # noqa: E402

#: kernel source -> (wrapper module, mirrored argument struct or None)
CASES = {
    "sweep": ("sweep_cuda", None),
    "iteration": ("iteration_cuda", ("IterArgs", "_IterArgs")),
    "kappa": ("kappa_cuda", None),
    "rebin": ("rebin_cuda", None),
    "chemistry": ("chemistry_cuda", ("ChemArgs", "_ChemArgs")),
}


def _code(name):
    """The source without comments, macro line continuations joined."""
    text = (CSRC / f"{name}.cu").read_text()
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return text.replace("\\\n", " ")


def _c_kind(decl):
    """Kind of one C declaration (its type and name, or type alone)."""
    if "*" in decl:
        return "pointer"
    words = decl.replace("const", " ").split()
    base = words[0]
    kinds = {"int": "int", "int32_t": "int", "int64_t": "int64",
             "double": "double"}
    if base not in kinds:
        raise AssertionError(f"unclassified C type in {decl!r}")
    return kinds[base]


def _ctypes_kind(t):
    """Kind of one ctypes argument or field type."""
    if t is ctypes.c_void_p or (isinstance(t, type)
                                and issubclass(t, ctypes._Pointer)):
        return "pointer"
    if t is ctypes.c_double:
        return "double"
    if t in (ctypes.c_int, ctypes.c_int32):
        return "int"
    if t in (ctypes.c_int64, ctypes.c_longlong):
        return "int64"
    raise AssertionError(f"unclassified ctypes type {t!r}")


def _launchers(code):
    """{name: [kind of each parameter]} of the extern "C" launchers, with
    those defined by a macro expanded for each of its invocations."""
    found = {}
    for name, params in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                                   code):
        found[name] = [_c_kind(p) for p in params.split(",")]
    for macro, first in re.findall(r"#define\s+(\w+)\s*\(\s*(\w+)", code):
        if first not in found:
            continue
        kinds = found.pop(first)
        for inst in re.findall(rf"^\s*{macro}\s*\(\s*(\w+)\s*,", code,
                               flags=re.M):
            found[inst] = kinds
    return found


def _struct_fields(code, struct):
    """[(name, kind)] of ``struct <struct>``'s fields, in order."""
    body = re.search(rf"struct\s+{struct}\s*\{{(.*?)\}};", code, re.S)
    assert body, f"struct {struct} not found"
    fields = []
    for decl in body[1].split(";"):
        decl = decl.strip()
        if not decl:
            continue
        first, *more = [d.strip() for d in decl.split(",")]
        base, name = re.match(r"(.*?)(\w+)$", first).groups()
        fields.append((name, _c_kind(base)))
        for d in more:
            fields.append((d.lstrip("* "), _c_kind(base + d)))
    return fields


@pytest.mark.parametrize("name", sorted(CASES))
def test_ctypes_mirrors_the_c_launchers(name):
    """Every launcher's ``argtypes`` classify, parameter by parameter,
    as its C parameters do; the launchers are exactly the names in
    ``SIGNATURES``; a mirrored struct has the C struct's fields, names
    and kinds in order."""
    module, struct = CASES[name]
    mod = importlib.import_module(f"frei_tpu_torch.ops.{module}")
    code = _code(name)
    launchers = _launchers(code)
    assert sorted(launchers) == sorted(mod.SIGNATURES)
    for fn, kinds in launchers.items():
        got = [_ctypes_kind(t) for t in mod.SIGNATURES[fn]]
        assert got == kinds, f"{fn}: ctypes {got} against C {kinds}"
    if struct is not None:
        c_name, py_name = struct
        mirror = [(f, _ctypes_kind(t))
                  for f, t in getattr(mod, py_name)._fields_]
        assert mirror == _struct_fields(code, c_name)
