"""tests/test_fortran_abi.py's conformance checks applied to the port's
embedded library (iterative_solver_torch/bindings/build_embedded.py): every
prototype of the unchanged header include/iterative_solver_c.h has an
``@ffi.def_extern`` implementation there, its cffi declarations are the
header's prototypes one for one (name, arity, each argument's base type and
by-value or pointer, return type), and every ``bind(C)`` interface of the
F90 module matches those declarations, so a Fortran program links against the
port's library as against the JAX package's."""

import ast
import os
import re

from test_fortran_abi import F90, HEADER, parse_c_header, parse_f90_interfaces
from torch_testing import worker_share_of_cores  # noqa: F401 (autouse: this module's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "iterative_solver_torch", "bindings", "build_embedded.py")
JAX = os.path.join(REPO, "iterative_solver_tpu", "bindings", "build_embedded.py")


def _decls(path):
    """The module's DECLS string, read with ast (no import of either
    package)."""
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "DECLS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no DECLS")


def _parse_decls(text, tmp_path):
    path = tmp_path / "decls.h"
    path.write_text(text)
    return parse_c_header(str(path))


def test_every_header_symbol_is_implemented_in_the_ports_library():
    hdr = parse_c_header(HEADER)
    with open(PORT) as fh:
        src = fh.read()
    implemented = set(re.findall(r"@ffi\.def_extern\(\)\s*\ndef\s+(\w+)\s*\(", src))
    missing = sorted(set(hdr) - implemented)
    assert not missing, f"no @ffi.def_extern in the port's build_embedded.py for {missing}"
    extra = sorted(implemented - set(hdr))
    assert not extra, f"def_extern names absent from the header: {extra}"


def test_port_declarations_are_the_header_prototypes(tmp_path):
    hdr = parse_c_header(HEADER)
    port = _parse_decls(_decls(PORT), tmp_path)
    assert port == hdr
    # and the JAX package's, character for character
    assert _decls(PORT) == _decls(JAX)
    # every bind(C) interface of the F90 module is one of the port's
    # declarations, argument for argument
    f90 = parse_f90_interfaces(F90)
    assert len(f90) >= 20
    assert not sorted(set(f90) - set(port))
    for name, sig in f90.items():
        assert (sig["args"], sig["ret"]) == (port[name]["args"], port[name]["ret"]), name


def test_port_library_is_named_apart_from_the_jax_package_s():
    src = open(PORT).read()
    assert '"iterative_solver_torch_c"' in src
    assert "libiterative_solver_torch_c" in src
    assert "iterative_solver_tpu_c" not in src
