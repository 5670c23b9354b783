"""The CUDA build of the port (``kernels/_build.py``), checked where there is
no compiler: every C launcher the sources define has a ctypes signature that
matches its parameter list, so no launch passes a pointer as a 32-bit int."""
import ctypes
import re

import pytest

from repro_torch.kernels import _build

_CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
          "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _launchers():
    """(source stem, launcher name, C parameter types) of each csrc/*.cu."""
    out = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (launch_\w+)\(([^)]*)\)',
                                       src.read_text()):
            types = [re.sub(r"\s+\w+$", "", p.strip()) for p in params.split(",")]
            out.append((src.stem, name, types))
    return out


def test_every_source_has_one_launcher():
    stems = [stem for stem, _, _ in _launchers()]
    assert sorted(stems) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert len(set(stems)) == len(stems)


@pytest.mark.parametrize("stem,name,types", _launchers(), ids=lambda v: str(v)[:24])
def test_launcher_has_a_matching_signature(stem, name, types):
    assert name == f"launch_{stem}"
    assert stem in _build._SIGNATURES, f"{name} has no entry in _build._SIGNATURES"
    assert [_CTYPE[t] for t in types] == _build._SIGNATURES[stem]


def test_headers_are_part_of_the_build_hash(tmp_path, monkeypatch):
    """An edited header (csrc/*.cuh) rebuilds every library."""
    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    hdr = tmp_path / "h.cuh"
    hdr.write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest([src])
    hdr.write_text("// two")
    assert _build._digest([src]) != first
