"""The port's kernel build cache: a library's name follows its source and
the nvcc flags, so a change to either builds a new one (no nvcc needed)."""

import ctypes
import re

from siddhi_tpu_torch.kernels import build


def test_library_name_follows_source_and_flags(monkeypatch):
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert len(set(before.values())) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR for p in before.values())
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    for n in build.SOURCES:
        assert build.library_path(n) != before[n]
    monkeypatch.undo()
    assert {n: build.library_path(n) for n in build.SOURCES} == before


def c_signatures(source: str) -> dict:
    """{function: (restype, argtypes)} of every ``extern "C"`` function
    of a CUDA source, as ctypes types: ``void*`` (any pointer) is
    ``c_void_p``, ``int`` is ``c_int``."""
    text = re.sub(r"//[^\n]*", "", source)
    out = {}
    for ret, name, params in re.findall(
            r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', text):
        args = []
        for p in (p.strip() for p in params.split(",") if p.strip()):
            if "*" in p:
                args.append(ctypes.c_void_p)
            else:
                assert p.split()[:-1] in (["int"], ["const", "int"]), p
                args.append(ctypes.c_int)
        assert ret == "int", (name, ret)
        out[name] = (ctypes.c_int, tuple(args))
    return out


def test_prototype_table_matches_every_extern_c_signature():
    """``build.PROTOTYPES`` names every ``extern "C"`` function of every
    ``csrc/*.cu`` and no other, with ``c_void_p`` for each pointer (a
    plain int would be cut to 32 bits) and ``c_int`` for each int,
    position by position."""
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sorted(build.PROTOTYPES) == sources == sorted(build.SOURCES)
    for name in sources:
        want = c_signatures((build.CSRC / f"{name}.cu").read_text())
        got = {fn: (res, tuple(args))
               for fn, (res, args) in build.PROTOTYPES[name].items()}
        assert got == want, name


def test_no_wrapper_sets_a_prototype_per_call():
    """Prototypes are set once, in ``build.load``; the kernel wrappers
    fetch their function through ``build.entry``."""
    for path in build.CSRC.parent.glob("*.py"):
        if path.name == "build.py":
            continue
        text = path.read_text()
        assert not re.search(r"\.(argtypes|restype)\b", text), path.name


def test_bank_scatter_plan_matches_the_c_struct():
    """``bank_scatter._Plan`` is ``struct Plan`` of ``csrc/bank_scatter.cu``
    field for field: same names, ``void*`` as ``c_void_p`` and ``int`` as
    ``c_int``, in order (the kernel reads it at the address the wrapper
    passes)."""
    from siddhi_tpu_torch.kernels import bank_scatter

    text = (build.CSRC / "bank_scatter.cu").read_text()
    body = re.search(r"struct Plan \{([^}]*)\};", text).group(1)
    want = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        *typ, name = decl.split()
        want.append((name.lstrip("*"), ctypes.c_void_p if "*" in decl
                     else {"int": ctypes.c_int}[" ".join(typ)]))
    assert bank_scatter._Plan._fields_ == want
