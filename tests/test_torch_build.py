"""The port's kernel build cache: a library's name follows its source and
the nvcc flags, so a change to either builds a new one (no nvcc needed)."""

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
