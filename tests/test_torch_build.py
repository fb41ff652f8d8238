"""The cache key of the port's kernel builds: a library is named by the
hash of its source and of every shared header under ``csrc/``, so an
edit to either builds it anew and a stale library is never loaded.
Nothing here compiles: ``_target`` only names the library."""

import re

import pytest

from chainermn_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "h.cuh"\nint k;\n')
    (src / "h.cuh").write_text("// header v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_header_bytes_change_the_target(csrc):
    src, first = _build._target("k")
    assert src == csrc / "k.cu" and first.suffix == ".so"
    (csrc / "h.cuh").write_text("// header v2\n")
    second = _build._target("k")[1]
    assert second != first
    (csrc / "h.cuh").write_text("// header v1\n")
    assert _build._target("k")[1] == first      # the same bytes, the same key


def test_source_bytes_and_new_headers_change_the_target(csrc):
    first = _build._target("k")[1]
    (csrc / "k.cu").write_text('#include "h.cuh"\nint k2;\n')
    second = _build._target("k")[1]
    (csrc / "g.cuh").write_text("// another header\n")
    third = _build._target("k")[1]
    assert len({first, second, third}) == 3


def test_every_included_header_is_hashed():
    # the port's sources include their shared headers from csrc/ by name
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "hopper.cuh" in headers
    for src in _build.CSRC.glob("*.cu"):
        local = set(re.findall(r'#include "([^"]+)"', src.read_text()))
        assert local and local <= headers, (src.name, local)
