"""The CUDA build's cache key (`ops/_build.py::library_path`): a kernel's
library is rebuilt when its source, a local header it includes or its
flags change, and only then. CPU only: nothing is compiled."""

import pytest

from pharmaforge_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setitem(_build.KERNEL_FLAGS, "k", ())
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "tile.cuh"\n'
                                   'extern "C" int k() { return tile(); }\n')
    (tmp_path / "tile.cuh").write_text('#pragma once\n#include "inner.cuh"\n'
                                       'inline int tile() { return inner(); }\n')
    (tmp_path / "inner.cuh").write_text('#pragma once\n'
                                        'inline int inner() { return 1; }\n')
    (tmp_path / "other.cuh").write_text('inline int other() { return 2; }\n')
    return tmp_path


@pytest.mark.parametrize("edit,rebuilds", [
    ("k.cu", True),          # the source itself
    ("tile.cuh", True),      # a header it includes
    ("inner.cuh", True),     # a header included through another header
    ("other.cuh", False),    # a header it does not include
])
def test_library_path_follows_included_headers(csrc, edit, rebuilds):
    before = _build.library_path("k")
    assert before == _build.library_path("k")
    path = csrc / edit
    path.write_text(path.read_text() + "// edited\n")
    after = _build.library_path("k")
    assert after.name.startswith("k-") and after.suffix == ".so"
    assert (after != before) == rebuilds


def test_local_headers_lists_each_header_once(csrc):
    (csrc / "k.cu").write_text('#include "tile.cuh"\n#include "inner.cuh"\n'
                               '#include "missing.cuh"\n')
    assert _build.local_headers(csrc / "k.cu") == [csrc / "tile.cuh",
                                                  csrc / "inner.cuh"]


def test_library_path_follows_flags(csrc, monkeypatch):
    before = _build.library_path("k")
    monkeypatch.setitem(_build.KERNEL_FLAGS, "k", ("--fmad=false",))
    assert _build.library_path("k") != before


def test_pp_message_key_covers_its_header():
    headers = _build.local_headers(_build.CSRC_DIR / "pp_message.cu")
    assert [h.name for h in headers] == ["mma_bf16.cuh"]
