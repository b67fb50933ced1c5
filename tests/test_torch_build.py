"""Where the port's CUDA libraries are built (``ops/cuda/build.py``), on
the CPU: a library's path follows the bytes of its source and of the
headers the sources share (``csrc/*.cuh``), so an edited file is never
served by a stale library.  Edits are made on a copy of ``csrc``.
"""

import shutil

import pytest

from gfe_mamba_torch.ops.cuda import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def _paths():
    return {name: build.library_path(name) for name in build.SOURCES}


def test_library_path_follows_the_shared_headers(csrc):
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    before = _paths()
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    after = _paths()
    assert all(after[name] != before[name] for name in build.SOURCES)
    assert _paths() == after


def test_library_path_follows_its_own_source(csrc):
    before = _paths()
    source = csrc / "conv3d.cu"
    source.write_bytes(source.read_bytes() + b"\n// edited\n")
    after = _paths()
    assert after["conv3d"] != before["conv3d"]
    assert all(after[name] == before[name]
               for name in build.SOURCES if name != "conv3d")
