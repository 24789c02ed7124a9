"""The native runtime is compiled from the committed source at first use:
concurrent first users build it once and never see a partial library, a
changed source is rebuilt instead of a stale library loaded, a failed build
raises, and without a compiler the numpy fallbacks are used."""

import ctypes
import os
import shutil
import subprocess
import sys

import pytest

from jn_cuclark_tpu.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BUILD = """
import sys
from jn_cuclark_tpu.utils import native
native.SOURCE, native.BUILD_DIR = sys.argv[1], sys.argv[2]
print(native.build())
"""


def _source(tmp_path, value):
    src = tmp_path / "clark_native.cpp"
    src.write_text(f'extern "C" int answer() {{ return {value}; }}\n')
    return src


def _answer(path):
    lib = ctypes.CDLL(path)
    lib.answer.restype = ctypes.c_int
    return lib.answer()


def test_concurrent_first_builds_share_one_library(tmp_path):
    src = _source(tmp_path, 41)
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD, str(src), str(build_dir)],
            stdout=subprocess.PIPE, text=True, env=env,
        )
        for _ in range(4)
    ]
    paths = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1
    (path,) = paths
    libs = [f for f in os.listdir(build_dir) if not f.startswith(".")]
    assert libs == [os.path.basename(path)]  # no temporary left behind
    assert _answer(path) == 41


def test_changed_source_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SOURCE", str(_source(tmp_path, 1)))
    first = native.build()
    assert native.build() == first  # built once, then found
    _source(tmp_path, 2)
    second = native.build()
    assert second != first and _answer(second) == 2


def test_no_compiler_means_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SOURCE", str(_source(tmp_path, 3)))
    assert native.build("no-such-c++-compiler") is None
    assert not (tmp_path / "build").exists()


def test_compiler_error_is_raised(tmp_path, monkeypatch):
    """A compiler that cannot build the source raises with its own error;
    no other build is tried and nothing is left in the build directory."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "clark_native.cpp"
    src.write_text('extern "C" int answer() { return missing_name; }\n')
    monkeypatch.setattr(native, "SOURCE", str(src))
    with pytest.raises(RuntimeError, match="missing_name"):
        native.build()
    assert [f for f in os.listdir(tmp_path / "build")
            if not f.startswith(".")] == []


def test_build_is_keyed_on_the_host_cpu(tmp_path, monkeypatch):
    """-march=native code is never loaded on a CPU it was not built for."""
    monkeypatch.setattr(native, "SOURCE", str(_source(tmp_path, 4)))
    monkeypatch.setattr(native, "_host_cpu", lambda: b"flags : sse2")
    a = native.library_path()
    monkeypatch.setattr(native, "_host_cpu", lambda: b"flags : sse2 avx512f")
    assert native.library_path() != a


def test_runtime_reports_its_threads():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="3")
    out = subprocess.run(
        [sys.executable, "-c",
         "from jn_cuclark_tpu.utils import native; print(native.threads())"],
        env=env, capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    assert out.strip() == "3"


def test_compiler_without_openmp_is_passed_over(tmp_path, monkeypatch):
    """A compiler whose toolchain has no libgomp.spec, named by CXX or
    first on PATH, is passed over for a g++ that has OpenMP; with no such
    g++ it is still chosen, so its build raises with its own error."""
    real = shutil.which("g++")
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho libgomp.spec\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    assert native.find_cxx() == real
    monkeypatch.setenv("CXX", real)
    assert native.find_cxx() == real
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setenv("PATH", str(fake.parent))
    assert native.find_cxx() == str(fake)
