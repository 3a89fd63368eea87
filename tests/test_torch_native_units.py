"""The C++ core's unit suite, fuzz smoke and replay smoke, built by the port.

tpu_pruner_torch.native.ensure_built() compiles native/tests/test_*.cpp
into the tpupruner_tests runner and fuzz_main.cpp into tpupruner_fuzz,
linked against the library's objects in build/torch_native/; both run here
as tests/test_native_units.py runs the reference's build of them.
"""

import os
import subprocess
import sys

import pytest

from tpu_pruner_torch import native


@pytest.fixture(scope="module")
def built():
    native.ensure_built()
    return native


def test_native_unit_suite(built):
    proc = subprocess.run([str(native.TESTS_PATH)], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, f"native tests failed:\n{proc.stdout}{proc.stderr}"
    assert ", 0 failed" in proc.stdout


def test_fuzz_smoke(built):
    """Deterministic mutation fuzz over the untrusted-input surfaces (JSON
    parse/dump round-trip, Prometheus decode, timestamp parse)."""
    proc = subprocess.run([str(native.BUILD_DIR / "tpupruner_fuzz"), "20000"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "fuzz ok: 20000 iterations" in proc.stderr


def test_runners_are_the_ports_own(built):
    build_dir = native.REPO_ROOT / "build" / "torch_native"
    assert native.TESTS_PATH == build_dir / "tpupruner_tests"
    for path in (native.TESTS_PATH, build_dir / "tpupruner_fuzz", native.DAEMON_PATH):
        assert os.access(path, os.X_OK), path
    assert not native._stale(units=True) and not native._stale(units=False)


def test_replay_smoke_loads_neither_jax_nor_reference(built):
    """The replay smoke (two daemon cycles against the port's fakes, then
    the port's analyze --replay on each capsule) in a process of its own,
    which loads no module of jax or of tpu_pruner: what the card's machine,
    which has JAX installed, must show too."""
    code = ("import sys\n"
            "from tpu_pruner_torch.testing import replay_smoke\n"
            "rc = replay_smoke.main()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.startswith('jax') or m.split('.')[0] == 'tpu_pruner')\n"
            "print('BAD=' + ','.join(bad))\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=native.REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "BAD="


def test_daemon_path_honours_env(tmp_path):
    """TP_DAEMON_PATH swaps the daemon the hermetic tiers run; the build's
    own outputs stay where they are."""
    alt = tmp_path / "tpu-pruner-asan"
    code = ("from tpu_pruner_torch import native; "
            "print(native.DAEMON_PATH); print(native._outputs(False)[1])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "TP_DAEMON_PATH": str(alt)},
                         cwd=native.REPO_ROOT, check=True, timeout=120).stdout.split()
    assert out == [str(alt), str(native.BUILD_DIR / "tpu-pruner")]


@pytest.fixture()
def scratch_tree(tmp_path, monkeypatch):
    """A tiny native tree with one test source and a fuzz main, built into a
    directory of the test's own."""
    src = tmp_path / "native"
    (src / "include").mkdir(parents=True)
    (src / "src").mkdir()
    (src / "tests").mkdir()
    (src / "src" / "core.cpp").write_text('extern "C" int tp_answer() { return 42; }\n')
    (src / "src" / "main.cpp").write_text("int main() { return 0; }\n")
    (src / "tests" / "test_main.cpp").write_text(
        'extern "C" int tp_answer();\n#include <cstdio>\n'
        'int main() { std::printf("1 tests, %d failed\\n", tp_answer() != 42); }\n')
    (src / "tests" / "fuzz_main.cpp").write_text("int main() { return 0; }\n")
    out = tmp_path / "build"
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", out)
    monkeypatch.setattr(native, "LIB_PATH", out / "libtpupruner.so")
    monkeypatch.setattr(native, "DAEMON_PATH", out / "tpu-pruner")
    monkeypatch.setattr(native, "TESTS_PATH", out / "tpupruner_tests")
    return src, out


def test_build_leaves_the_runners_to_ensure_built(scratch_tree):
    """build() links only the library and the daemon; ensure_built() adds
    the runners from the same library objects, and force recompiles all."""
    src, out = scratch_tree
    native.build()
    assert sorted(p.name for p in (out / "obj").iterdir()) == ["core.o", "main.o"]
    assert not (out / "tpupruner_tests").exists() and native._stale(units=True)
    native.ensure_built()
    assert sorted(p.name for p in (out / "obj").iterdir()) == [
        "core.o", "fuzz_main.o", "main.o", "tests_test_main.o"]
    run = subprocess.run([str(out / "tpupruner_tests")], capture_output=True, text=True,
                         timeout=60)
    assert run.stdout == "1 tests, 0 failed\n"
    assert (out / "tpupruner_fuzz").exists() and not native._stale(units=True)
    core_built = os.path.getmtime(out / "obj" / "core.o")
    native.ensure_built()
    assert os.path.getmtime(out / "obj" / "core.o") == core_built
    native.ensure_built(force=True)
    assert os.path.getmtime(out / "obj" / "core.o") > core_built


def test_a_newer_test_source_rebuilds_the_runner(scratch_tree):
    src, out = scratch_tree
    native.ensure_built()
    built = os.path.getmtime(out / "tpupruner_tests")
    later = built + 10
    os.utime(src / "tests" / "test_main.cpp", (later, later))
    assert native._stale(units=True)
    native.ensure_built()
    assert os.path.getmtime(out / "tpupruner_tests") > built
