"""ctypes bindings over the tpu-pruner C++ core, for the port's report modes.

``analyze --replay``/``--what-if``, ``--gym`` and ``--capacity-report``
re-run the daemon's own decision, gym and capacity code, which lives in
the C++ core (``native/src``). This module builds that core with ``g++``
into ``build/torch_native/`` at first use and binds the four JSON-in /
JSON-out functions those modes need: ``replay_cycle``, ``gym_simulate``,
``capacity_report`` and ``capacity_build``. It is the port's own copy of
that part of ``tpu_pruner/native.py``, and imports nothing of it.

Importing this module builds nothing; ``load()`` does.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import json
import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "torch_native"
LIB_PATH = BUILD_DIR / "libtpupruner.so"
DAEMON_PATH = BUILD_DIR / "tpu-pruner"

# The C API functions bound here (native/src/capi.cpp); each takes a JSON
# string and returns a heap string released with tp_free.
_FUNCTIONS = ("tp_replay_cycle", "tp_gym_simulate", "tp_capacity_report",
              "tp_capacity_build")

# The direct-build flags of the reference's g++ build, plus
# `-include optional`: native/include/tpupruner/json.hpp:216-217 uses
# std::optional without including <optional>, which compiles only where
# another standard header happens to pull it in (g++ 12's do not). The fix
# belongs in json.hpp, which predates the port and is not edited by it.
CXXFLAGS = ("-std=c++20", "-O2", "-g", "-fPIC", "-Wall", "-Wextra",
            '-DTP_VERSION="0.1.0"', '-DTP_GIT_REV="nocmake"',
            "-include", "optional", "-I", str(NATIVE_DIR / "include"))

_lib = None


def _newest_mtime(tree: Path) -> float:
    newest = 0.0
    for root, _dirs, files in os.walk(tree):
        for f in files:
            if f.endswith((".cpp", ".hpp", ".txt")):
                newest = max(newest, os.path.getmtime(os.path.join(root, f)))
    return newest


def _stale() -> bool:
    if not (LIB_PATH.exists() and DAEMON_PATH.exists()):
        return True
    built = min(os.path.getmtime(LIB_PATH), os.path.getmtime(DAEMON_PATH))
    return built < _newest_mtime(NATIVE_DIR)


def _run(step: str, cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native {step} failed:\n{proc.stdout}\n{proc.stderr}")


def build() -> Path:
    """Compile ``native/src/*.cpp`` into ``build/torch_native/`` if any file
    under ``native/`` is newer than the library; returns ``LIB_PATH``.

    Links ``libtpupruner.so`` from every object but ``main.o``, and the
    ``tpu-pruner`` daemon from ``main.o`` and the same objects. Compiles run
    in parallel, under an exclusive lock on ``build/torch_native/.lock``
    held for the whole build, so concurrent processes build once. A failed
    compile or link raises ``RuntimeError`` with the compiler's output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:  # closing it unlocks
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            _compile_and_link()
    return LIB_PATH


def _compile_and_link() -> None:
    cxx = os.environ.get("CXX", "g++")
    obj_dir = BUILD_DIR / "obj"
    obj_dir.mkdir(exist_ok=True)
    sources = sorted((NATIVE_DIR / "src").glob("*.cpp"))
    with concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as ex:
        futures = [ex.submit(_run, f"compile {src.name}",
                             [cxx, *CXXFLAGS, "-c", str(src),
                              "-o", str(obj_dir / (src.stem + ".o"))])
                   for src in sources]
        for future in futures:
            future.result()
    lib_objs = [str(obj_dir / (src.stem + ".o")) for src in sources
                if src.stem != "main"]
    # Link to temporary names and rename, so a reader never sees half a file.
    for step, target, objs, extra in (
            ("link libtpupruner.so", LIB_PATH, lib_objs, ["-shared"]),
            ("link tpu-pruner", DAEMON_PATH, [str(obj_dir / "main.o"), *lib_objs], [])):
        tmp = target.with_name(target.name + ".tmp")
        _run(step, [cxx, *extra, *objs, "-o", str(tmp), "-ldl", "-lpthread"])
        os.replace(tmp, target)


def load() -> ctypes.CDLL:
    """Build if needed, then load ``LIB_PATH`` once per process."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.tp_free.argtypes = [ctypes.c_void_p]
    lib.tp_free.restype = None
    for fn in _FUNCTIONS:
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_char_p]
        f.restype = ctypes.c_void_p
    _lib = lib
    return lib


def _call(name: str, payload) -> dict | list | str | int | float | None:
    """Call a JSON-in/JSON-out C API function.

    Errors are surfaced as ``{"error": "..."}`` payloads and re-raised.
    """
    lib = load()
    raw = json.dumps(payload).encode()
    ptr = getattr(lib, name)(raw)
    if not ptr:
        raise RuntimeError(f"{name}: null result")
    try:
        out = ctypes.string_at(ptr).decode()
    finally:
        lib.tp_free(ptr)
    result = json.loads(out)
    if isinstance(result, dict) and "error" in result:
        raise ValueError(result["error"])
    return result


def capacity_build(inputs: dict) -> dict:
    """The capacity-inventory math (native/src/capacity.cpp) over a
    canonical inputs record {"nodes": [...], "placements": [...],
    "freed": [...]}. Returns {"doc" (the inventory), "inputs_canonical",
    "shared_busy_roots", "metrics", "metrics_openmetrics"}."""
    return _call("tp_capacity_build", {"inputs": inputs})


def capacity_report(stamps: list[dict]) -> dict:
    """The replayable defragmentation report, `analyze --capacity-report`'s
    backend. ``stamps`` is a list of capsule capacity stamps [{"cycle",
    "now_unix", "inputs", "doc"}...]; every inventory is recomputed from its
    inputs (byte drift reported per cycle) and consolidation potential is
    dt-integrated across the window."""
    return _call("tp_capacity_report", {"stamps": stamps})


def replay_cycle(capsule: dict, what_if: dict | None = None) -> dict:
    """Replay a flight-recorder CycleCapsule through the daemon's decision
    pipeline (native/src/recorder.cpp) with zero network, `analyze
    --replay`'s backend. Returns {match, replayed, recorded, drift, flips?,
    query_changed, actions}; ``what_if`` re-decides under altered config
    and adds ``flips``, the decisions that change."""
    payload: dict = {"capsule": capsule}
    if what_if:
        payload["what_if"] = what_if
    return _call("tp_replay_cycle", payload)


def gym_simulate(capsules: list[dict], policies: list | None = None,
                 regret_window_s: int = 600, assume_scale_down: bool = True,
                 assume_interval_s: int = 0) -> dict:
    """Score policies over a capsule corpus in one pass (native/src/gym.cpp):
    reclaimed chip-hours vs false pauses vs actuation churn, `analyze
    --gym`'s backend. ``policies`` are spec strings ("baseline",
    "sweep:lookback=10m", "right-size:threshold=0.8",
    "hysteresis:pause_after=3"); None scores the default panel.
    ``assume_scale_down=False`` scores run modes as recorded."""
    payload: dict = {"capsules": capsules, "regret_window_s": regret_window_s,
                     "assume_scale_down": assume_scale_down}
    if assume_interval_s:
        payload["assume_interval_s"] = assume_interval_s
    if policies:
        payload["policies"] = policies
    return _call("tp_gym_simulate", payload)
