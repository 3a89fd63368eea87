"""The port's host C++ library: the audit dump's reader (``csrc/dump_reader.cpp``,
see ``dump_reader``), the contiguous evaluator's bounds pass
(``csrc/slice_bounds.cpp``, see ``policy.engine.slice_bounds``) and the
streaming window's key join (``csrc/window_keys.cpp``, see
``policy.engine.rekey_window``).

The library is built at first use with the host C++ compiler (``CXX``, else
``c++``) into ``build/torch_host/`` at the repository root and rebuilt when a
source is newer. Without a compiler, or if the build fails, ``load()`` gives
None and each caller takes its Python path. Importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "dump_reader.cpp", _CSRC / "slice_bounds.cpp", _CSRC / "window_keys.cpp")
LIBRARY = Path(__file__).resolve().parents[1] / "build" / "torch_host" / "libtorch_host.so"
CXXFLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")

_P = ctypes.c_void_p
SIGNATURES = {  # name: (argtypes, restype)
    "tp_dump_scan": ((ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _P, _P, _P), _P),
    "tp_dump_fill": ((_P,) * 8, ctypes.c_int),
    "tp_dump_free": ((_P,), None),
    "tp_slice_bounds": ((_P, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, _P), ctypes.c_int),
    "tp_rekey": ((_P, ctypes.c_int64, ctypes.c_int64, _P, _P, ctypes.c_int64, _P, ctypes.c_int64,
                  ctypes.c_int64, ctypes.c_int64, _P, _P, _P, _P, _P), ctypes.c_int),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None | bool = None  # None: not tried; False: no library


def build() -> Path:
    """Compile the library if a source is newer; return its path.

    Raises OSError (no compiler) or RuntimeError (the compile failed). The
    compile writes a temporary file renamed into place, so processes that
    build at once never load a half-written library.
    """
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= max(s.stat().st_mtime for s in SOURCES):
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX") or "c++", *CXXFLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the host library's build failed:\n{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load() -> ctypes.CDLL | None:
    """The library's handle, built if stale; None where it cannot be built
    or loaded (remembered for the process)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError):
                _lib = False
            else:
                for name, (argtypes, restype) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                _lib = lib
        return _lib or None
