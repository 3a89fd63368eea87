"""Build the hand-written CUDA kernels at first use and load them with ctypes.

``policy/csrc/chip_pass.cu`` (both chip passes, both slice reductions, the
window's key join and row gather, and the policy sweep's pass and reduction)
becomes ``build/torch_kernels/libchip_pass.so`` at the repository root,
compiled by ``nvcc`` for Hopper (``sm_90a``) with a plain C interface. That
builds in seconds, where an extension that includes PyTorch's headers takes
minutes. The library is rebuilt when any source in ``csrc/`` is newer than
it.

No ``-use_fast_math`` and no ``-ftz=true``: the kernels flush subnormals
explicitly where the reference does, and must not flush anywhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# C signature of every entry point: pointers and the stream as void*, sizes
# as int64, small counts as int; each returns cudaGetLastError() as an int,
# except the size query of RESTYPES.
SIGNATURES = {
    # ..., num_chips, num_samples, then kernels.PlanQ in order, then the stream
    "tp_chip_pass_q": (_P, _P, _P, _P, _P, _I64, _I64,
                       _I64, _I64, _I, _I, _I, _I64, _I64, _P),
    # ..., num_chips, num_samples, then kernels.PlanRows in order, then the stream
    "tp_chip_pass_q_rows": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    # ..., num_chips, num_samples, then kernels.PlanGroups in order, then the stream
    "tp_chip_pass_groups": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P),
    # ..., num_chips, num_samples, then kernels.PlanLong in order, then the stream
    "tp_chip_pass_long": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    # candidate, bounds, out, num_chips, num_slices, bound_bytes, wrap_bits,
    # wrap_signed, the stream
    "tp_slice_gate": (_P, _P, _P, _I64, _I64, _I, _I, _I, _P),
    # candidate, ids, marks, out, num_chips, num_slices, id_bytes, the stream
    "tp_slice_scatter": (_P, _P, _P, _P, _I64, _I64, _I, _P),
    # rows, chips: the join's scratch bytes
    "tp_window_join_scratch": (_I64, _I64),
    # row_keys, P, prev_cycle, kept_keys, kept_seen, Q, host_keys, keys, C, cycle,
    # K, scratch, scratch bytes, index, out_kept, host, the stream
    "tp_window_join": (_P, _I64, _I64, _P, _P, _I64, _P, _P, _I64, _I64, _I64, _P, _I64, _P,
                       _P, _P, _P),
    # tc_in, hbm_in, index ([rows] int32), tc_out, hbm_out, rows out, row bytes,
    # the stream
    "tp_window_gather": (_P, _P, _P, _P, _P, _I64, _I64, _P),
    # tc, hbm, valid, age, out, num_chips, num_samples, samples ([D] int32 on
    # the host), D, lookbacks ([D] f32), cutoffs ([H] f32), H, then
    # kernels.PlanSweep in order, then the stream
    "tp_sweep_pass": (_P, _P, _P, _P, _P, _I64, _I64, _P, _I64, _P, _P, _I64, _I64, _I64, _P),
    # masks, ids, id_bytes, buf (slice masks, counts, scratch), num_chips,
    # num_slices, policies, the stream
    "tp_sweep_scatter": (_P, _P, _I, _P, _I64, _I64, _I64, _P),
}
RESTYPES = {"tp_window_join_scratch": ctypes.c_int64}  # the rest return an int
SOURCE = CSRC / "chip_pass.cu"
LIBRARY = BUILD_DIR / "libchip_pass.so"

_lock = threading.Lock()
_loaded: ctypes.CDLL | None = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return newest > LIBRARY.stat().st_mtime


def build() -> Path:
    """Compile the library if it is stale; return its path.

    The compile writes a temporary file that is renamed into place, so
    processes that build at the same time never load a half-written library.
    Raises RuntimeError with nvcc's output if the compile fails.
    """
    if not _stale():
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libchip_pass.{os.getpid()}.tmp.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load() -> ctypes.CDLL:
    """The ctypes handle of ``csrc/chip_pass.cu``, building it if stale."""
    global _loaded
    with _lock:
        if _loaded is None:
            lib = ctypes.CDLL(str(build()))
            for fn_name, argtypes in SIGNATURES.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(fn_name, ctypes.c_int)
            _loaded = lib
        return _loaded


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
