"""Read an audit dump natively from its bytes into ``load_fleet``'s arrays.

``read(path)`` reads the whole dump (``-``: stdin) as bytes and hands them to
``csrc/dump_reader.cpp``, which parses them in one pass. Where the reader
takes the document it returns a ``Scan``: the dump's top-level numbers, and
the chips held in the library until ``Scan.fleet()`` groups them into the
arrays ``analyze.load_fleet`` returns, bit for bit. Where it does not (see
the source for what it refuses), ``read`` decodes the bytes as ``open()`` or
``sys.stdin`` would have and returns ``json.loads``'s document, so the dict
path runs as before, with its errors. The input alone decides the path; the
``obs`` counters ``ingest_native`` and ``ingest_fallback`` count each.

The reader is part of the port's host library (``hostlib``), built at first
use. Without a compiler, or if the build fails, every dump takes the dict
path. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import io
import json
import sys
import warnings
import weakref

import numpy as np

from tpu_pruner_torch import hostlib, obs

PART_BYTES = 4 << 20  # the chips list is read on a thread for each part of this size, up to 8
SCALARS = ("timestamp", "lookback_s", "hbm_threshold", "step_s")  # the scan's order
_SIZES = 8  # chips, T, slices, names' bytes, ids' width, default ids, overflow bits, ragged


class Scan:
    """A dump the reader took: ``get`` reads its top-level numbers, and
    ``fleet()``, called once, gives ``load_fleet``'s result. ``ragged``:
    the chips whose tc series, or hbm series where given, is shorter than
    the longest series."""

    def __init__(self, lib, handle: int, data: bytes, sizes, scalars, present: int):
        self._lib, self._handle, self._data = lib, handle, data  # the handle points into data
        (self._chips, self._samples, _, self._names_bytes, self._id_width, self._default_ids,
         self._overflow, self.ragged) = (int(x) for x in sizes)
        self._scalars = {k: float(scalars[i]) for i, k in enumerate(SCALARS)
                         if present >> i & 1}
        self._free = weakref.finalize(self, lib.tp_dump_free, handle)

    def get(self, key: str, default):
        """``doc.get(key, default)`` for the top-level numbers the CLI reads."""
        if key not in SCALARS:
            raise KeyError(key)
        return self._scalars.get(key, default)

    def fleet(self):
        """((tc, hbm, valid, age, slice_id), slice_names, chip_ids,
        default_ids), as ``load_fleet`` of the parsed document gives them."""
        if not self._free.alive:
            raise RuntimeError("Scan.fleet() was already called")
        C, T = self._chips, self._samples
        tc = np.empty((C, T), dtype=np.float32)
        hbm = np.empty((C, T), dtype=np.float32)
        valid = np.empty((C, T), dtype=bool)
        age = np.empty(C, dtype=np.float32)
        slice_id = np.empty(C, dtype=np.int32)
        ids = np.empty(C, dtype=f"<U{self._id_width}")
        names = ctypes.create_string_buffer(self._names_bytes + 1)
        try:
            status = self._lib.tp_dump_fill(
                self._handle, *(a.ctypes.data for a in (tc, hbm, valid, age, slice_id)),
                ctypes.addressof(names), ids.ctypes.data)
        finally:
            self._free()
            self._data = None
        if status != 0:
            raise MemoryError("the dump reader ran out of memory")
        if self._overflow:  # numpy's cast warns where a finite value becomes inf
            warnings.warn("overflow encountered in cast", RuntimeWarning, stacklevel=2)
        slice_names = names.raw[:self._names_bytes].decode("ascii").split("\n")
        return (tc, hbm, valid, age, slice_id), slice_names, ids, self._default_ids


def scan(data: bytes, part_bytes: int = PART_BYTES) -> Scan | None:
    """The reader's result for a dump's bytes, or None where it does not
    take them (or there is no library). ``part_bytes``: see ``PART_BYTES``;
    the result does not depend on it."""
    lib = hostlib.load()
    if lib is None:
        return None
    sizes = (ctypes.c_int64 * _SIZES)()
    scalars = (ctypes.c_double * len(SCALARS))()
    present = ctypes.c_int32()
    handle = lib.tp_dump_scan(data, len(data), part_bytes, sizes, scalars,
                              ctypes.byref(present))
    if not handle:
        return None
    return Scan(lib, handle, data, sizes, scalars, present.value)


def read(path: str):
    """The dump at ``path`` (``-``: stdin): a ``Scan``, or the document
    ``json.load`` gives where the reader does not take it."""
    if path == "-":
        stream = sys.stdin
        if not isinstance(stream, io.TextIOWrapper):  # no bytes under it to read
            obs.count("ingest_fallback")
            return json.load(stream)
        data = stream.buffer.read()
        # stdin's decoding; CPython opens it with newline="\n" on POSIX
        decoding = {"encoding": stream.encoding, "errors": stream.errors, "newline": "\n"}
    else:
        with open(path, "rb") as f:
            data = f.read()
        decoding = {}  # open()'s defaults
    result = scan(data)
    if result is not None:
        obs.count("ingest_native")
        return result
    obs.count("ingest_fallback")
    return json.load(io.TextIOWrapper(io.BytesIO(data), **decoding))
