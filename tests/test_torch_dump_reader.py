"""tpu_pruner_torch.dump_reader, the native audit dump reader, on the CPU.

Every document gives what ``load_fleet(json.load(f))`` gives, bit for bit,
or the same exception: the reader's own result where it takes the
document, the dict path where it does not. Each case also checks which
path it took (the ``obs`` counters). The reader is built with the host's
C++ compiler at first use. The file imports no JAX: on the card's machine,
``python -m pytest --noconftest tests/test_torch_dump_reader.py`` holds
that machine's compiler to the same cases.
"""

import contextlib
import ctypes
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import warnings
from decimal import Decimal
from pathlib import Path

import numpy as np
import pytest

from port_bench import dumpfile
from tpu_pruner_torch import analyze, dump_reader, hostlib, obs

REPO_ROOT = Path(__file__).resolve().parents[1]


def outcome(fn):
    """("ok", value, warnings) or ("raise", type, message)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = fn()
        except Exception as exc:  # the exception is part of the result
            return ("raise", type(exc), str(exc))
    return ("ok", value, sorted({(w.category, str(w.message)) for w in caught}))


def assert_same(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == "raise":
        assert got[1:] == want[1:]
        return
    (g_arrays, g_names, g_ids, g_default), (w_arrays, w_names, w_ids, w_default) = got[1], want[1]
    for g, w in zip(g_arrays, w_arrays, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert g_names == w_names and type(g_names) is type(w_names)
    assert g_ids.dtype == w_ids.dtype and g_ids.tobytes() == w_ids.tobytes()
    assert g_default == w_default
    assert got[2] == want[2]


def scalars(doc):
    """The top-level numbers as the CLI reads them, as bytes (NaN included)."""
    return [outcome(lambda k=k: struct.pack("<d", float(doc.get(k, -1.5))))
            for k in dump_reader.SCALARS]


def check(path, taken: bool):
    """The reader's result on the file at ``path`` against json.load's, and
    the path it took."""
    before = dict(obs.counts)
    doc = outcome(lambda: dump_reader.read(str(path)))
    moved = {k: obs.counts[k] - before[k] for k in ("ingest_native", "ingest_fallback")}
    if doc[0] == "ok":
        assert isinstance(doc[1], dump_reader.Scan) == taken
        got = outcome(lambda: analyze.load_fleet(doc[1]))
        got_scalars = scalars(doc[1])
    else:
        assert not taken
        got, got_scalars = doc, None
    assert moved == {"ingest_native": int(taken), "ingest_fallback": int(not taken)}

    def reference():
        with open(path) as f:
            return json.load(f)
    ref_doc = outcome(reference)
    if ref_doc[0] == "ok":
        want = outcome(lambda: analyze.load_fleet(ref_doc[1]))
        want_scalars = scalars(ref_doc[1])
    else:
        want, want_scalars = ref_doc, None
    assert_same(got, want)
    if got[0] == "ok":
        assert got_scalars == want_scalars
    return got


C1 = '{"slice": "ml/a", "id": "c1", "tc": [0.0, 0.5], "hbm": [0.1, 0.2]}'
C2 = '{"slice": "ml/b", "tc": [0.0]}'

# name -> (the document's text, taken by the reader)
CASES = {
    # -- what the reader takes ---------------------------------------------
    "plain": ('{"chips": [%s, %s]}' % (C1, C2), True),
    "whitespace": ('\r\n\t {\n\t"chips"\r\n:\t[ \n%s\r\n,\t%s ] ,\n"lookback_s" : 30 }\n\n'
                   % (C1, C2), True),
    "compact": ('{"chips":[{"tc":[1,2],"slice":"s","id":"x"},{"id":"w","slice":"s","tc":[3]}]}',
                True),
    "key_order_and_scalars": ('{"hbm_threshold": 0.05, "chips": [%s], "timestamp": 1000.5, '
                              '"lookback_s": 2100}' % C1, True),
    "unknown_keys_nested": (
        '{"version": 3, "meta": {"a": [1, {"b": null, "c": [true, false]}], "d": "x"}, '
        '"chips": [{"labels": {"k": "v", "n": [1.5e3, -2, "s", {}]}, "slice": "s", '
        '"tc": [0.0], "extra": [], "flag": true, "none": null, "hbm": []}], '
        '"tail": [[[[[]]]]]}', True),
    "numbers": ('{"chips": [{"slice": "s", "tc": [0, -0, 1, -7, 0.25, -0.0, 1e5, 2E-3, '
                '3e+2, 1.5E+1, 999999999999999, -999999999999999, 0.1, 1e-45, 1.4e-45, '
                '5e-324, 1e-310, 3.4028235e38, 1e39, -1e39, NaN, Infinity, -Infinity], '
                '"hbm": [NaN, -0.0], "pod_age_s": -0}]}', True),
    "integer_scalars": ('{"lookback_s": -0, "hbm_threshold": 0, "timestamp": 123456789012345, '
                        '"chips": [%s]}' % C2, True),
    "special_scalars": ('{"lookback_s": NaN, "hbm_threshold": Infinity, '
                        '"timestamp": -Infinity, "chips": [%s]}' % C2, True),
    "missing_ids": ('{"chips": [%s, %s, %s, {"slice": "ml/a", "tc": []}]}' % (C2, C1, C2), True),
    "missing_age": ('{"chips": [{"slice": "s", "id": "a", "tc": [0.0]}]}', True),
    "age_overflow": ('{"chips": [{"slice": "s", "tc": [0.0], "pod_age_s": 1e300}]}', True),
    "hbm_missing_null_empty": (
        '{"chips": [{"slice": "s", "tc": [1]}, {"slice": "s", "tc": [2], "hbm": null}, '
        '{"slice": "s", "tc": [3], "hbm": []}]}', True),
    "hbm_longer_and_shorter": (
        '{"chips": [{"slice": "s", "tc": [0.5], "hbm": [0.1, 0.2, 0.3]}, '
        '{"slice": "t", "tc": [0.1, 0.2, 0.3, 0.4], "hbm": [0.9]}]}', True),
    "every_tc_empty": ('{"chips": [{"slice": "s", "tc": []}, {"slice": "s", "tc": []}]}', True),
    "ids_sorted_in_slice": (
        '{"chips": [{"slice": "b", "id": "z", "tc": [1]}, {"slice": "a", "id": "y", "tc": [2]}, '
        '{"slice": "b", "id": "ab", "tc": [3]}, {"slice": "b", "id": "a", "tc": [4]}, '
        '{"slice": "a", "id": "y", "tc": [5]}, {"slice": "b", "id": "", "tc": [6]}]}', True),
    "names_order_and_empty": (
        '{"chips": [{"slice": "b", "tc": [1]}, {"slice": "", "tc": [2]}, '
        '{"slice": "B", "tc": [3]}, {"slice": "b ", "tc": [4]}, {"slice": "~", "tc": [5]}]}',
        True),
    "printable_ascii": ('{"chips": [{"slice": "%s", "id": "%s", "tc": [0]}]}' % (
        "".join(chr(c) for c in range(0x20, 0x7F) if chr(c) not in '"\\'), "\x7f"), True),
    "null_in_series": ('{"chips": [{"slice": "s", "tc": [null]}]}', True),
    "null_samples": (
        '{"step_s": 60, "chips": [{"slice": "s", "tc": [null, 0.5, null, 0, NaN, null], '
        '"hbm": [0.1, null, null, 0.2, null, NaN]}, {"slice": "s", "tc": [null, null], '
        '"hbm": [null]}, {"slice": "t", "tc": [1, 2, 3, 4, 5, 6], "hbm": [null, 1e39]}]}', True),
    "deep_but_within_limit": ('{"x": %s, "chips": [%s]}' % ("[" * 40 + "]" * 40, C2), True),
    # -- what it leaves to json.load ---------------------------------------
    "escape_in_slice": ('{"chips": [{"slice": "ml\\/a", "tc": [0]}, %s]}' % C1, False),
    "escape_spelling_a_key": ('{"chips": [{"slice": "s", "t\\u0063": [0]}]}', False),
    "escape_in_unknown_value": ('{"note": "a\\nb", "chips": [%s]}' % C1, False),
    "control_byte_in_string": ('{"chips": [{"slice": "a\tb", "tc": [0]}]}', False),
    "non_ascii_in_string": ('{"chips": [{"slice": "caf\u00e9", "tc": [0]}]}', False),
    "repeated_top_key": ('{"chips": [%s], "chips": [%s]}' % (C1, C2), False),
    "repeated_chip_key": ('{"chips": [{"slice": "a", "tc": [1], "tc": [2, 3]}]}', False),
    "repeated_scalar": ('{"lookback_s": 1, "lookback_s": 2, "chips": [%s]}' % C2, False),
    "bool_in_series": ('{"chips": [{"slice": "s", "tc": [true, 0, false]}]}', False),
    "string_in_series": ('{"chips": [{"slice": "s", "tc": ["0.5"]}]}', False),
    "nested_series": ('{"chips": [{"slice": "s", "tc": [[0.5]]}]}', False),
    "numeric_slice": ('{"chips": [{"slice": 5, "tc": [0]}]}', False),
    "numeric_id": ('{"chips": [{"slice": "s", "id": 7, "tc": [0]}]}', False),
    "null_id": ('{"chips": [{"slice": "s", "id": null, "tc": [0]}]}', False),
    "string_age": ('{"chips": [{"slice": "s", "tc": [0], "pod_age_s": "12"}]}', False),
    "null_age": ('{"chips": [{"slice": "s", "tc": [0], "pod_age_s": null}]}', False),
    "string_scalar": ('{"lookback_s": "30", "chips": [%s]}' % C2, False),
    "hbm_false": ('{"chips": [{"slice": "s", "tc": [0], "hbm": false}]}', False),
    "long_integer_sample": ('{"chips": [{"slice": "s", "tc": [1234567890123456]}]}', False),
    "long_integer_age": ('{"chips": [{"slice": "s", "tc": [0], "pod_age_s": 9007199254740993}]}',
                         False),
    "long_integer_unknown": ('{"n": 12345678901234567890, "chips": [%s]}' % C2, False),
    "float_overflow": ('{"chips": [{"slice": "s", "tc": [1e400]}]}', False),
    "float_underflow": ('{"chips": [{"slice": "s", "tc": [1e-400]}]}', False),
    "bom": ('\ufeff{"chips": [%s]}' % C2, False),
    "empty_chips": ('{"chips": []}', False),
    "chips_object": ('{"chips": {}}', False),
    "chips_number": ('{"chips": 5}', False),
    "chip_not_object": ('{"chips": [[0]]}', False),
    "missing_chips": ('{"lookback_s": 30}', False),
    "missing_tc": ('{"chips": [{"slice": "s"}]}', False),
    "missing_slice": ('{"chips": [{"tc": [0]}]}', False),
    "top_level_array": ('[{"chips": []}]', False),
    "too_deep": ('{"x": %s, "chips": [%s]}' % ("[" * 100 + "]" * 100, C2), False),
    "trailing_comma": ('{"chips": [%s, ]}' % C1, False),
    "trailing_comma_in_series": ('{"chips": [{"slice": "s", "tc": [0, ]}]}', False),
    "extra_data": ('{"chips": [%s]} {}' % C1, False),
    "truncated": ('{"chips": [%s, ' % C1, False),
    "empty_document": ("", False),
    "leading_zero": ('{"chips": [{"slice": "s", "tc": [01]}]}', False),
    "bare_fraction": ('{"chips": [{"slice": "s", "tc": [.5]}]}', False),
    "bare_point": ('{"chips": [{"slice": "s", "tc": [1.]}]}', False),
    "bare_exponent": ('{"chips": [{"slice": "s", "tc": [1e]}]}', False),
    "plus_sign": ('{"chips": [{"slice": "s", "tc": [+1]}]}', False),
    "negative_nan": ('{"chips": [{"slice": "s", "tc": [-NaN]}]}', False),
    "lowercase_literal": ('{"chips": [{"slice": "s", "tc": [nan]}]}', False),
    "single_quotes": ("{'chips': []}", False),
    "nul_byte": ('{"chips": [%s]}\x00' % C2, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_matches_json_load(tmp_path, name):
    text, taken = CASES[name]
    path = tmp_path / "dump.json"
    path.write_bytes(text.encode())
    check(path, taken)


def test_invalid_utf8_raises_as_open_does(tmp_path):
    path = tmp_path / "dump.json"
    path.write_bytes(b'{"chips": [{"slice": "\xff", "tc": [0]}]}')
    got = check(path, taken=False)
    assert got[0] == "raise" and got[1] is UnicodeDecodeError


def test_overflow_warns_as_numpy_does(tmp_path):
    path = tmp_path / "dump.json"
    path.write_bytes(CASES["numbers"][0].encode())
    got = check(path, taken=True)
    assert got[2] == [(RuntimeWarning, "overflow encountered in cast")]


# -- seeded random dumps ------------------------------------------------------

def f32_bits(x: float) -> float:
    return struct.unpack("<f", struct.pack("<f", x))[0]


def double_rounding_text(rng) -> str:
    """A decimal just above the midpoint of two f32 neighbours whose lower
    one is even: its double is the midpoint, which rounds to the lower f32,
    where the decimal itself (strtof) rounds to the upper."""
    while True:
        bits = int(rng.integers(0x00800000, 0x7F000000)) & ~1  # even mantissa
        lo = struct.unpack("<f", struct.pack("<I", bits))[0]
        hi = struct.unpack("<f", struct.pack("<I", bits + 1))[0]
        mid = (lo + hi) / 2
        text = format(Decimal(mid) + Decimal(math.ulp(mid)) / 4, "e")
        if float(text) == mid:
            return text


SPECIAL = ["NaN", "Infinity", "-Infinity", "-0.0", "-0", "0", "5e-324", "1e-310",
           "1.401298464324817e-45", "7e-46", "1.1754942e-38", "3.4028234663852886e38",
           "3.4028235677973366e38", "1e39", "-3.5e38", "1E5", "2.5e-3", "3e+2", "999999999999999"]


def sample_text(rng) -> str:
    kind = rng.integers(6)
    if kind == 0:
        return SPECIAL[rng.integers(len(SPECIAL))]
    if kind == 1:
        return double_rounding_text(rng)
    if kind == 2:
        return str(int(rng.integers(-10**6, 10**6)))
    if kind == 3:
        return repr(float(f32_bits(float(rng.random()))))
    if kind == 4:
        return f"{rng.random() * 10.0 ** int(rng.integers(-30, 30)):.{rng.integers(1, 20)}e}"
    return repr(float(rng.random()))


def series_text(rng) -> str:
    """A sample of a series: a number, or now and then null (no sample)."""
    return "null" if rng.random() < 0.1 else sample_text(rng)


def ascii_name(rng, n) -> str:
    alphabet = [chr(c) for c in range(0x20, 0x7F) if chr(c) not in '"\\']
    return "".join(rng.choice(alphabet, size=n))


def ws(rng) -> str:
    return "".join(rng.choice([" ", "\n", "\t", "\r", ""], size=rng.integers(3)))


def random_dump(rng) -> str:
    slices = [ascii_name(rng, rng.integers(0, 6)) for _ in range(rng.integers(1, 6))]
    chips = []
    for _ in range(rng.integers(1, 40)):
        members = [("slice", json.dumps(slices[rng.integers(len(slices))]))]
        members.append(("tc", "[" + ", ".join(series_text(rng) for _ in range(rng.integers(13)))
                        + "]"))
        if rng.random() < 0.7:
            members.append(("id", json.dumps(ascii_name(rng, rng.integers(0, 4)))))
        if rng.random() < 0.7:
            members.append(("pod_age_s", sample_text(rng)))
        hbm = rng.integers(4)
        if hbm == 1:
            members.append(("hbm", "null"))
        elif hbm >= 2:
            members.append(("hbm", "[" + ", ".join(series_text(rng) for _ in
                                                   range(rng.integers(13))) + "]"))
        if rng.random() < 0.3:
            members.append(("x" + ascii_name(rng, 2), '{"{": [1, "},{", {}], "n": null}'))
        order = rng.permutation(len(members))
        chips.append("{" + ",".join(f'{ws(rng)}"{members[k][0]}"{ws(rng)}:{ws(rng)}'
                                    f'{members[k][1]}{ws(rng)}' for k in order) + "}")
    top = [("chips", "[" + ",".join(ws(rng) + c + ws(rng) for c in chips) + "]")]
    for key in dump_reader.SCALARS:
        if rng.random() < 0.5:
            top.append((key, sample_text(rng)))
    order = rng.permutation(len(top))
    return ws(rng) + "{" + ",".join(f'"{top[k][0]}":{ws(rng)}{top[k][1]}' for k in order) + "}"


@pytest.mark.parametrize("seed", range(8))
def test_random_dumps_match_json_load(tmp_path, seed):
    """Ragged dumps of every kind of number and null samples, in any key
    order, read in parts of every size (each guess at a chip's start right
    or wrong); the ragged chips counted as the dict path counts them."""
    rng = np.random.default_rng(20260 + seed)
    path = tmp_path / "dump.json"
    for _ in range(25):
        text = random_dump(rng)
        path.write_text(text)
        want = outcome(lambda: analyze.load_fleet(json.loads(text)))
        assert want[0] == "ok"
        for part_bytes in (1, 13, 64, 1 << 30):
            scan = dump_reader.scan(text.encode(), part_bytes)
            assert scan is not None, text
            assert scan.ragged == analyze.ragged_chips(json.loads(text))
            assert_same(outcome(lambda: analyze.load_fleet(scan)), want)
        check(path, taken=True)


def test_cell_dump_takes_the_native_path(tmp_path):
    """port_bench's own dump writer (the audit cell's format) is read natively."""
    rng = np.random.default_rng(7)
    C, S, T = 2048, 128, 8
    tc = rng.random((C, T), dtype=np.float32) * (rng.random((C, T)) < 0.3)
    tc[rng.random((C, T)) < 0.05] = np.float32(1e-40)
    hbm = rng.random((C, T), dtype=np.float32) * 0.1
    valid = rng.random((C, T)) > 0.1
    valid[::7] = False
    age = (rng.random(C) * 86400).astype(np.float32)
    names, ids = dumpfile.names(S, C // S, 7)
    path = tmp_path / "dump.json"
    dumpfile.write(path, tc, hbm, valid, age, np.repeat(np.arange(S), C // S), names, ids,
                   rng.permutation(C), 2100.0, 0.05)
    check(path, taken=True)
    data = path.read_bytes()
    want = outcome(lambda: analyze.load_fleet(json.loads(data)))
    for part_bytes in (1, 4096, 65536):
        assert_same(outcome(lambda: analyze.load_fleet(dump_reader.scan(data, part_bytes))),
                    want)


def test_fleet_is_given_once(tmp_path):
    scan = dump_reader.scan(CASES["plain"][0].encode())
    scan.fleet()
    with pytest.raises(RuntimeError, match="already"):
        scan.fleet()


# -- the build ----------------------------------------------------------------

def test_source_newer_than_library_rebuilds_it(tmp_path, monkeypatch):
    sources = tuple(tmp_path / source.name for source in hostlib.SOURCES)
    for source, copy in zip(hostlib.SOURCES, sources):
        shutil.copy(source, copy)
    library = tmp_path / "build" / "libtorch_host.so"
    monkeypatch.setattr(hostlib, "SOURCES", sources)
    monkeypatch.setattr(hostlib, "LIBRARY", library)
    hostlib.build()
    first = library.stat()
    for source in sources:
        os.utime(source, (first.st_mtime - 10, first.st_mtime - 10))
    hostlib.build()
    assert library.stat().st_ino == first.st_ino  # not rebuilt
    for source in sources:  # each source alone makes it stale
        built = library.stat()
        os.utime(source, (built.st_mtime + 10, built.st_mtime + 10))
        hostlib.build()
        assert library.stat().st_ino != built.st_ino
        os.utime(source, (first.st_mtime - 10, first.st_mtime - 10))
    lib = ctypes.CDLL(str(library))
    assert lib.tp_dump_scan and lib.tp_dump_fill and lib.tp_dump_free and lib.tp_slice_bounds


def test_without_a_compiler_the_cli_reads_with_json_load(tmp_path, monkeypatch):
    path = tmp_path / "dump.json"
    path.write_text(CASES["plain"][0])
    monkeypatch.setattr(hostlib, "LIBRARY", tmp_path / "build" / "libtorch_host.so")
    monkeypatch.setattr(hostlib, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    outs = []
    for use_reader in (False, True):
        if use_reader:
            before = dict(obs.counts)
        out, err = [], []
        with contextlib.redirect_stdout(_Sink(out)), contextlib.redirect_stderr(_Sink(err)):
            assert analyze.main([str(path), "--device", "cpu"]) == 0
        outs.append(("".join(out), "".join(err)))
        monkeypatch.setattr(hostlib, "_lib", None)
    assert obs.counts["ingest_fallback"] - before["ingest_fallback"] == 1
    assert obs.counts["ingest_native"] == before["ingest_native"]
    assert outs[0] == outs[1]
    assert not (tmp_path / "build" / "libtorch_host.so").exists()


class _Sink:
    def __init__(self, parts):
        self.parts = parts

    def write(self, text):
        self.parts.append(text)
        return len(text)

    def flush(self):
        pass


def test_importing_analyze_builds_nothing():
    probe = """
import ctypes, subprocess, sys
def refuse(*args, **kwargs):
    raise AssertionError("built or loaded at import")
subprocess.run = subprocess.Popen = ctypes.CDLL = refuse
import tpu_pruner_torch.analyze
from tpu_pruner_torch import hostlib
assert hostlib._lib is None
assert "torch" not in sys.modules
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=120, cwd=REPO_ROOT)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
