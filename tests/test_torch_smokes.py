"""The port's seven smokes, `python -m tpu_pruner_torch.testing.<name>`.

Each smoke's main() runs here in-process: the port's daemon
(tpu_pruner_torch.native.DAEMON_PATH) against the port's fakes, and the
port's analyze (`python -m tpu_pruner_torch.analyze`) where the smoke reads
a report. main() must return 0, and its closing line must match the
reference smoke's: the text of the last print() in the reference's main(),
with each interpolated field matched by a wildcard.
"""

import ast
import importlib
import inspect
import re

import pytest

from tpu_pruner_torch import native

SMOKES = ["replay_smoke", "gym_smoke", "capacity_smoke", "trace_smoke", "event_smoke",
          "fleet_smoke", "chaos_smoke"]


def closing_line_pattern(module_name: str) -> re.Pattern:
    """The last stdout print() of `main` in a smoke module, as a regex."""
    module = importlib.import_module(module_name)
    tree = ast.parse(inspect.getsource(module))
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    prints = [node for node in ast.walk(main)
              if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"
              and not any(kw.arg == "file" for kw in node.keywords)]
    arg = max(prints, key=lambda node: node.lineno).args[0]
    if isinstance(arg, ast.IfExp):  # print("OK" if ok else "FAILED"): the passing text
        arg = arg.body
    if isinstance(arg, ast.Constant):
        return re.compile(re.escape(arg.value))
    parts = [re.escape(v.value) if isinstance(v, ast.Constant) else ".+?" for v in arg.values]
    return re.compile("".join(parts))


@pytest.fixture(scope="module")
def built():
    native.ensure_built()


@pytest.mark.parametrize("smoke", SMOKES)
def test_smoke_passes_with_the_ports_daemon_and_analyze(built, smoke, capsys):
    module = importlib.import_module(f"tpu_pruner_torch.testing.{smoke}")
    source = inspect.getsource(module)
    assert "tpu_pruner." not in source.replace("tpu_pruner_torch.", "")
    rc = module.main()
    out, err = capsys.readouterr()
    assert rc == 0, out + err[-3000:]
    closing = out.rstrip("\n").splitlines()[-1]
    pattern = closing_line_pattern(f"tpu_pruner.testing.{smoke}")
    assert pattern.fullmatch(closing), (pattern.pattern, closing)
    assert closing_line_pattern(module.__name__).pattern == pattern.pattern


def test_closing_line_patterns():
    assert closing_line_pattern("tpu_pruner.testing.gym_smoke").pattern == "OK"
    assert closing_line_pattern("tpu_pruner.testing.replay_smoke").fullmatch(
        "replay-smoke OK: 2 cycles recorded and replayed with zero drift")
    chaos = closing_line_pattern("tpu_pruner.testing.chaos_smoke")
    assert chaos.fullmatch("chaos-smoke OK: 3 seeded scenarios (seed 1107) held every invariant")
    assert not chaos.fullmatch("chaos-smoke FAILED [convergence]: x")
