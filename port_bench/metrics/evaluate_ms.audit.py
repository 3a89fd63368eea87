"""Host time of one ``analyze.evaluate_loaded`` call in an audit, in ms:
upload, slice bounds, ``evaluate_fleet_c`` and the verdicts back on the
host, which its ``.cpu()`` waits for (host clock, traced run)."""


def read(run):
    seconds = run.spans.get("evaluate_loaded")
    return sum(seconds) / len(seconds) * 1e3 if seconds else None
