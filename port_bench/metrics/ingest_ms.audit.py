"""Host time of one ``analyze.load_fleet`` call in an audit, in ms: the
dump document to numpy arrays grouped by slice (host clock, traced run)."""


def read(run):
    seconds = run.spans.get("load_fleet")
    return sum(seconds) / len(seconds) * 1e3 if seconds else None
