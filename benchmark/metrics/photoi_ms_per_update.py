"""Mean wall ms of a photoionization update (the span around
``photoi.set_src``: the source, an FMG solve per Helmholtz mode, and any
rebuild of their tables), synchronized at its edges."""


def read(rec):
    s = [b - a for name, a, b in rec["spans"] if name == "photoi"]
    return 1e3 * sum(s) / len(s) if s else None
