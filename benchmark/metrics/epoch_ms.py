"""Mean wall ms of a refinement epoch (the span around the driver's
``adjust_refinement``: flags, the new mesh, prolongation into new boxes),
synchronized at its edges."""


def read(rec):
    s = [b - a for name, a, b in rec["spans"] if name == "epoch"]
    return 1e3 * sum(s) / len(s) if s else None
