"""Wall ms per time step in the fluid update: the self time of the
substeps' spans (``Simulation._substep``), without the field solves
nested in them, synchronized at every span's edges."""


def read(rec):
    if rec["steps"] <= 0:
        return None
    spans = rec["spans"]
    fields = [(a, b) for name, a, b in spans if name == "field"]
    total = 0.0
    for name, a, b in spans:
        if name != "fluid":
            continue
        nested = sum(fb - fa for fa, fb in fields if fa >= a and fb <= b)
        total += (b - a) - nested
    return 1e3 * total / rec["steps"]
