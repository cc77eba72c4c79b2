"""100 x (1 - the union of the device's activity intervals over the traced
window), from the device trace of a traced run's first steps."""


def read(rec):
    d = rec["device"]
    if d["window_s"] <= 0.0 or d["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
