"""Smoother kernel launches per time step (the program's own launch
counters, ``ops/smoother`` wrappers), over the synchronized part of a
traced window: the dispatch layer's count of device calls that the host
issues by hand."""


def read(rec):
    if rec["steps"] <= 0:
        return None
    return rec["launches"] / rec["steps"]
