"""Mean ms per refinement epoch in the tree's own Python: the self time of
the program's spans ``epoch.consistency`` (flag consistency and 2:1
balance, the criterion's call left out) and ``epoch.apply`` (the new
boxes and their neighbors) over the epochs of the synchronized part of a
traced window; None where the program recorded nothing."""

from harness.program_trace import program, self_ns


def read(rec):
    synced = program(rec, "synced")
    if synced is None:
        return None
    spans = synced["spans"]
    epochs = sum(1 for r in spans if r[0] == "epoch")
    if epochs == 0:
        return None
    own = self_ns(spans)
    ns = sum(t for r, t in zip(spans, own)
             if r[0] in ("epoch.consistency", "epoch.apply"))
    return 1e-6 * ns / epochs
