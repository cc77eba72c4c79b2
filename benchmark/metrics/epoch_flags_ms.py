"""Mean ms per refinement epoch in the refinement criterion: the program's
spans ``epoch.flags`` (every call of the criterion over the tree's leaves
and their parents, its read of the flags to the host included) over the
epochs of the synchronized part of a traced window; None where the
program recorded nothing."""

from harness.program_trace import program


def read(rec):
    synced = program(rec, "synced")
    if synced is None:
        return None
    spans = synced["spans"]
    epochs = sum(1 for r in spans if r[0] == "epoch")
    if epochs == 0:
        return None
    ns = sum(r[3] - r[2] for r in spans if r[0] == "epoch.flags")
    return 1e-6 * ns / epochs
