"""Blocking reads of the card by the host per time step: the program's own
counters ``sync.<site>`` (``afivo_streamer_tpu_torch/trace.py``, each a
``host_read``: dt limits, cycle residuals, refinement flags, reductions),
summed over the synchronized part of a traced window; None where the
program recorded nothing."""

from harness.program_trace import program


def read(rec):
    synced = program(rec, "synced")
    if synced is None or rec["steps"] <= 0:
        return None
    n = sum(v for k, v in synced["counters"].items()
            if k.startswith("sync."))
    return n / rec["steps"]
