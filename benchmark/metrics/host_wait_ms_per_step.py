"""Host ms per time step spent waiting in blocking reads of the card: the
program's spans ``sync.<site>`` (``afivo_streamer_tpu_torch/trace.py``)
summed over the steps traced on the device, where nothing else
synchronizes (in the later steps the probes' synchronizes drain the queue
before the program reads); None where the program recorded nothing."""

from harness.program_trace import program, steps_of


def read(rec):
    traced = program(rec, "traced")
    if traced is None or steps_of(traced) <= 0:
        return None
    ns = sum(r[3] - r[2] for r in traced["spans"]
             if r[0].startswith("sync."))
    return 1e-6 * ns / steps_of(traced)
