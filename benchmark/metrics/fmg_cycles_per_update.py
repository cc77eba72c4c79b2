"""Mean FMG cycles per photoionization update, summed over its Helmholtz
modes (``photoi.fmg_cycles``), part of the result."""


def read(rec):
    f = rec["fmg"]
    return sum(sum(x) for x in f) / len(f) if f else None
