"""Mean V-cycles per field solve (``fas_vcycle_blocks`` calls without a
``top`` inside ``field.compute``), part of the result."""


def read(rec):
    v = rec["vcycles"]
    return sum(v) / len(v) if v else None
