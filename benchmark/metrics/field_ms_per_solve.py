"""Mean wall ms of a field solve (the span around ``field.compute``:
V-cycles, the field from the potential), synchronized at its edges."""


def read(rec):
    s = [b - a for name, a, b in rec["spans"] if name == "field"]
    return 1e3 * sum(s) / len(s) if s else None
