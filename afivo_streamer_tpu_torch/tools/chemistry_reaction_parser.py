"""Convert a CSV table of reactions into the reaction-file format.

Twin of the JAX package's ``tools/chemistry_reaction_parser.py``, on this
package's ``physics/chemistry.RATE_ANALYTIC`` (host work):
``python -m afivo_streamer_tpu_torch.tools.chemistry_reaction_parser
CSV_FILE [--convert-tex OUT.csv] [--length-unit U] [--comment]``.

Input: a CSV with columns ``reaction`` and ``rate`` (optionally
``comment`` and ``length_unit``), where ``rate`` is an analytic expression
in Td/Te/Tg. Each rate expression is matched against the analytic rate
templates that the framework's chemistry engine supports
(afivo_streamer_tpu_torch.physics.chemistry.RATE_ANALYTIC, mirroring
``m_chemistry.f90:58-115``), the coefficients are extracted, and one
reaction-file line ``reaction,template,c1 c2 ...,length_unit`` is printed.

With ``--convert-tex OUT.csv``, LaTeX-style input expressions
(``2.4\\times10^{-7}``, ``T_e``, ``x^{0.7}``, ``\\frac{a}{b}``) are first
normalized to plain Python syntax and written back out instead.

Reference analog: ``tools/chemistry_reaction_parser.py``.
"""

import argparse
import csv
import re
import sys

from ..physics.chemistry import RATE_ANALYTIC

FLOAT = r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eEdD][+-]?\d+)?"


def template_matcher(template):
    """Compile a rate template like ``c1*exp(-c2/Tg)`` into a regex that
    captures the numeric coefficients (with any sign folded in)."""
    # signs directly in front of a coefficient belong to the coefficient
    signs = [1 if s != "-" else -1
             for s in re.findall(r"([+-]?)c\d", template)]
    body = re.sub(r"[+-](c\d)", r" \1", template)
    # escape everything, then turn the escaped placeholders into groups
    body = re.escape(body)
    body = re.sub(r"c\d", lambda _: "(%s)" % FLOAT, body)
    # tolerate arbitrary whitespace anywhere it could legally appear
    body = body.replace(r"\ ", r"\s*")
    body = re.sub(r"(\\\*|\\\+|\\\(|\\\)|/)",
                  lambda m: r"\s*" + m.group(1) + r"\s*", body)
    return re.compile(r"^\s*" + body + r"\s*$"), signs


TEX_RULES = [
    (r"(%s)\s*\\times\s*10\^\{(%s)\}" % (FLOAT, FLOAT), r"\1e\2"),
    (r"\^\{(%s)\}" % FLOAT, r"**\1"),
    (r"\\frac\{(%s)\}\{(\w+)\}" % FLOAT, r"\1/\2"),
    (r"\\frac\{(\w+)\}\{(%s)\}" % FLOAT, r"\1/\2"),
    (r"(\d)\(", r"\1*("),
    (r"(\d)\\", r"\1*\\"),
    (r"\\exp", "exp"),
    (r"T_d", "Td"), (r"T_e", "Te"), (r"T_g", "Tg"),
    (r"\\to", "->"),
]


def detex(text):
    for pat, rep in TEX_RULES:
        text = re.sub(pat, rep, text)
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csv_file")
    ap.add_argument("--convert-tex", metavar="OUT",
                    help="normalize LaTeX expressions and write a new csv")
    ap.add_argument("--length-unit", default="cm")
    ap.add_argument("--comment", action="store_true",
                    help="emit comment column as # lines")
    args = ap.parse_args(argv)

    matchers = [(name, *template_matcher(name)) for name in RATE_ANALYTIC]

    with open(args.csv_file, newline="") as f:
        rows = [r for r in csv.DictReader(
            line for line in f if not line.lstrip().startswith("#"))]

    if args.convert_tex:
        for r in rows:
            r["reaction"] = detex(r["reaction"])
            r["rate"] = detex(r["rate"])
        with open(args.convert_tex, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        return 0

    n_fail = 0
    for r in rows:
        expr = r["rate"].strip()
        for name, rx, signs in matchers:
            m = rx.match(expr)
            if m:
                coeffs = " ".join(
                    repr(float(g.replace("d", "e").replace("D", "e")) * s)
                    for g, s in zip(m.groups(), signs))
                if args.comment and r.get("comment"):
                    print("# " + r["comment"].strip())
                unit = r.get("length_unit") or args.length_unit
                print(f"{r['reaction'].strip()},{name},{coeffs},{unit}")
                break
        else:
            print(f"** no template matches: {expr}", file=sys.stderr)
            n_fail += 1
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
