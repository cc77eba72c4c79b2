"""Parse and summarize a chemistry input file.

Twin of the JAX package's ``tools/chemistry_inspect.py``, on this
package's ``CFG``, ``Gas``, ``TransportData`` and ``Chemistry`` (host
work): ``python -m afivo_streamer_tpu_torch.tools.chemistry_inspect
INPUT_FILE [-gas_components ...] [-gas_fractions ...] [-pressure P]
[-reactions]``.

The reference ships ``tools/chemistry_reaction_parser.py`` (CSV + LaTeX
rate expressions to input format); here the complementary direction is
provided as the everyday utility: validate a reaction file with the
framework's own parser and print species, charges, reaction types and
rate data — the quickest way to debug a chemistry input.
"""

import argparse
from collections import Counter

from ..physics.chemistry import Chemistry, REACTION_NAMES
from ..physics.gas import Gas
from ..physics.transport_data import TransportData
from ..utils.config import CFG
from ..utils.table_data import TableDataSettings


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Validate/summarize a chemistry input file")
    p.add_argument("input_file")
    p.add_argument("-gas_components", nargs="+", default=["N2", "O2"])
    p.add_argument("-gas_fractions", nargs="+", type=float,
                   default=[0.8, 0.2])
    p.add_argument("-pressure", type=float, default=1.0)
    p.add_argument("-reactions", action="store_true",
                   help="Print every reaction with its rate data")
    args = p.parse_args(argv)

    cfg = CFG()
    cfg.update_from_arguments([
        f"-input_data%file={args.input_file}",
        "-gas%components=" + " ".join(args.gas_components),
        "-gas%fractions=" + " ".join(str(x) for x in args.gas_fractions),
        f"-gas%pressure={args.pressure}",
    ])
    ts = TableDataSettings(cfg)
    gas = Gas(cfg)
    td = TransportData(cfg, gas, ts)
    chem = Chemistry(gas, td, args.input_file, ts, False, cfg)

    print(f"Species ({len(chem.species_list)}):")
    for name, q in zip(chem.species_list, chem.species_charge):
        print(f"  {name:20s} charge {q:+d}")
    print(f"\nReactions: {len(chem.reactions)}")
    types = Counter(REACTION_NAMES.get(r.reaction_type, "general")
                    for r in chem.reactions)
    for t, nn in sorted(types.items()):
        print(f"  {t}: {nn}")
    if args.reactions:
        print()
        for r in chem.reactions:
            print(f"  {r.description:50s} rate_type={r.rate_type} "
                  f"factor={r.rate_factor:g}")


if __name__ == "__main__":
    main()
