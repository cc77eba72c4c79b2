#!/usr/bin/env python3
"""Generate the command list for a chemistry sensitivity study.

Twin of the JAX package's ``tools/sensitivity_generate_commands.py``: one
run of this package per (reaction index, rate factor) with
``input_data%modified_reaction_ix`` / ``input_data%modified_rate_factors``
(physics/chemistry.py) and a distinguishable output name, plus the
unmodified base case; ``-device=NAME`` (or ``--device NAME``), when
given, is passed on to every run (the runs take the card otherwise).
Feed the resulting file to e.g. ``bash commands.txt`` and analyze with
``tools/sensitivity_analyze_results.py``:

    python -m afivo_streamer_tpu_torch.tools.sensitivity_generate_commands \\
        CFG -ix_range 1 3 [-rate_factors 0.8 1.2] [-device=cpu]
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("cfg_file", help="base config file")
    p.add_argument("-command_file", default="commands.txt")
    p.add_argument("-ndim", type=int, default=2)
    p.add_argument("-ix_range", type=int, nargs=2, required=True,
                   help="index range (1-based, inclusive) of reactions")
    p.add_argument("-rate_factors", type=float, nargs="+",
                   default=[0.8, 1.2])
    p.add_argument("-device", "--device", default=None,
                   help="Device of every run (cuda or cpu; default: the "
                        "runs' own, cuda)")
    args = p.parse_args(argv)

    runner = (f"python -m afivo_streamer_tpu_torch {args.cfg_file} "
              f"-ndim={args.ndim}")
    if args.device is not None:
        runner += f" -device={args.device}"
    cmds = [f"{runner} -output%name+=_ix{0:04d}_fac1.0"]
    for ix in range(args.ix_range[0], args.ix_range[1] + 1):
        for fac in args.rate_factors:
            cmds.append(
                f"{runner} -input_data%modified_reaction_ix={ix} "
                f"-input_data%modified_rate_factors={fac} "
                f"-output%name+=_ix{ix:04d}_fac{fac}")
    with open(args.command_file, "w") as f:
        f.write("\n".join(cmds) + "\n")
    print(f"wrote {len(cmds)} commands to {args.command_file}")


if __name__ == "__main__":
    main()
