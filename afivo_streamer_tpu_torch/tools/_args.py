"""Arguments the tools share."""


def add_device(parser) -> None:
    """``-device=NAME`` or ``--device NAME``: the device the tool runs on
    (``cuda``, the default, or ``cpu``)."""
    parser.add_argument("-device", "--device", default="cuda",
                        help="Device to run on (cuda or cpu)")
