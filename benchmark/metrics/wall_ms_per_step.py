"""Wall ms per time step over the synchronized part of a traced window
(the steps after the device trace, a synchronize at every span's edges):
the whole step on the host's clock, epochs, photoionization updates,
field solves and rejected attempts included. It reads the host's speed as
much as the program's: on the host of one H100 machine the same ten steps
of one seed took 0.74 to 1.31 times as long in one run as in another."""


def read(rec):
    if rec["steps"] <= 0 or rec["wall_s"] <= 0:
        return None
    return 1e3 * rec["wall_s"] / rec["steps"]
