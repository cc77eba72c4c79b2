"""Time integration built from a generic forward-Euler substep.

Exact port of the temporal-state construction of the reference's
``afivo/src/m_af_advance.f90:121-214``: each scheme is a fixed sequence of
calls ``y(s_out) = sum(w_prev * y(s_prev)) + dt * f(y(s_deriv))`` on
variable copies indexed by temporal state. The substep function signature is

    substep(cc, fc, dt, dt_lim, time, s_deriv, s_prev, w_prev, s_out,
            i_step, n_steps, params) -> (cc, fc, dt_lim, diag)

IMEX schemes (imex_euler / imex_trapezoidal, ``m_af_advance.f90:185-200``)
interleave an implicit solve for the stiff terms:

    implicit_solver(cc, fc, dt_stiff, time, s_prev, w_prev, s_out, params)
        -> (cc, fc)

and pass the stiff-term time step to the explicit substep via
``params["dt_stiff"]`` (0 for the imex-euler predictor, dt/2 for
imex-trapezoidal — a fully explicit model like the streamer fluid ignores
it, matching the reference where the stiff split is the user's choice).
"""

from __future__ import annotations

THIRD = 1.0 / 3.0
SIXTH = 1.0 / 6.0

#: scheme table: list of substeps; explicit entries are
#: ("euler", dt_factor, dt_stiff_factor, time_offset_factor,
#:  s_deriv, s_prev, w_prev, s_out, i_step)
#: (i_step mirrors the reference's explicit substep numbering, which
#: imex_trapezoidal reuses: m_af_advance.f90:189-200); implicit entries
#: (IMEX) are ("implicit", dt_factor, time_offset_factor,
#: s_prev, w_prev, s_out)
SCHEMES = {
    "forward_euler": [
        ("euler", 1.0, 1.0, 0.0, 0, [0], [1.0], 0, 1)],
    "midpoint_method": [
        ("euler", 0.5, 0.5, 0.0, 0, [0], [1.0], 1, 1),
        ("euler", 1.0, 1.0, 0.5, 1, [0], [1.0], 0, 2)],
    "heuns_method": [
        ("euler", 1.0, 1.0, 0.0, 0, [0], [1.0], 1, 1),
        ("euler", 0.5, 0.5, 1.0, 1, [0, 1], [0.5, 0.5], 0, 2)],
    "ssprk33": [
        ("euler", 1.0, 1.0, 0.0, 0, [0], [1.0], 1, 1),
        ("euler", 0.25, 0.25, 1.0, 1, [0, 1], [0.75, 0.25], 2, 2),
        ("euler", 2 * THIRD, 2 * THIRD, 0.5, 2,
         [0, 2], [THIRD, 2 * THIRD], 0, 3)],
    "ssprk43": [
        ("euler", 0.5, 0.5, 0.0, 0, [0], [1.0], 1, 1),
        ("euler", 0.5, 0.5, 0.5, 1, [1], [1.0], 2, 2),
        ("euler", SIXTH, SIXTH, 1.0, 2, [0, 2], [2 * THIRD, THIRD], 3, 3),
        ("euler", 0.5, 0.5, 0.5, 3, [3], [1.0], 0, 4)],
    "rk4": [
        ("euler", 0.5, 0.5, 0.0, 0, [0], [1.0], 1, 1),
        ("euler", 0.5, 0.5, 0.5, 1, [0], [1.0], 2, 2),
        ("euler", 1.0, 1.0, 0.5, 2, [0], [1.0], 3, 3),
        ("euler", SIXTH, SIXTH, 1.0, 3, [0, 1, 2, 3],
         [-THIRD, THIRD, 2 * THIRD, THIRD], 0, 4)],
    # y* = y_n + dt F0(y_n), then solve y_{n+1} = y* + dt F1(y_{n+1})
    # (m_af_advance.f90:185-188)
    "imex_euler": [
        ("euler", 1.0, 0.0, 0.0, 0, [0], [1.0], 0, 1),
        ("implicit", 1.0, 0.0, [0], [1.0], 0)],
    # y* = y_n + dt F0(y_n) + dt/2 (F1(y_n) + F1(y*)), then
    # y_{n+1} = y_n + dt/2 (F(y_n) + F(y*)) (m_af_advance.f90:189-200)
    "imex_trapezoidal": [
        ("euler", 1.0, 0.5, 0.0, 0, [0], [1.0], 1, 1),
        ("implicit", 0.5, 0.0, [1], [1.0], 1),
        ("euler", 0.5, 0.5, 0.0, 0, [0], [1.0], 0, 1),
        ("euler", 0.5, 0.5, 0.0, 1, [0], [1.0], 0, 2)],
}

#: n_steps per scheme (af_advance_num_steps, ``m_af_advance.f90:40-44``):
#: the highest explicit substep number, which sets the required copies
N_STEPS = {k: max(s[-1] for s in v if s[0] == "euler")
           for k, v in SCHEMES.items()}

REQUIRES_IMPLICIT = {k: any(s[0] == "implicit" for s in v)
                     for k, v in SCHEMES.items()}


def advance(cc, fc, dt: float, time: float, integrator: str, substep,
            params=None, implicit_solver=None):
    """Advance over dt (af_advance). Returns (cc, fc, dt_lim, time+dt,
    diag of the last explicit substep)."""
    if integrator not in SCHEMES:
        raise ValueError(f"time integrator {integrator} not supported")
    if REQUIRES_IMPLICIT[integrator] and implicit_solver is None:
        # m_af_advance.f90:146-147
        raise ValueError(f"time integrator {integrator} requires an "
                         "implicit_solver")
    steps = SCHEMES[integrator]
    n_steps = N_STEPS[integrator]
    dt_lim = None
    diag = {}
    params = dict(params or {})
    for entry in steps:
        if entry[0] == "implicit":
            _, f, toff, s_prev, w_prev, s_out = entry
            cc, fc = implicit_solver(cc, fc, f * dt, time + toff * dt,
                                     s_prev, w_prev, s_out, params)
            continue
        _, f, f_stiff, toff, s_deriv, s_prev, w_prev, s_out, i_step = entry
        params["dt_stiff"] = f_stiff * dt
        cc, fc, dt_lim, diag = substep(
            cc, fc, f * dt, dt_lim, time + toff * dt, s_deriv, s_prev,
            w_prev, s_out, i_step, n_steps, params)
    return cc, fc, dt_lim, time + dt, diag
