"""Time-step control settings (reference ``src/m_dt.f90``)."""

from __future__ import annotations


from .advance import N_STEPS as INTEGRATOR_NUM_STEPS

INTEGRATOR_NAMES = ["forward_euler", "heuns_method", "midpoint_method",
                    "ssprk33", "ssprk43", "imex_euler", "imex_trapezoidal",
                    "rk4"]


class DtConfig:
    def __init__(self, cfg=None):
        self.dt_max = 1.0e-11
        self.dt_min = 1.0e-14
        self.safety_factor = 0.9
        self.cfl_number = 0.5
        self.chemistry_nmin = -1.0
        self.chemistry_limit_loss = True
        self.max_growth_factor = 2.0
        self.integrator = "heuns_method"
        if cfg is not None:
            self.dt_max = cfg.add_get("dt_max", self.dt_max,
                                      "The maximum timestep (s)")
            self.dt_min = cfg.add_get("dt_min", self.dt_min,
                                      "The minimum timestep (s)")
            self.safety_factor = cfg.add_get(
                "dt_safety_factor", self.safety_factor,
                "Safety factor for the time step")
            cfl = cfg.add_get("dt_cfl_number", -1.0e100, "CFL number to use")
            self.cfl_number = cfl if cfl > -1e100 else 0.5
            self.chemistry_nmin = cfg.add_get(
                "dt_chemistry_nmin", self.chemistry_nmin,
                "If > 0, a density to control the accuracy of the chemistry "
                "time step")
            self.chemistry_limit_loss = cfg.add_get(
                "dt_chemistry_limit_loss", True,
                "Limit dt to prevent negative densities due to loss reactions")
            self.max_growth_factor = cfg.add_get(
                "dt_max_growth_factor", 2.0,
                "Maximal relative increase dt for the next iteration")
            self.integrator = cfg.add_get(
                "time_integrator", "heuns_method",
                "Time integrator (use arbitrary value to see options)")
        if self.integrator not in INTEGRATOR_NAMES:
            raise ValueError(f"Unknown time integrator {self.integrator}; "
                             f"options: {INTEGRATOR_NAMES}")

    @property
    def num_steps(self) -> int:
        return INTEGRATOR_NUM_STEPS[self.integrator]
