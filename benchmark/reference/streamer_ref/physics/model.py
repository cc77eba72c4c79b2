"""Plasma-model switch: local field approximation vs electron energy.

Reference ``src/m_model.f90:9-47``: ``model%type`` selects "lfa" (local
field approximation, default) or "ee53" (local energy approximation with
an electron energy equation whose energy fluxes are 5/3 times the electron
flux). The energy-equation branch is wired through
model_has_energy_equation.
"""

from __future__ import annotations


class Model:
    def __init__(self, cfg=None):
        self.type = "lfa"
        if cfg is not None:
            self.type = cfg.add_get(
                "model%type", "lfa", "Type of model to use")
        if self.type == "ee":  # accepted alias for the reference's ee53
            self.type = "ee53"
        if self.type not in ("lfa", "ee53"):
            raise ValueError(
                f"Unknown model (choices: lfa, ee53): {self.type}")

    @property
    def has_energy_equation(self) -> bool:
        return self.type == "ee53"
