"""The solver API on the variable-coefficient operator: the System of
api_solver.py with `PoissonMGSolver(..., kappa_fn=kappa)`, kappa =
exp(kappa0 (x - x^2)(y - y^2)(z - z^2)) from the configuration's `kappa`.
A solve copies the Dirichlet-set zero guess and the right-hand side into
the same two buffers every time, so every solve replays the recording
bound to them."""

from __future__ import annotations

import torch

from portbench.systems.api_solver import boundary_fn


def kappa_fn(kappa: dict):
    """kappa(x, y, z) of the configuration's `kappa` (its `kappa0`)."""
    k0 = float(kappa["kappa0"])

    def kappa_at(x, y, z):
        return torch.exp(k0 * (x - x * x) * (y - y * y) * (z - z * z))

    return kappa_at


class System:
    def __init__(self, cfg: dict, level: int, device: str, config_dir):
        from exastencils_tpu_torch import Knowledge
        from exastencils_tpu_torch.models.poisson import PoissonMGSolver

        f64 = cfg["dtype"] == "float64"
        k = Knowledge(dimensionality=3, minLevel=cfg["min_level"], maxLevel=level,
                      useDblPrecision=f64, tpu_compute_dtype="" if f64 else cfg["dtype"]).update()
        cg = cfg["coarse"]
        self.solver = PoissonMGSolver(
            k, device=device, bc_fn=boundary_fn(cfg["dirichlet"]), omega=cfg["omega"],
            n_pre=cfg["pre"], n_post=cfg["post"], cgs=cg["solver"],
            cgs_max_its=cg["max_its"], cgs_res_reduction=cg["res_reduction"],
            kappa_fn=kappa_fn(cfg["kappa"]))
        self.sol0, self.rhs = self.solver.init_state()
        self.x = self.sol0.clone()
        self.out = self.x
        self.key = (cfg["target_res_reduction"], cfg["max_cycles"])

    def load(self, rhs: torch.Tensor):
        self.x.copy_(self.sol0)
        self.rhs.copy_(rhs)

    def solve(self) -> int:
        eps, its = self.key
        self.out, _, _, it = self.solver.solve_fused(max_its=its, target_res_reduction=eps,
                                                     state=(self.x, self.rhs))
        return int(it)

    def norms(self):
        """None: `solve_fused` reports no residual norm a cycle."""
        return None

    def solution(self) -> torch.Tensor:
        return self.out

    def cycle(self):
        """One staged V-cycle on the current iterate (its own recording)."""
        self.out = self.solver._cycle(self.out, self.rhs)

    def counters(self) -> dict:
        """`GeneratedSolver.staging_stats()` of the staged solve (zeros on
        the CPU, which runs it eagerly), and the bytes of the coefficient
        arrays and the seconds of their build in set-up."""
        eps, its = self.key
        st = self.solver.gen.staging_stats(max_its=its, target_res_reduction=eps) or {}
        return {"host_reads": st.get("host_reads", 0), "capture_s": st.get("capture_s", 0.0),
                "captures": st.get("captures", 0), "unstaged": 0,
                "coef_bytes": self.solver.coef_bytes, "coef_s": self.solver.coef_s}
