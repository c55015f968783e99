"""The solver API as its users drive it: `models/poisson.PoissonMGSolver`
on the dense backend, solved with `solve_fused` (one recording of CUDA
graphs with a device loop over cycles) to the configuration's reduction.
A solve copies the Dirichlet-set zero guess and the right-hand side into
the same two buffers every time, so every solve replays the recording
bound to them."""

from __future__ import annotations

import math

import torch

TRIG = {"sin": torch.sin, "cos": torch.cos}


def boundary_fn(terms):
    """g(x, y, z) = sum of coef * fn(k pi x_axis) over the terms."""
    def g(*x):
        out = 0.0
        for t in terms:
            out = out + t["coef"] * TRIG[t["fn"]](t["k"] * math.pi * x[t["axis"]])
        return out
    return g


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
            n_pre=cfg["pre"], n_post=cfg["post"], cgs=cg["solver"], cgs_max_its=cg["max_its"],
            cgs_res_reduction=cg["res_reduction"])
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
        fused = getattr(self.solver.gen, "_fused", {}).get(self.key)
        if fused is None or not hasattr(fused, "stats"):  # the CPU runs eagerly
            return {"host_reads": 0, "capture_s": 0.0, "captures": 0, "unstaged": 0}
        st = fused.stats
        return {"host_reads": st.host_reads, "capture_s": st.capture_s,
                "captures": st.captures, "unstaged": 0}
