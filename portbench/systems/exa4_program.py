"""The ExaSlang program as its users run it: `L4Executable` on the
program's text, staged (CUDA graphs, the default on the card), with the
fast path (the K1/K2 legs) and without sharding, in the configuration's
dtype.  A solve is the program's own `Solve` function, after U@finest is
set to zero and the right-hand side is copied into F@finest: the captured
graphs read and write the stored field tensors themselves."""

from __future__ import annotations

import torch


class System:
    def __init__(self, cfg: dict, level: int, device: str, config_dir):
        from exastencils_tpu_torch import Knowledge
        from exastencils_tpu_torch.dsl.interpreter import L4Executable
        from exastencils_tpu_torch.dsl.parser import parse_l4

        f64 = cfg["dtype"] == "float64"
        k = Knowledge(dimensionality=3, minLevel=cfg["min_level"], maxLevel=level,
                      useDblPrecision=f64, tpu_compute_dtype="" if f64 else cfg["dtype"],
                      tpu_shard_dsl=False, tpu_dsl_fastpath=True).update()
        self.lines = []
        self.ex = L4Executable(parse_l4(str(config_dir / cfg["program"])), k, device=device,
                               out=self.lines.append, jit_functions=True)
        self.fin = self.ex.hi
        self._solve = self.ex.functions[("Solve", None)]
        self._cycle = self.ex.functions[("MGCycle", self.fin)]

    def load(self, rhs: torch.Tensor):
        """Zero initial guess, `rhs` into F@finest, in place."""
        self.ex.get_field("U", self.fin).zero_()
        self.ex.get_field("F", self.fin).copy_(rhs)

    def solve(self) -> int:
        """Solve(); the cycles it ran, as the program prints them last."""
        self.lines.clear()
        self.ex.call_function(self._solve, None, [])
        return int(self.lines[-1])

    def norms(self) -> list:
        """The residual norms r0, r1, ... that the last Solve() printed."""
        return [float(x) for x in self.lines[:-1]]

    def solution(self) -> torch.Tensor:
        return self.ex.get_field("U", self.fin)

    def cycle(self):
        """One MGCycle@finest on the current fields."""
        self.ex.call_function(self._cycle, self.fin, [])

    def counters(self) -> dict:
        st = self.ex.staging_stats()
        return {k: st[k] for k in ("host_reads", "capture_s", "captures", "unstaged")}
