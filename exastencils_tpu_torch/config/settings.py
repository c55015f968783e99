"""File paths / output configuration ("Settings").

Copied from exastencils_tpu/config/settings.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

Mirrors the reference's Settings singleton (config/Settings.scala:25) in
name-compatible form so reference `.settings` files load unchanged.  Most
entries are metadata on TPU (no C++ project is emitted); the ones that
matter are the DSL input files and output/debug paths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class Settings:
    user: str = "guest"
    basePathPrefix: str = "."

    # DSL inputs (reference config/Settings.scala l1file..l4file)
    l1file: str = ""
    l2file: str = ""
    l3file: str = ""
    l4file: str = ""

    # debug prettyprint dumps per layer (reference config/Settings.scala:48-73)
    debugL1File: str = ""
    debugL2File: str = ""
    debugL3File: str = ""
    debugL4File: str = ""

    outputPath: str = "generated"
    htmlLogFile: str = ""
    produceHtmlLog: bool = False
    timeStrategies: bool = False

    buildfileGenerators: list = field(default_factory=list)

    _unused: dict = field(default_factory=dict, repr=False)

    def set(self, key: str, value):
        if hasattr(self, key) and not key.startswith("_"):
            setattr(self, key, value)
        else:
            self._unused[key] = value

    def copy(self) -> "Settings":
        return dataclasses.replace(
            self, buildfileGenerators=list(self.buildfileGenerators), _unused=dict(self._unused)
        )


@dataclass
class Platform:
    """Hardware model (reference config/Platform.scala:24-218).

    On TPU most reference knobs (compiler version, SIMD ISA, OMP table)
    are obsolete; what survives is the roofline hardware model used by the
    performance estimator (exastencils_tpu_torch.runtime.performance).
    Defaults describe one TPU v5p core.
    """

    targetHardware: str = "TPU"
    targetName: str = "v5p"

    # roofline inputs (reference config/Platform.scala:169-218 hw_* block)
    hw_numChips: int = 1
    hw_hbm_bandwidth: float = 2.765e12  # B/s per chip (v5p HBM2e ~2765 GB/s)
    hw_vmem_size: int = 16 * 2**20  # bytes/core
    hw_flops_f32: float = 459e12 / 2  # MXU f32 ~ half of bf16 peak
    hw_flops_bf16: float = 459e12  # v5p peak bf16 FLOP/s
    hw_ici_bandwidth: float = 1.2e11  # B/s per link (order of magnitude)
    hw_dcn_bandwidth: float = 2.5e10

    _unused: dict = dataclasses.field(default_factory=dict, repr=False)

    def set(self, key: str, value):
        if hasattr(self, key) and not key.startswith("_"):
            setattr(self, key, value)
        else:
            self._unused[key] = value

    def copy(self) -> "Platform":
        return dataclasses.replace(self, _unused=dict(self._unused))
