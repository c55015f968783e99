"""Copied from exastencils_tpu/config/__init__.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch."""

from exastencils_tpu_torch.config.knowledge import Knowledge
from exastencils_tpu_torch.config.settings import Platform, Settings
from exastencils_tpu_torch.config.parser import parse_config_file, parse_config_text, parse_value

__all__ = [
    "Knowledge",
    "Settings",
    "Platform",
    "parse_config_file",
    "parse_config_text",
    "parse_value",
]
