"""Misc utilities of the port: config schema, checkpoint, helpers."""

from .config_schema import ConfigError, validate_config
from .misc import check_key_and_bool, crop_event, set_numerics, fix_random_seed

__all__ = [
    "ConfigError",
    "validate_config",
    "check_key_and_bool",
    "crop_event",
    "set_numerics",
    "fix_random_seed",
]
