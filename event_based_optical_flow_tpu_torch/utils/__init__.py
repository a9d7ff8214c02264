"""Misc utilities of the port: config schema, checkpoint, helpers."""

from .config_schema import ConfigError, check_ported, validate_config
from .misc import check_key_and_bool, crop_event, set_numerics, fix_random_seed

__all__ = [
    "ConfigError",
    "check_ported",
    "validate_config",
    "check_key_and_bool",
    "crop_event",
    "set_numerics",
    "fix_random_seed",
]
