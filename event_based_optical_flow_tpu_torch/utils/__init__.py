"""Misc utilities of the port: config schema, checkpoint, event arrays, helpers."""

from .config_schema import ConfigError, check_ported, validate_config
from .events import crop_event, crop_event_mask, generate_events, set_event_origin_to_zero, undistort_events
from .misc import check_key_and_bool, fetch_runtime_info, fix_random_seed, set_numerics

__all__ = [
    "ConfigError",
    "check_ported",
    "validate_config",
    "generate_events",
    "crop_event",
    "crop_event_mask",
    "set_event_origin_to_zero",
    "undistort_events",
    "check_key_and_bool",
    "fetch_runtime_info",
    "set_numerics",
    "fix_random_seed",
]
