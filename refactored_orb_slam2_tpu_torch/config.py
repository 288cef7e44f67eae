"""The port's configuration: the same typed config tree as the JAX package.

``refactored_orb_slam2_tpu/utils/config.py`` imports only the standard
library and numpy, so the port reads its classes rather than keeping a copy;
both packages then take one ``SystemConfig``.  Callers of the port import
them from here.
"""

from refactored_orb_slam2_tpu.utils.config import (
    CameraConfig,
    LoopConfig,
    MapConfig,
    MatcherConfig,
    ORBConfig,
    SystemConfig,
    TrackingConfig,
    load_settings,
)

__all__ = [
    "CameraConfig", "LoopConfig", "MapConfig", "MatcherConfig", "ORBConfig",
    "SystemConfig", "TrackingConfig", "load_settings",
]
