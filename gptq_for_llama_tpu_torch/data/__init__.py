"""Calibration/eval data loaders (reference: utils/datautils.py)."""

from .datautils import get_loaders, set_seed

__all__ = ["get_loaders", "set_seed"]
