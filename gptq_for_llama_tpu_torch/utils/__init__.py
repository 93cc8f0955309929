"""Utilities: metrics (SNR, upgrade ladder, tables) and profiling."""

from .metrics import ascii_table, gen_conditions, snr_error
from .profiling import PhaseTimer, device_memory_stats, device_trace

__all__ = ["ascii_table", "gen_conditions", "snr_error", "PhaseTimer",
           "device_memory_stats", "device_trace"]
