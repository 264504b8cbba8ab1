"""Checkpoints, metrics, rendering and profiling (counterpart of
``lb2d_tpu.utils``)."""

from .checkpoint import load_state, restore_model, save_model, save_state
from .metrics import (MachWatchdog, MLUPSMeter, accumulated_sum,
                      conservation_report, mach_number)
from .profiling import time_steps, trace
from .render import FieldAnimator, colormap_lut, render_field

__all__ = [
    "save_state", "load_state", "save_model", "restore_model",
    "MachWatchdog", "MLUPSMeter", "accumulated_sum",
    "conservation_report", "mach_number",
    "FieldAnimator", "colormap_lut", "render_field",
    "trace", "time_steps",
]
