"""device_idle_pct, read for lane_steps_per_s (the episode cell):
portbench/readers.py."""

from portbench.readers import device_idle_pct as read  # noqa: F401
