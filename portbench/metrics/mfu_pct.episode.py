"""mfu_pct, read for lane_steps_per_s (the episode cell):
portbench/readers.py."""

from portbench.readers import mfu_pct as read  # noqa: F401
