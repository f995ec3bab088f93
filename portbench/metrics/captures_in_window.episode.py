"""captures_in_window, read for lane_steps_per_s (the episode cell):
portbench/readers.py."""

from portbench.readers import captures_in_window as read  # noqa: F401
