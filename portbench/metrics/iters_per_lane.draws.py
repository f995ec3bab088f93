"""iters_per_lane, read for
draw_solves_per_s (the GP-draw cell): portbench/readers.py."""

from portbench.readers import iters_per_lane as read  # noqa: F401
