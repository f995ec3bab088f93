"""iters_per_lane, read for
solves_per_s (the recipe cell): portbench/readers.py."""

from portbench.readers import iters_per_lane as read  # noqa: F401
