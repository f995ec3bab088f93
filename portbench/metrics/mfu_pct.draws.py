"""mfu_pct, read for
draw_solves_per_s (the GP-draw cell): portbench/readers.py."""

from portbench.readers import mfu_pct as read  # noqa: F401
