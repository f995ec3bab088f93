"""captures_in_window, read for
draw_solves_per_s (the GP-draw cell): portbench/readers.py."""

from portbench.readers import captures_in_window as read  # noqa: F401
