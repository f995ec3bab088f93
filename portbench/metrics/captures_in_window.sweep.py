"""captures_in_window, read for
solves_per_s (the recipe cell): portbench/readers.py."""

from portbench.readers import captures_in_window as read  # noqa: F401
