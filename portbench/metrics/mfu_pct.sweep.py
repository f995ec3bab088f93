"""mfu_pct, read for
solves_per_s (the recipe cell): portbench/readers.py."""

from portbench.readers import mfu_pct as read  # noqa: F401
