"""device_idle_pct, read for
solves_per_s (the recipe cell): portbench/readers.py."""

from portbench.readers import device_idle_pct as read  # noqa: F401
