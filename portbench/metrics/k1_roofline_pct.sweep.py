"""k1_roofline_pct, read for
solves_per_s (the recipe cell): portbench/readers.py."""

from portbench.readers import k1_roofline_pct as read  # noqa: F401

NEEDS = ('k1_shapes',)
