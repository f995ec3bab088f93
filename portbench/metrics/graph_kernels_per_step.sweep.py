"""graph_kernels_per_step, read for
solves_per_s (the recipe cell): portbench/readers.py."""

from portbench.readers import graph_kernels_per_step as read  # noqa: F401
