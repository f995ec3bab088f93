"""graph_kernels_per_step, read for
draw_solves_per_s (the GP-draw cell): portbench/readers.py."""

from portbench.readers import graph_kernels_per_step as read  # noqa: F401
