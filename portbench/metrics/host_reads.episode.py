"""host_reads, read for lane_steps_per_s (the episode cell):
portbench/readers.py."""

from portbench.readers import host_reads as read  # noqa: F401
