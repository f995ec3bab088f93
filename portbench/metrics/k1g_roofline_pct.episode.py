"""k1_roofline_pct over K1's grouped launches, read for lane_steps_per_s
(the episode cell, whose K1 launches are all grouped): portbench/readers.py."""

from portbench.readers import k1_roofline_pct as read  # noqa: F401

NEEDS = ('k1_shapes',)
