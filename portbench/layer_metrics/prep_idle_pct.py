"""Percent of the traced window in which the card is idle while the
host sets a study up: inside ``pipeline_init``, ``hrs_wave`` or
``hrs_standardize``, less the time also inside a ``keytree`` range (so
this share and ``keytree_idle_pct`` never overlap). None when the
program opens none of these ranges."""

from portbench.ranges import KEYTREE, PREP, idle_pct_in


def read(trace, run):
    return idle_pct_in(trace, PREP, leave_out=[KEYTREE])
