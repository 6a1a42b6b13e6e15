"""Percent of the traced window in which the card is idle while the
host is inside a ``keytree`` range: the intersection of the window's
idle gaps with the merged ``keytree`` host intervals, over each gap's
whole length (not only where it starts). None when the program opens
no such range."""

from portbench.ranges import KEYTREE, idle_pct_in


def read(trace, run):
    return idle_pct_in(trace, [KEYTREE])
