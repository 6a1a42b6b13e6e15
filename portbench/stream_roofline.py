"""Frozen work count of the streamed pass of the stress-scale study
(``subg.stream_n1e6``), for ``layer_metrics/stream_pass_roofline.py``.

The work is the key-tree words drawn inside the pass's two ranges
(``stream_dgp``, ``subg_stats``) per replication: for each of the
ceil(n / n_chunk) n-chunks, n_chunk words each of the data's three
uniforms (U, E1, E2) and of the INT sender's Laplace noise. The masked
tail is drawn too, so it counts. The batch noise, the keys' folds and
the float work on the words are left out. Each word is one threefry2x32
evaluation, bounded by the integer ALU: of the definition's 78 int32
operations a word, the 41 rotations and xors issue only there, at 64 a
clock per SM (the count of the program's bits kernel when the
benchmark gained this file: 0.8032 ms per 2^14 keys x 2 x 10^4 words).
The count reads the same work whatever implements the pass, so its share
cannot pass what the bits kernel alone reaches.
"""

from __future__ import annotations

from portbench.roofline import CLOCK_HZ, PIPE_RATES, SMS

#: words of one chunk row: U, E1, E2 and the sender's noise
WORDS_PER_ROW = 4
#: rotations and xors of one threefry2x32 word (the ALU-only part)
ALU_OPS_PER_WORD = 41


def words_per_rep(n: int, n_chunk: int) -> int:
    """Words drawn in the pass's ranges per replication."""
    return WORDS_PER_ROW * -(-int(n) // int(n_chunk)) * int(n_chunk)


def least_seconds(words: int) -> float:
    """The least time the card needs for ``words`` threefry words."""
    return words * ALU_OPS_PER_WORD / (PIPE_RATES["int32"] * SMS * CLOCK_HZ)
