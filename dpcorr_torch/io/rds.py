"""RDS ingest front-end: ``read_rds_table(path)``, the port's ``readRDS``
(reference real-data-sims.R:13).

Counterpart of ``dpcorr/io/rds.py``. The JAX package prefers a C++
reader (``native/rdsread.cpp``, bound with ctypes) and falls back to its
pure-Python parser; the port reads with its own pure-Python parser
(:mod:`dpcorr_torch.io.rds_py`), whose long character vectors are
decoded with numpy. Both give the same ``{name: RColumn}`` dicts.
"""

from __future__ import annotations

import os

from dpcorr_torch.io import rds_py
from dpcorr_torch.io.rds_py import RColumn


def read_rds_table(path: str | os.PathLike) -> dict[str, RColumn]:
    """Read a data.frame/tibble ``.rds`` file into ``{name: RColumn}``."""
    return rds_py.read_rds_table(os.fspath(path))
