"""Cells shrunk to a size the CPU holds, for the harness's tests."""

from portbench import core

#: (config overrides, cell overrides) per workload
SMALL = {
    "ni_n10k.unfused": ({"n": 400}, {"block_reps": 256, "chunk_size": 64,
                                     "sample_per_study": 16,
                                     "max_studies": 64}),
    # 20 replications in chunks of 8: the last chunk is partial, as the
    # cell's 10,000 in chunks of 2,048 end in one of 1,808
    "hrs.bootstrap": ({"boot_reps": 20}, {"chunk": 8, "sample_per_study": 16,
                                          "max_studies": 8}),
}


def small(workload: str) -> tuple[dict, dict]:
    """(config, cell) of a workload at its CPU size."""
    cell, config = core.cell_files(workload)
    cfg_o, cell_o = SMALL[workload]
    return {**config, **cfg_o}, {**cell, **cell_o}
