"""dpcorr_torch: the PyTorch/CUDA port of dpcorr for one NVIDIA H100.

The JAX package ``dpcorr`` is the reference; this package imports neither
it nor JAX. Entry points run on the card unless the caller passes
``device="cpu"``; with no card and no device given they raise.
"""

from dpcorr_torch.ops.fused_ni import (
    KERNEL_LAUNCHES,
    fused_ni_sums,
    ni_sign_fused,
    use_fused_ni,
)
from dpcorr_torch.sim import (
    DETAIL_FIELDS,
    RepBlockPipeline,
    SimConfig,
    SimResult,
    run_sim_one,
    sim_detail_fused,
)
