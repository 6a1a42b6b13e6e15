"""The port's estimators, under the JAX package's names.

Four families (NI sign-batch, INT sign-flip, NI sub-Gaussian clipped
batches, INT sub-Gaussian clipped products, with its grid and real-data
variants), each with a streaming (n-blocked) variant in
:mod:`~dpcorr_torch.models.estimators.streaming`.
"""

from dpcorr_torch.models.estimators.common import (
    CorrResult,
    batch_geometry,
    batch_geometry_dyn,
    batch_means,
    batch_means_dyn,
    k_pad_for,
    sample_sd,
)
from dpcorr_torch.models.estimators.families import FAMILIES
from dpcorr_torch.models.estimators.int_sign import (
    ci_int_signflip,
    correlation_int_signflip,
    interval_from_rho,
)
from dpcorr_torch.models.estimators.int_subg import ci_int_subg
from dpcorr_torch.models.estimators.ni_sign import (
    ci_ni_signbatch,
    correlation_ni_signbatch,
)
from dpcorr_torch.models.estimators.ni_subg import correlation_ni_subg
from dpcorr_torch.models.estimators.registry import serving_entry
from dpcorr_torch.models.estimators.streaming import (
    array_chunk_fn,
    choose_n_chunk,
    ci_int_signflip_stream,
    ci_int_subg_stream,
    ci_ni_signbatch_stream,
    correlation_ni_subg_stream,
    dgp_chunk_fn,
    subg_pair_stream,
)
