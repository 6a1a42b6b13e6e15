"""Sign-family estimators of the port (NI sign-batch, INT sign-flip)."""

from dpcorr_torch.models.estimators.common import (
    CorrResult,
    batch_geometry,
    batch_means,
    sample_sd,
)
from dpcorr_torch.models.estimators.int_sign import (
    ci_int_signflip,
    correlation_int_signflip,
    interval_from_rho,
)
from dpcorr_torch.models.estimators.ni_sign import (
    ci_ni_signbatch,
    correlation_ni_signbatch,
)
