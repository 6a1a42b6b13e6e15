"""The estimator-family names the serving layer accepts.

Counterpart of ``dpcorr/models/estimators/families.py``: request
validation (:mod:`dpcorr_torch.serve.request`) needs only the names, so
they live apart from the estimators.
"""

from __future__ import annotations

#: Families the serving layer accepts, in SURVEY.md §2.2 order.
FAMILIES: tuple[str, ...] = ("ni_sign", "int_sign", "ni_subg", "int_subg")
