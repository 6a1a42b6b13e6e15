"""The shipped checker families (the counterparts of
``dpcorr.analysis.rules``, with the same rule ids).

Each module is one plugin: a :class:`dpcorr_torch.analysis.core.Checker`
subclass declaring its rule ids and the slice of the tree it applies
to. Adding a family = adding a module here and listing its class in
``ALL_CHECKERS`` — the runner, CLI, baseline and ``--list-rules`` all
derive from this list.
"""

from dpcorr_torch.analysis.rules.budget import BudgetChecker
from dpcorr_torch.analysis.rules.compilepath import CompilePathChecker
from dpcorr_torch.analysis.rules.coverage import ChaosCoverageChecker
from dpcorr_torch.analysis.rules.deepbudget import DeepBudgetChecker
from dpcorr_torch.analysis.rules.durability import DurabilityChecker
from dpcorr_torch.analysis.rules.lockorder import LockOrderChecker
from dpcorr_torch.analysis.rules.locks import LockChecker
from dpcorr_torch.analysis.rules.metrics import MetricsChecker
from dpcorr_torch.analysis.rules.purity import PurityChecker
from dpcorr_torch.analysis.rules.rawdata import RawDataChecker
from dpcorr_torch.analysis.rules.rng import RngChecker
from dpcorr_torch.analysis.rules.sync import SyncChecker

#: registration order is report order for equal (path, line).
ALL_CHECKERS = (RngChecker, BudgetChecker, LockChecker, PurityChecker,
                RawDataChecker, SyncChecker, MetricsChecker,
                CompilePathChecker)

#: the interprocedural (``--deep``) families — ProjectChecker
#: subclasses run over the callgraph model after the per-module pass.
DEEP_CHECKERS = (LockOrderChecker, DurabilityChecker, DeepBudgetChecker,
                 ChaosCoverageChecker)
