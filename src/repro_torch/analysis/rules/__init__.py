"""Rule registry for the FLT lint pass over the port.

Each rule is a class with a ``code``, a ``name``, and a
``check_module(module, project) -> Iterable[Finding]`` method. To add a
rule: create ``rules/fltNNN_<slug>.py`` (duck-typed, no base class),
append it to ``ALL_RULES``, and commit a bad/clean fixture pair under
``tests/fixtures/analysis_torch/``.
"""

from repro_torch.analysis.rules.flt001_host_sync import HostSyncRule
from repro_torch.analysis.rules.flt002_prng import PRNGReuseRule
from repro_torch.analysis.rules.flt003_host_entropy import HostEntropyRule
from repro_torch.analysis.rules.flt004_deprecated import DeprecatedShimRule
from repro_torch.analysis.rules.flt005_dtype import DtypePromotionRule
from repro_torch.analysis.rules.flt006_carry import CarryHygieneRule

ALL_RULES = [
    HostSyncRule,
    PRNGReuseRule,
    HostEntropyRule,
    DeprecatedShimRule,
    DtypePromotionRule,
    CarryHygieneRule,
]

RULES_BY_CODE = {r.code: r for r in ALL_RULES}

__all__ = ["ALL_RULES", "RULES_BY_CODE"]
