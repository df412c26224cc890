"""Static and dynamic analysis of the port (``repro.analysis``).

* :mod:`repro_torch.analysis.lint` — an AST linter (rule codes
  ``FLT001`` … ``FLT006``) over ``src/repro_torch`` that enforces the
  rounds' hygiene: no host syncs or host entropy reachable from a round
  or a step, no threefry key reuse and no draw from torch's global
  generator, no deprecated shims, no f64 or dtype-less constructors in
  kernel and codec code, no mutable defaults or sets in a round's state.
* :mod:`repro_torch.analysis.contracts` — a dispatch-mode recorder over
  one round of ``make_algorithm1_step`` for the config matrix
  (dense/cohort × local/sharded × identity/int8+EF × dp on/off) that
  asserts what no pointwise test sees: no host sync, DP before the
  encode, collectives only over the topology's group, the wire dtypes,
  no f64, and the metric stream's staging.
* :mod:`repro_torch.analysis.launches` — the counterpart of the
  reference's retrace sentinel: each round's count of dispatched ops and
  kernel launches must stay the same from round 2 on.

CLI: ``python -m repro_torch.analysis [--format json] [paths...]``.
"""

from repro_torch.analysis.lint import Finding, LintResult, lint_paths

__all__ = ["Finding", "LintResult", "lint_paths"]
