"""FLT004 — imports and uses of the port's deprecated shims.

``repro_torch.core.privacy.dp_sample_round`` (replaced by the ``dp=``
stage of ``fed.sample_round``) and ``repro_torch.launch.feature_dist``
(replaced by ``ShardedTopology`` + ``rounds.run_feature_rounds``) exist
for outside callers only. Code of the port uses the replacements; the
shims' DeprecationWarnings carry this rule's code.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import Finding, Module, Project

# dotted prefix -> replacement hint
_SHIMS = {
    "repro_torch.core.privacy.dp_sample_round":
        "fed.sample_round(..., dp=DPConfig(...))",
    "repro_torch.launch.feature_dist":
        "core.fed.feature_round / rounds.run_feature_rounds with a Topology",
}
# modules that define the shims themselves
_DEFINING = {"repro_torch.core.privacy", "repro_torch.launch.feature_dist"}


class DeprecatedShimRule:
    code = "FLT004"
    name = "deprecated-shim"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        if module.name in _DEFINING:
            return
        path = str(module.path)
        seen: set[tuple[int, str]] = set()

        def flag(line: int, col: int, what: str, shim: str) -> Iterable[Finding]:
            if (line, shim) in seen:
                return
            seen.add((line, shim))
            yield Finding(path, line, col, self.code,
                          f"{what} '{shim}' is a deprecated shim; use "
                          f"{_SHIMS[shim]}")

        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    for shim in _SHIMS:
                        if a.name == shim or a.name.startswith(shim + "."):
                            yield from flag(node.lineno, node.col_offset,
                                            "import of", shim)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    for shim in _SHIMS:
                        if full == shim or full.startswith(shim + ".") or node.module == shim:
                            yield from flag(node.lineno, node.col_offset,
                                            "import of", shim)
            elif isinstance(node, (ast.Attribute, ast.Name)):
                dotted = module.dotted(node)
                if dotted:
                    for shim in _SHIMS:
                        if dotted == shim or dotted.startswith(shim + "."):
                            yield from flag(node.lineno, node.col_offset,
                                            "use of", shim)
