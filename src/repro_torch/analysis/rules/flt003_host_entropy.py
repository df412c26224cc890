"""FLT003 — host entropy and clocks reachable from a round or a step.

``random.*``, ``time.*``, ``datetime.*``, ``secrets.*`` and
``os.urandom`` inside a scope that runs every round draw from the host:
the run is no longer a function of its seed (the port's draws are
threefry's, from the round's key), or a round's result depends on when it
ran. Host-side orchestration (timing loops, manifests, spans) is not
flagged: reachability starts at the round and step entries.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import Finding, Module, Project

_HOST_ENTROPY_MODULES = {"random", "time", "datetime", "secrets"}


class HostEntropyRule:
    code = "FLT003"
    name = "host-entropy-in-round"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        path = str(module.path)
        for qualname, scope in module.scopes.items():
            if not project.is_reachable(module, qualname):
                continue
            for node in scope.own_nodes():
                if not isinstance(node, ast.Call):
                    continue
                dotted = module.dotted(node.func)
                if not dotted:
                    continue
                root = dotted.split(".")[0]
                if (root in _HOST_ENTROPY_MODULES or dotted == "os.urandom") and any(
                        v == root or v.startswith(root + ".")
                        for v in module.imports.values()):
                    yield Finding(
                        path, node.lineno, node.col_offset, self.code,
                        f"host call '{dotted}' in round-reachable scope "
                        f"'{qualname}' makes the round depend on the host; use "
                        "the round's threefry key (repro_torch.random) or its "
                        "round number")
