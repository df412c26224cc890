"""FLT001 — host syncs reachable from a round or a step.

``.item()``, ``.tolist()``, ``.cpu()``, a ``float()``/``int()``/
``bool()`` of a tensor expression, or ``torch.cuda.synchronize`` inside a
scope that runs every round or step makes the host wait for the card: the
dispatch thread stalls until every queued kernel has run, so the rounds'
launches no longer overlap their execution. A round keeps its metrics on
the device (``core/rounds.py``); host-side code (drivers, sinks, the
accountant) is not flagged, since reachability starts at the round and
step entries.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import Finding, Module, Project

_SYNC_METHODS = {"item", "tolist", "cpu"}
_CASTS = {"float", "int", "bool"}


_TENSOR_READS = {"sum", "max", "min", "mean", "norm", "any", "all", "argmax",
                 "argmin", "prod", "dot", "amax", "amin"}


def _mentions_tensor(node: ast.AST, module: Module) -> bool:
    """True if the expression calls a torch function or a tensor
    reduction method (``.sum()``, ``.max()``, ...): a dtype comparison or a
    shape is host data and is not flagged."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        dotted = module.dotted(sub.func) or ""
        root = dotted.split(".")[0]
        if root == "torch":
            return True
        # a reduction method of a value, not a module's function (np.sum)
        if (isinstance(sub.func, ast.Attribute) and sub.func.attr in _TENSOR_READS
                and not (isinstance(sub.func.value, ast.Name)
                         and sub.func.value.id in module.imports)):
            return True
    return False


class HostSyncRule:
    code = "FLT001"
    name = "host-sync-in-round"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        path = str(module.path)
        for qualname, scope in module.scopes.items():
            if not project.is_reachable(module, qualname):
                continue
            for node in scope.own_nodes():
                if not isinstance(node, ast.Call):
                    continue
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SYNC_METHODS
                        and not node.args):
                    yield Finding(path, node.lineno, node.col_offset, self.code,
                                  f".{node.func.attr}() forces a device->host sync "
                                  f"inside round-reachable scope '{qualname}'; keep "
                                  "the value on the device or read it after the "
                                  "rounds")
                    continue
                dotted = module.dotted(node.func)
                if dotted is None:
                    continue
                if dotted == "torch.cuda.synchronize":
                    yield Finding(path, node.lineno, node.col_offset, self.code,
                                  f"'{dotted}' inside round-reachable scope "
                                  f"'{qualname}' waits for the card")
                elif (dotted in _CASTS and node.args
                      and _mentions_tensor(node.args[0], module)):
                    yield Finding(path, node.lineno, node.col_offset, self.code,
                                  f"{dotted}() of a tensor inside round-reachable "
                                  f"scope '{qualname}' reads it back to the host; "
                                  "keep it a tensor")
