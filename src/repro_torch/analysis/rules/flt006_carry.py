"""FLT006 — mutable default args and non-tensor state in a round's carry.

A mutable default (``def f(x, acc=[])``) is shared across calls: what one
round appends the next one sees. A ``set`` or a generator in the state a
round carries (the state handed to ``rounds.run_rounds`` /
``loop_rounds`` / ``run_feature_rounds``) has no order (a set) or can be
read once (a generator), so the second round sees another state than the
first; flagging the state expression points at the culprit.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import Finding, Module, Project

_NON_STATE = (ast.Set, ast.SetComp, ast.GeneratorExp)
# round drivers and the position of the state they carry
_DRIVERS = {"run_rounds": 1, "loop_rounds": 1, "run_feature_rounds": 1}


class CarryHygieneRule:
    code = "FLT006"
    name = "carry-hygiene"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        path = str(module.path)
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                args = node.args
                for default in list(args.defaults) + [d for d in args.kw_defaults if d]:
                    if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                        yield Finding(
                            path, default.lineno, default.col_offset, self.code,
                            "mutable default argument is shared across calls; "
                            "default to None and construct inside the function")
                    elif (isinstance(default, ast.Call)
                          and isinstance(default.func, ast.Name)
                          and default.func.id in ("list", "dict", "set")):
                        yield Finding(
                            path, default.lineno, default.col_offset, self.code,
                            f"mutable default '{default.func.id}()' is shared "
                            "across calls; default to None and construct inside "
                            "the function")
            elif isinstance(node, ast.Call):
                name = node.func.attr if isinstance(node.func, ast.Attribute) else (
                    node.func.id if isinstance(node.func, ast.Name) else None)
                pos = _DRIVERS.get(name)
                state = (node.args[pos] if pos is not None and len(node.args) > pos
                         else next((k.value for k in node.keywords if k.arg == "state"),
                                   None) if pos is not None else None)
                if state is None:
                    continue
                for sub in ast.walk(state):
                    if isinstance(sub, _NON_STATE):
                        yield Finding(
                            path, sub.lineno, sub.col_offset, self.code,
                            "the state a round carries holds a set/generator; "
                            "carry tensors in dicts, tuples or NamedTuples so "
                            "every round sees the same state")
                        break
