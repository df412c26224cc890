"""FLT002 — key reuse in the port's threefry, and the global torch RNG.

Four patterns:

* **Straight-line reuse** — the same key variable (same assignment
  generation) consumed by two ``repro_torch.random`` sampler/``split``
  calls (``split``, ``bits``, ``normal``, ``uniform``, ``randint``,
  ``permutation``, ``dirichlet``, ``loggamma``, ``gumbel``,
  ``categorical``) repeats the randomness.
* **Loop reuse** — a key defined outside a loop consumed inside it
  without being reassigned in the loop body draws identical randomness
  every iteration. ``fold_in(key, i)`` (a Call argument, not a bare Name)
  is the sanctioned pattern and is never flagged.
* **Per-client split** — ``split(key, num_clients)`` derives per-client
  keys positionally, so the dense and cohort engines disagree; derive
  them from stable client ids with ``fed.client_keys`` (``fold_in``).
* **Global torch RNG** — ``torch.manual_seed`` and ``torch.rand*``/
  ``randn*``/``randint*``/``randperm``/``normal``/``bernoulli``/
  ``multinomial`` without a ``generator=``: their draws depend on what
  else ran in the process, not on the run's key.

``fold_in`` itself is neither a consumer nor a violation: folding the
same base key with different data is exactly the recommended idiom.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import Finding, Module, Project

_SAMPLERS = {"normal", "uniform", "randint", "bits", "permutation",
             "dirichlet", "loggamma", "gumbel", "categorical"}
_CONSUMERS = _SAMPLERS | {"split"}
_CLIENT_AXIS_HINTS = {"num_clients", "n_clients", "clients"}
_GLOBAL_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
               "randn_like", "randint_like", "normal", "bernoulli",
               "multinomial", "poisson"}


def _is_random_call(node: ast.Call, module: Module) -> str | None:
    """Return the repro_torch.random function name if this is a consuming
    call."""
    dotted = module.dotted(node.func)
    if not dotted:
        return None
    mod, _, fn = dotted.rpartition(".")
    if fn in _CONSUMERS and mod == "repro_torch.random":
        return fn
    return None


def _global_rng(node: ast.Call, module: Module) -> str | None:
    """The dotted name of a draw from torch's global generator, or None."""
    dotted = module.dotted(node.func)
    if dotted == "torch.manual_seed" or dotted == "torch.cuda.manual_seed":
        return dotted
    if (dotted and dotted.startswith("torch.") and dotted.count(".") == 1
            and dotted[6:] in _GLOBAL_RNG
            and not any(k.arg == "generator" for k in node.keywords)):
        return dotted
    return None


class _ScopeState:
    def __init__(self) -> None:
        self.gen: dict[str, int] = {}
        # (name, gen) -> (fn, line) of first consuming use
        self.used: dict[tuple[str, int], tuple[str, int]] = {}

    def bump(self, name: str) -> None:
        self.gen[name] = self.gen.get(name, 0) + 1


class PRNGReuseRule:
    code = "FLT002"
    name = "prng-key-reuse"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        path = str(module.path)
        for qualname, scope in module.scopes.items():
            node = scope.node
            body = node.body if isinstance(node.body, list) else [ast.Expr(node.body)]
            state = _ScopeState()
            findings: list[Finding] = []
            self._walk(body, module, state, findings, path, loop_depth=0,
                       loop_assigned=set())
            yield from findings

    # ------------------------------------------------------------------

    def _walk(self, stmts: list[ast.stmt], module: Module, state: _ScopeState,
              out: list[Finding], path: str, loop_depth: int,
              loop_assigned: set[str]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                inner_assigned = _assigned_names(stmt)
                # uses first (loop header expressions), then body with loop context
                for expr in _header_exprs(stmt):
                    self._visit_expr(expr, module, state, out, path,
                                     loop_depth, loop_assigned)
                for t in _target_names(getattr(stmt, "target", None)):
                    state.bump(t)
                self._walk(stmt.body + stmt.orelse, module, state, out, path,
                           loop_depth + 1, inner_assigned)
                continue
            if isinstance(stmt, (ast.If, ast.With, ast.Try)):
                for expr in _header_exprs(stmt):
                    self._visit_expr(expr, module, state, out, path,
                                     loop_depth, loop_assigned)
                for block in _sub_blocks(stmt):
                    self._walk(block, module, state, out, path,
                               loop_depth, loop_assigned)
                for t in _with_targets(stmt):
                    state.bump(t)
                continue
            # plain statement: visit expressions (uses), then bump targets
            for child in _calls_excluding_nested(stmt):
                self._visit_call(child, module, state, out, path,
                                 loop_depth, loop_assigned)
            for t in _target_names(stmt):
                state.bump(t)

    def _visit_expr(self, expr: ast.AST, module: Module, state: _ScopeState,
                    out: list[Finding], path: str, loop_depth: int,
                    loop_assigned: set[str]) -> None:
        for child in _calls_excluding_nested(expr):
            self._visit_call(child, module, state, out, path,
                             loop_depth, loop_assigned)

    def _visit_call(self, node: ast.Call, module: Module, state: _ScopeState,
                    out: list[Finding], path: str, loop_depth: int,
                    loop_assigned: set[str]) -> None:
        glob = _global_rng(node, module)
        if glob is not None:
            out.append(Finding(
                path, node.lineno, node.col_offset, self.code,
                f"'{glob}' draws from torch's global generator: the draw "
                "depends on what else ran in the process; draw from the "
                "run's threefry key (repro_torch.random) or pass generator="))
            return
        fn = _is_random_call(node, module)
        if fn is None:
            return
        # per-client split: split(key, <client-count expr>)
        if fn == "split" and len(node.args) >= 2:
            for sub in ast.walk(node.args[1]):
                hint = None
                if isinstance(sub, ast.Attribute) and sub.attr in _CLIENT_AXIS_HINTS:
                    hint = sub.attr
                elif isinstance(sub, ast.Name) and sub.id in _CLIENT_AXIS_HINTS:
                    hint = sub.id
                if hint:
                    out.append(Finding(
                        path, node.lineno, node.col_offset, self.code,
                        f"per-client keys derived via random.split over "
                        f"'{hint}' are positional; derive from stable client ids "
                        "with fed.client_keys (fold_in) so dense and cohort "
                        "engines draw identical randomness"))
                    break
        if not node.args or not isinstance(node.args[0], ast.Name):
            return
        key_name = node.args[0].id
        gen = state.gen.get(key_name, 0)
        prev = state.used.get((key_name, gen))
        if prev is not None:
            pfn, pline = prev
            out.append(Finding(
                path, node.lineno, node.col_offset, self.code,
                f"PRNG key '{key_name}' already consumed by random.{pfn} "
                f"at line {pline}; reusing it repeats the randomness — derive "
                "a fresh key with fold_in/split"))
        else:
            state.used[(key_name, gen)] = (fn, node.lineno)
        if (loop_depth > 0 and key_name not in loop_assigned
                and state.gen.get(key_name, 0) == gen and prev is None):
            out.append(Finding(
                path, node.lineno, node.col_offset, self.code,
                f"PRNG key '{key_name}' defined outside the loop is consumed "
                "by random." + fn + " inside it without reassignment; every "
                "iteration repeats the same randomness — fold_in the loop index"))


def _calls_excluding_nested(node: ast.AST) -> list[ast.Call]:
    """Call nodes in evaluation order, not descending into nested scopes."""
    calls: list[ast.Call] = []
    stack: list[ast.AST] = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) and cur is not node:
            continue
        if isinstance(cur, ast.Call):
            calls.append(cur)
        stack.extend(ast.iter_child_nodes(cur))
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    return calls


def _assigned_names(loop: ast.stmt) -> set[str]:
    """Names (re)bound anywhere inside the loop, targets only — a bare
    Name *load* must not count as an assignment."""
    names = set(_target_names(getattr(loop, "target", None)))
    for sub in ast.walk(loop):
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                            ast.NamedExpr)):
            names.update(_target_names(sub))
        elif isinstance(sub, ast.For):
            names.update(_target_names(sub.target))
        elif isinstance(sub, ast.With):
            names.update(_with_targets(sub))
    return names


def _target_names(node: ast.AST | None) -> set[str]:
    names: set[str] = set()
    if node is None:
        return names
    targets: list[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
        targets = [node.target]
    elif isinstance(node, (ast.Name, ast.Tuple, ast.List, ast.Starred)):
        targets = [node]
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                names.add(sub.id)
    return names


def _header_exprs(stmt: ast.stmt) -> list[ast.AST]:
    if isinstance(stmt, ast.For):
        return [stmt.iter]
    if isinstance(stmt, (ast.While, ast.If)):
        return [stmt.test]
    if isinstance(stmt, ast.With):
        return [item.context_expr for item in stmt.items]
    return []


def _sub_blocks(stmt: ast.stmt) -> list[list[ast.stmt]]:
    if isinstance(stmt, ast.If):
        return [stmt.body, stmt.orelse]
    if isinstance(stmt, ast.With):
        return [stmt.body]
    if isinstance(stmt, ast.Try):
        blocks = [stmt.body, stmt.orelse, stmt.finalbody]
        blocks.extend(h.body for h in stmt.handlers)
        return blocks
    return []


def _with_targets(stmt: ast.stmt) -> set[str]:
    names: set[str] = set()
    if isinstance(stmt, ast.With):
        for item in stmt.items:
            names.update(_target_names(item.optional_vars))
    return names
