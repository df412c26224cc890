"""AST lint engine with project-wide round-reachability
(``repro.analysis.lint``, for the PyTorch port).

The linter parses every Python file under the requested paths into a
:class:`Project`: per-module import tables, an index of every function
and lambda (keyed by dotted qualname), and a call graph. The scopes that
run inside a round or a step become *roots*:

- function-valued arguments of the round and step entry points
  (``rounds.run_rounds``/``loop_rounds``/``run_feature_rounds``, the
  ``Topology.weighted_sum``/``feature_sum`` client functions,
  ``with_comm_carry``, ``torch.func.vmap``/``grad``/``grad_and_value``/
  ``vjp``/``jvp``/``functional_call``, ``torch.utils.checkpoint.
  checkpoint``);
- ``forward``/``backward`` of every ``torch.autograd.Function``;
- the closures that the step factories return (``make_train_step``,
  ``make_constrained_train_step``, ``make_decode_step``,
  ``sharded_train_step``, ``sharded_decode_step``), followed through a
  returned call to another factory.

Reachability is the fixpoint closure of the call graph from those roots,
with host boundaries excluded: a function handed to ``threading.Thread``
(the metric stream's drainer) and the sinks' methods are host code by
construction.

Rules (``repro_torch.analysis.rules``) receive each module plus the
project and yield :class:`Finding`s. Per-line suppression::

    x.item()  # flint: disable=FLT001 (the reason)
    anything  # flint: disable        (all rules on this line)

Reports render as text (``path:line:col CODE message``) or JSON.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Iterator

# Final attribute names whose function-valued call arguments run inside a
# round or a step: the round drivers, the Topology aggregation methods
# (their client functions), ``with_comm_carry`` (the body it wraps into
# the step), torch.func's transforms and activation checkpointing.
ROOT_ENTRY_NAMES = frozenset({
    "run_rounds", "loop_rounds", "run_feature_rounds", "weighted_sum",
    "feature_sum", "with_comm_carry", "vmap", "grad", "grad_and_value",
    "vjp", "jvp", "functional_call", "checkpoint",
})

# step factories: the closures they return run every step
STEP_FACTORIES = frozenset({
    "make_train_step", "make_constrained_train_step", "make_decode_step",
    "sharded_train_step", "sharded_decode_step",
})

# Calls whose function-valued arguments run on the host, beside the rounds:
# passing a fn here must not mark it reachable.
HOST_BOUNDARY_NAMES = frozenset({"Thread"})
# modules whose code is host code by construction (the sinks)
HOST_MODULES = ("repro_torch.obs.sinks",)
# the model interface (``models/api.py``): ``model.loss_fn(...)`` and the
# rest call the family modules' functions of these names
MODEL_FIELDS = frozenset({"init", "loss_fn", "prefill", "decode_step",
                          "init_cache", "param_specs", "cache_specs"})
MODEL_MODULES = "repro_torch.models."

_SUPPRESS_RE = re.compile(r"#\s*flint:\s*disable(?:=([A-Za-z0-9_,]+(?:\s*,\s*[A-Za-z0-9_]+)*))?")
# file-level marker (first 10 lines): `# flint: scope=kernel` opts a module
# outside repro_torch.kernels/comm into the strict kernel/codec dtype rules
_SCOPE_RE = re.compile(r"#\s*flint:\s*scope=(\w+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str
    suppressed: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.code} {self.message}"


@dataclasses.dataclass
class Scope:
    """One function/lambda body, the unit of round-reachability."""

    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    module: "Module"

    @property
    def key(self) -> tuple[str, str]:
        return (self.module.name, self.qualname)

    def own_nodes(self) -> Iterator[ast.AST]:
        """Walk this scope's body, excluding nested function/lambda bodies."""
        body = self.node.body if isinstance(self.node.body, list) else [self.node.body]
        stack: list[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    yield child  # the def executes here; its body is a separate scope
                    continue
                stack.append(child)


class Module:
    def __init__(self, path: Path, name: str, source: str):
        self.path = path
        self.name = name
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.lines = source.splitlines()
        # alias -> fully dotted target ("F" -> "torch.nn.functional",
        # "fed" -> "repro.core.fed", "sample_round" -> "repro.core.fed.sample_round")
        self.imports: dict[str, str] = {}
        self.scopes: dict[str, Scope] = {}
        # qualname of the scope lexically enclosing each scope ("" = module)
        self.scope_parent: dict[str, str] = {}
        # method name -> [qualname] for name-based virtual dispatch
        self.methods: dict[str, list[str]] = {}
        self.suppressions = self._parse_suppressions()
        self.scope_marker = next(
            (m.group(1) for line in self.lines[:10]
             if (m := _SCOPE_RE.search(line))), None)
        self._index()

    def _parse_suppressions(self) -> dict[int, frozenset[str] | None]:
        out: dict[int, frozenset[str] | None] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                codes = m.group(1)
                out[i] = frozenset(c.strip().upper() for c in codes.split(",") if c.strip()) if codes else None
        return out

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        self.imports[top] = top
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if a.name != "*":
                        self.imports[a.asname or a.name] = f"{node.module}.{a.name}"

        def visit(node: ast.AST, prefix: str, in_class: str | None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = f"{prefix}{child.name}"
                    self.scopes[qn] = Scope(qn, child, self)
                    self.scope_parent[qn] = prefix[:-1] if prefix else ""
                    if in_class:
                        self.methods.setdefault(child.name, []).append(qn)
                    visit(child, f"{qn}.", None)
                elif isinstance(child, ast.Lambda):
                    qn = f"{prefix}<lambda@{child.lineno}:{child.col_offset}>"
                    self.scopes[qn] = Scope(qn, child, self)
                    self.scope_parent[qn] = prefix[:-1] if prefix else ""
                    visit(child, f"{qn}.", None)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.", child.name)
                else:
                    visit(child, prefix, in_class)

        visit(self.tree, "", None)
        # map every AST node id to its innermost enclosing scope qualname
        self.node_scope: dict[int, str] = {}
        for qn, scope in self.scopes.items():
            for n in scope.own_nodes():
                self.node_scope[id(n)] = qn

    def enclosing_scope(self, node: ast.AST) -> str:
        return self.node_scope.get(id(node), "")

    def qualname_of(self, node: ast.AST) -> str:
        """The qualname of a def node."""
        for qn, scope in self.scopes.items():
            if scope.node is node:
                return qn
        return ""

    def class_prefix(self, node: ast.ClassDef) -> str:
        """The qualname prefix of a class's enclosing scope ("" at module
        level)."""
        outer = self.enclosing_scope(node)
        return f"{outer}." if outer else ""

    def dotted(self, node: ast.AST) -> str | None:
        """Resolve a Name/Attribute expression to a fully dotted path."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.imports.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def is_suppressed(self, line: int, code: str) -> bool:
        codes = self.suppressions.get(line, False)
        if codes is False:
            return False
        return codes is None or code.upper() in codes


class Project:
    """All linted modules plus the round-reachability fixpoint."""

    def __init__(self, files: list[Path], root: Path):
        self.root = root
        self.modules: dict[str, Module] = {}
        self.errors: list[Finding] = []
        for f in files:
            name = _module_name(f, root)
            try:
                self.modules[name] = Module(f, name, f.read_text())
            except SyntaxError as e:
                self.errors.append(Finding(str(f), e.lineno or 0, e.offset or 0,
                                           "FLT000", f"syntax error: {e.msg}"))
        self.methods: dict[str, list[tuple[str, str]]] = {}
        for mod in self.modules.values():
            for mname, qns in mod.methods.items():
                self.methods.setdefault(mname, []).extend((mod.name, q) for q in qns)
        self.reachable: set[tuple[str, str]] = set()
        self._compute_reachability()

    # -- resolution ------------------------------------------------------

    def resolve_function(self, expr: ast.AST, module: Module, scope_qn: str
                         ) -> list[tuple[str, str]]:
        """Resolve a function-valued expression to candidate scope keys."""
        if isinstance(expr, ast.Lambda):
            qn = f"<lambda@{expr.lineno}:{expr.col_offset}>"
            for cand, sc in module.scopes.items():
                if sc.node is expr:
                    return [(module.name, cand)]
            return []
        if isinstance(expr, ast.Name):
            # lexical lookup: nested defs of enclosing scopes, then module level
            chain = []
            cur = scope_qn
            while cur:
                chain.append(cur)
                cur = module.scope_parent.get(cur, "")
            for outer in chain:
                cand = f"{outer}.{expr.id}"
                if cand in module.scopes:
                    return [(module.name, cand)]
            if expr.id in module.scopes:
                return [(module.name, expr.id)]
            target = module.imports.get(expr.id)
            if target:
                mod_name, _, fn = target.rpartition(".")
                if mod_name in self.modules and fn in self.modules[mod_name].scopes:
                    return [(mod_name, fn)]
            return []
        if isinstance(expr, ast.Attribute):
            dotted = module.dotted(expr)
            if dotted:
                mod_name, _, fn = dotted.rpartition(".")
                if mod_name in self.modules and fn in self.modules[mod_name].scopes:
                    return [(mod_name, fn)]
            # virtual dispatch by method name (topo.weighted_sum, codec.encode, …)
            if expr.attr in self.methods:
                return list(self.methods[expr.attr])
            # the model interface: model.loss_fn -> each family's loss_fn
            if expr.attr in MODEL_FIELDS:
                return [(m, expr.attr) for m, mod in self.modules.items()
                        if m.startswith(MODEL_MODULES) and expr.attr in mod.scopes]
        return []

    # -- reachability ----------------------------------------------------

    def _compute_reachability(self) -> None:
        roots: set[tuple[str, str]] = set()
        for mod in self.modules.values():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) and _is_autograd_function(node, mod):
                    for qn in (f"{mod.class_prefix(node)}{node.name}.forward",
                               f"{mod.class_prefix(node)}{node.name}.backward"):
                        if qn in mod.scopes:
                            roots.add((mod.name, qn))
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and node.name in STEP_FACTORIES):
                    qn = mod.qualname_of(node)
                    if qn in mod.scopes:
                        roots.update(self._returned_closures(mod, qn, depth=3))
                if isinstance(node, ast.Call):
                    name = _final_name(node.func)
                    if name in ROOT_ENTRY_NAMES:
                        scope_qn = mod.enclosing_scope(node)
                        for arg in list(node.args) + [k.value for k in node.keywords]:
                            for key in self.resolve_function(arg, mod, scope_qn):
                                roots.add(key)

        roots = {k for k in roots if not k[0].startswith(HOST_MODULES)}
        self.reachable = set(roots)
        work = list(roots)
        while work:
            mod_name, qn = work.pop()
            mod = self.modules.get(mod_name)
            if mod is None or qn not in mod.scopes:
                continue
            scope = mod.scopes[qn]
            new: set[tuple[str, str]] = set()
            for node in scope.own_nodes():
                if not isinstance(node, ast.Call):
                    continue
                name = _final_name(node.func)
                if name in HOST_BOUNDARY_NAMES:
                    continue
                new.update(self.resolve_function(node.func, mod, qn))
                # fn-valued args passed onward from a reachable scope
                # (e.g. client fn handed to topo.weighted_sum)
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    new.update(self.resolve_function(arg, mod, qn))
            for key in new:
                if key not in self.reachable and not key[0].startswith(HOST_MODULES):
                    self.reachable.add(key)
                    work.append(key)

    def _returned_closures(self, mod: "Module", qn: str, depth: int) -> set:
        """The scopes a factory returns: a nested function returned by
        name, or, for a returned call, what the called factory returns."""
        out: set[tuple[str, str]] = set()
        if depth == 0:
            return out
        for node in mod.scopes[qn].own_nodes():
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            value = node.value
            if isinstance(value, ast.Call):
                for m2, q2 in self.resolve_function(value.func, mod, qn):
                    out.update(self._returned_closures(self.modules[m2], q2,
                                                       depth - 1))
            else:
                out.update(self.resolve_function(value, mod, qn))
        return out

    def is_reachable(self, module: Module, qualname: str) -> bool:
        return (module.name, qualname) in self.reachable


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    suppressed: list[Finding]
    files_checked: int

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_json(self) -> str:
        return json.dumps({
            "files_checked": self.files_checked,
            "num_findings": len(self.findings),
            "num_suppressed": len(self.suppressed),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
        }, indent=2)

    def render_text(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(f"{len(self.findings)} finding(s), "
                     f"{len(self.suppressed)} suppressed, "
                     f"{self.files_checked} file(s) checked")
        return "\n".join(lines)


def _is_autograd_function(node: ast.ClassDef, module: "Module") -> bool:
    """A class deriving from ``torch.autograd.Function``."""
    for base in node.bases:
        dotted = module.dotted(base) or ""
        if dotted in ("torch.autograd.Function", "torch.autograd.function.Function"):
            return True
    return False


def _final_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _module_name(path: Path, root: Path) -> str:
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        return path.stem
    parts = list(rel.with_suffix("").parts)
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or path.stem


def discover_files(paths: Iterable[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(f for f in p.rglob("*.py") if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            files.append(p)
    return files


def lint_paths(paths: Iterable[Path], root: Path | None = None,
               rules: Iterable | None = None) -> LintResult:
    """Lint the given files/directories; returns findings + suppressions."""
    from repro_torch.analysis.rules import ALL_RULES

    paths = [Path(p) for p in paths]
    root = Path(root) if root is not None else _find_repo_root(paths)
    files = discover_files(paths)
    project = Project(files, root)
    active_rules = list(rules) if rules is not None else [r() for r in ALL_RULES]

    findings: list[Finding] = list(project.errors)
    suppressed: list[Finding] = []
    for mod in project.modules.values():
        for rule in active_rules:
            for f in rule.check_module(mod, project):
                if mod.is_suppressed(f.line, f.code):
                    suppressed.append(dataclasses.replace(f, suppressed=True))
                else:
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return LintResult(findings, suppressed, len(files))


def _find_repo_root(paths: list[Path]) -> Path:
    for p in paths:
        cur = p.resolve()
        if cur.is_file():
            cur = cur.parent
        while cur != cur.parent:
            if (cur / "pyproject.toml").exists() or (cur / ".git").exists():
                return cur
            cur = cur.parent
    return Path.cwd()
