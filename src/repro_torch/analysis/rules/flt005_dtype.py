"""FLT005 — f64 and dtype-less constructors in kernel and codec code.

Scoped to ``repro_torch.kernels`` and ``repro_torch.comm`` (or a module
whose first 10 lines carry the flint marker ``scope=kernel``): the
kernels' C entries and
the wire formats pin exact dtypes (int8 values + fp32 scales, fp32 TopK
values + int32 indices, the kernels' fp32/bf16 operands), so a
``torch.float64`` / ``.double()`` mention or a constructor without a
dtype (``torch.zeros(n)`` takes the process's default dtype, which
``torch.set_default_dtype`` changes; ``torch.tensor(x)`` infers one from
x) silently widens a buffer, hands a kernel the wrong operand and doubles
the bytes on the wire. Host-side high-precision math (the RDP
accountant's ``np.float64``) lives outside these packages.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import Finding, Module, Project

_STRICT_PREFIXES = ("repro_torch.kernels", "repro_torch.comm")
_CTORS_NEED_DTYPE = {"zeros", "ones", "full", "empty", "arange", "tensor"}
_F64_NAMES = frozenset(("float" "64", "dou" "ble", "complex" "128"))


class DtypePromotionRule:
    code = "FLT005"
    name = "dtype-promotion"

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        if not (module.name.startswith(_STRICT_PREFIXES)
                or module.scope_marker == "kernel"):
            return
        path = str(module.path)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute) and node.attr in _F64_NAMES:
                dotted = module.dotted(node)
                if dotted and dotted.split(".")[0] in ("torch", "numpy"):
                    yield Finding(path, node.lineno, node.col_offset, self.code,
                                  f"'{dotted}' in kernel/codec code: the kernels and "
                                  "the wire are pinned to fp32/bf16/int8; f64 "
                                  "doubles the bytes and no kernel takes it")
            elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and node.value in _F64_NAMES):
                yield Finding(path, node.lineno, node.col_offset, self.code,
                              f"dtype string '{node.value}': the kernels and the "
                              "wire are pinned to fp32/bf16/int8")
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr == "double" and not node.args:
                    yield Finding(path, node.lineno, node.col_offset, self.code,
                                  ".double() in kernel/codec code widens to f64")
                    continue
                if node.func.attr not in _CTORS_NEED_DTYPE:
                    continue
                dotted = module.dotted(node.func)
                if not dotted or dotted.split(".")[0] != "torch":
                    continue
                if not any(k.arg == "dtype" for k in node.keywords):
                    yield Finding(
                        path, node.lineno, node.col_offset, self.code,
                        f"'{dotted}' without an explicit dtype in kernel/codec "
                        "code takes the default or an inferred dtype; pin it "
                        "(e.g. dtype=torch.float32)")
