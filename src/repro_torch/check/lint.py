"""Repo-custom AST lint (repro_torch.check, component 6).

Six rules that encode repo conventions generic linters cannot know, run
over every ``.py`` under ``src/repro_torch/``.  The first five are the JAX
package's, with its lists of sanctioned modules (the port has a module at
each of those paths); the sixth is the port's own:

* ``raw-byte-math`` — wire-byte / link-time arithmetic
  (``.itemsize`` or an ``itemsize`` variable, ``.beta`` / ``.bandwidth``
  inside a binary expression) outside the sanctioned modules.  Every
  byte account goes through :class:`EdgeCostModel`; a stray
  ``numel * itemsize`` elsewhere is exactly the estimator/simulator
  divergence that model exists to kill.  Sanctioned: the cost model, the
  encoding arithmetic it delegates to, the profile layer that derives
  itemsize, the α–β primitives, and the migration byte accounting.
* ``wallclock-in-sim`` — ``time.time()`` anywhere in ``core/`` or
  ``elastic/``.  Those layers run on the simulated clock; a wall-clock
  read silently couples sim results to host speed.  (The ``launch/``
  entry points are wall-clock programs and are exempt.)
* ``bare-print`` — ``print()`` outside a ``main`` function, an
  ``if __name__ == "__main__"`` block, or a ``__main__.py`` entry
  module.  Library output goes through ``repro_torch.obs``; prints in
  import-time or library code corrupt piped CLI output.
* ``kernel-dispatch-bypass`` — a ``topk_mask``/``topk_select`` call with
  no ``use_kernel=`` keyword inside ``distributed/`` or ``core/rad.py``.
  Those are the step's hot paths: compression there must flow through the
  kernel dispatch policy so the CUDA kernels (and their pricing
  telemetry) are reachable; a bare call silently pins the legacy global
  top-k and makes the planner's ``compress_seconds`` term a lie.
* ``missing-module-docstring`` — a module under ``serving/`` with no
  docstring.  The serving package is the newest subsystem and
  ``docs/architecture.md`` links into it by module purpose; every file
  there must say what it is for.
* ``foreign-import`` — an ``import jax…`` / ``from jax…`` or an
  ``import repro…`` / ``from repro…`` (other than ``repro_torch``).  The
  port stands alone: it imports neither JAX nor the JAX package, not even
  a module there that uses no framework.

Findings use code=rule and ``where="path:line"`` so CI can upload them
as an artifact and tests can key on them.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional, Sequence, Tuple

from .errors import CheckError, Finding, raise_findings

# modules allowed to do raw itemsize arithmetic (profile/encoding layer)
_ITEMSIZE_OK = {
    "core/costmodel.py", "core/compression.py", "core/opgraph.py",
    "elastic/replan.py", "serving/costs.py",
}
# modules allowed to touch .beta / .bandwidth in arithmetic (α–β layer)
_LINKMATH_OK = {
    "core/costmodel.py", "core/estimator.py", "core/network.py",
}
_WALLCLOCK_SCOPES = ("core/", "elastic/", "serving/")
_LINK_ATTRS = {"beta", "bandwidth"}
# hot-path modules where compression calls must honour the kernel dispatch
# policy (pass use_kernel= through) instead of silently pinning the plain
# global top-k
_DISPATCH_SCOPES = ("distributed/", "core/rad.py")
_DISPATCH_FNS = {"topk_mask", "topk_select"}
# packages where every module must open with a docstring
_DOCSTRING_SCOPES = ("serving/",)
# top-level packages the port must not import
_FOREIGN_PACKAGES = ("jax", "repro")


class LintError(CheckError):
    """Repo-convention lint rule violated."""


def _is_itemsize(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "itemsize") \
        or (isinstance(node, ast.Name) and node.id == "itemsize")


def _is_link_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr in _LINK_ATTRS


def _is_main_guard(node: ast.AST) -> bool:
    if not isinstance(node, ast.If):
        return False
    t = node.test
    return isinstance(t, ast.Compare) \
        and isinstance(t.left, ast.Name) and t.left.id == "__name__"


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.findings: List[Finding] = []
        self._fn_stack: List[str] = []
        self._guard_depth = 0
        self.itemsize_ok = rel in _ITEMSIZE_OK
        self.linkmath_ok = rel in _LINKMATH_OK
        self.sim_scope = rel.startswith(_WALLCLOCK_SCOPES)
        self.dispatch_scope = rel.startswith(_DISPATCH_SCOPES)
        # a __main__.py IS the CLI entry point — all of it is "main"
        self.entry_point = rel.endswith("__main__.py")

    def _hit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(
            Finding(rule, f"{self.rel}:{node.lineno}", msg))

    # ---------------------------------------------------- scope tracking --
    def visit_FunctionDef(self, node):
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_If(self, node):
        if _is_main_guard(node):
            self._guard_depth += 1
            self.generic_visit(node)
            self._guard_depth -= 1
        else:
            self.generic_visit(node)

    # ------------------------------------------------------------- rules --
    def visit_BinOp(self, node):
        for side in (node.left, node.right):
            if not self.itemsize_ok and _is_itemsize(side):
                self._hit("raw-byte-math", node,
                          "itemsize arithmetic outside the cost-model "
                          "layer — derive bytes via EdgeCostModel / "
                          "wire_bytes instead")
            if not self.linkmath_ok and _is_link_attr(side):
                self._hit("raw-byte-math", node,
                          f".{side.attr} arithmetic outside the α–β "
                          "layer — price transfers via LinkSpec.time / "
                          "EdgeCostModel instead")
        self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        if self.sim_scope and isinstance(f, ast.Attribute) \
                and f.attr == "time" and isinstance(f.value, ast.Name) \
                and f.value.id == "time":
            self._hit("wallclock-in-sim", node,
                      "time.time() in a sim-clock layer — thread the "
                      "simulated clock through instead")
        if isinstance(f, ast.Name) and f.id == "print" \
                and "main" not in self._fn_stack and not self._guard_depth \
                and not self.entry_point:
            self._hit("bare-print", node,
                      "bare print() in library code — route output "
                      "through repro_torch.obs or a main() entry point")
        if self.dispatch_scope:
            name = f.id if isinstance(f, ast.Name) else \
                (f.attr if isinstance(f, ast.Attribute) else None)
            if name in _DISPATCH_FNS and not any(
                    kw.arg == "use_kernel" for kw in node.keywords):
                self._hit("kernel-dispatch-bypass", node,
                          f"{name}() on a hot path without use_kernel= — "
                          "thread the kernel dispatch policy through so "
                          "the CUDA kernels and their cost telemetry "
                          "stay reachable")
        self.generic_visit(node)

    def _foreign(self, node: ast.AST, module: str) -> None:
        top = module.split(".", 1)[0]
        if top in _FOREIGN_PACKAGES:
            self._hit("foreign-import", node,
                      f"import of {module!r} — the port imports neither "
                      "JAX nor the JAX package")

    def visit_Import(self, node):
        for alias in node.names:
            self._foreign(node, alias.name)

    def visit_ImportFrom(self, node):
        if node.level == 0 and node.module:
            self._foreign(node, node.module)


def lint_source(source: str, rel: str) -> List[Finding]:
    """Lint one file's source; ``rel`` is its path relative to
    ``src/repro_torch`` (posix separators)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("syntax-error", f"{rel}:{e.lineno or 0}",
                        f"cannot parse: {e.msg}")]
    v = _Visitor(rel)
    v.visit(tree)
    if rel.startswith(_DOCSTRING_SCOPES) and ast.get_docstring(tree) is None:
        v.findings.append(Finding(
            "missing-module-docstring", f"{rel}:1",
            "serving module without a docstring — state the module's "
            "purpose so docs/architecture.md stays navigable"))
    return v.findings


def repro_root() -> str:
    """The ``src/repro_torch`` package directory this module is installed
    in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_tree(root: Optional[str] = None) -> List[Finding]:
    """Lint every ``.py`` under ``root`` (default: the live
    ``src/repro_torch`` package), findings sorted by location."""
    root = root or repro_root()
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                findings += lint_source(f.read(), rel)
    return findings


def verify_lint(root: Optional[str] = None,
                strict: bool = False) -> List[Finding]:
    return raise_findings(lint_tree(root), LintError,
                          "repo-convention lint failed", strict=strict)
