"""ast-lint: source-level hazards no recorded run can show.

Pure ``ast`` over ``src/repro_torch/**`` and ``chip_smoke.py`` (nothing is
imported or run).  Four checks:

* **reference imports** — any ``import`` of ``jax``, ``jaxlib`` or
  ``repro``, at any depth: the port runs where neither is installed and
  keeps its own copies of what it needs;
* **CUDA work at import time** — a ``torch.cuda.*`` call, a ``.cuda()``,
  a CUDA ``device=`` or a kernel's ``build()`` / ``_load()`` in a module
  or class body (or a module-level ``if``/``try``): the tests import
  every module on hosts with no card, and a kernel is built inside the
  call that launches it;
* **module-level tensor constructors** — a tensor made at import lies
  outside ``FakeTensorMode``, which breaks the dry run's fake state (the
  port's counterpart of the reference's module-level ``jnp`` constant,
  which leaks a tracer);
* **mutable default arguments** — evaluated once at import and shared
  across calls.

Function bodies run at call time and are exempt from the import-time
checks.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.core import AnalysisPass, Finding, SEV_ERROR

_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
REFERENCE_MODULES = frozenset({"jax", "jaxlib", "repro"})
TENSOR_CONSTRUCTORS = frozenset({
    "tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full",
    "arange", "linspace", "logspace", "eye", "rand", "randn", "randint",
    "randperm", "zeros_like", "ones_like", "empty_like", "full_like",
    "rand_like", "randn_like", "empty_strided", "frombuffer"})
KERNEL_LOADERS = frozenset({"build", "_load"})


def _chain(func: ast.expr) -> List[str]:
    """Names of an attribute chain, root first: torch.cuda.x -> [torch,
    cuda, x]; [] when the root is not a plain name."""
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if not isinstance(func, ast.Name):
        return []
    return [func.id] + parts[::-1]


def _calls_outside_functions(stmt: ast.stmt) -> Iterator[ast.Call]:
    """Call nodes in a statement, not descending into nested functions
    (their bodies execute at call time, not import time)."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNCTION_NODES):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _cuda_device(call: ast.Call) -> bool:
    for kw in call.keywords:
        v = kw.value
        if kw.arg == "device" and isinstance(v, ast.Constant) \
                and isinstance(v.value, str) and v.value.startswith("cuda"):
            return True
    return False


class AstLintPass(AnalysisPass):
    name = "ast-lint"
    description = ("no jax/jaxlib/repro import, no CUDA work or tensor "
                   "made at import, no mutable default args in the port's "
                   "sources and chip_smoke.py")
    scope = "global"
    requires_record = False

    def __init__(self, roots: Optional[List[Path]] = None):
        if roots is None:
            import repro_torch
            pkg = Path(next(iter(repro_torch.__path__)))
            roots = [pkg]
            smoke = pkg.parent.parent / "chip_smoke.py"
            if smoke.exists():
                roots.append(smoke)
        self.roots = [Path(r) for r in roots]

    def _finding(self, code, filename, node, message, **details):
        return Finding(self.name, "<sources>", SEV_ERROR, code,
                       f"{filename}:{node.lineno}: {message}",
                       details={"file": filename, "line": node.lineno,
                                **details})

    def lint_source(self, src: str, filename: str) -> List[Finding]:
        findings: List[Finding] = []
        tree = ast.parse(src, filename=filename)

        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            for mod in mods:
                if mod.split(".")[0] in REFERENCE_MODULES:
                    findings.append(self._finding(
                        "reference-import", filename, node,
                        f"imports '{mod}': the port imports neither JAX "
                        f"nor the reference package", module=mod))

        for stmt in tree.body:
            if isinstance(stmt, _FUNCTION_NODES):
                continue
            for call in _calls_outside_functions(stmt):
                chain = _chain(call.func)
                text = ast.unparse(call.func)
                if chain[:2] == ["torch", "cuda"] or (
                        isinstance(call.func, ast.Attribute)
                        and call.func.attr == "cuda") or _cuda_device(call) \
                        or (chain[-1:] and chain[-1] in KERNEL_LOADERS):
                    findings.append(self._finding(
                        "import-cuda", filename, call,
                        f"'{text}(...)' runs at import: CUDA work belongs "
                        f"inside the call that launches a kernel",
                        call=text))
                elif chain[:1] == ["torch"] and len(chain) == 2 \
                        and chain[1] in TENSOR_CONSTRUCTORS:
                    findings.append(self._finding(
                        "module-tensor", filename, call,
                        f"module-level '{text}(...)': a tensor made at "
                        f"import lies outside FakeTensorMode (use a plain "
                        f"Python value)", call=text))

        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(d, ast.Call)
                    and isinstance(d.func, ast.Name)
                    and d.func.id in ("list", "dict", "set"))
                if mutable:
                    findings.append(self._finding(
                        "mutable-default", filename, d,
                        f"mutable default argument in '{node.name}': "
                        f"evaluated once at import and shared across calls",
                        function=node.name))
        return findings

    def _files(self) -> Iterator[Path]:
        for root in self.roots:
            if root.is_file():
                yield root
            else:
                yield from sorted(root.rglob("*.py"))

    def run(self, entrypoint: str, built: Any, ctx: Any
            ) -> Tuple[List[Finding], Dict[str, Any]]:
        findings: List[Finding] = []
        n_files = 0
        for path in self._files():
            n_files += 1
            rel = str(path)
            try:
                findings.extend(self.lint_source(path.read_text(), rel))
            except SyntaxError as e:
                findings.append(Finding(
                    self.name, "<sources>", SEV_ERROR, "syntax-error",
                    f"{rel}: {e}", details={"file": rel}))
        return findings, {"n_files": n_files,
                          "roots": [str(r) for r in self.roots]}
