"""Counter-name check (pass ``counter``; port of
``repro/analysis/counters.py``): stringly-typed metric and summary keys
must resolve to a registration site.

The streaming registry (``obs.stats.Registry``) is get-or-create: a
misspelt ``histogram("itl_z")`` silently creates an empty metric and
every read of it is zero. Summary dicts fail the same way: ``s.get(
"typo", 0)`` reads 0 forever. This pass cross-references every
literal-keyed read against the registrations that feed data:

  registrations
    * str keys of dict literals / ``d[k] =`` stores / ``.update(...)``
      kwargs inside summary-producing functions (``summary``,
      ``_summary``, ``snapshot``)
    * str keys of dict literals assigned to a ``.counters`` attribute
      (the per-worker counter dicts merged into engine summaries)
    * ``.counter("x")`` / ``.gauge("x")`` / ``.histogram("x")`` lookups
      written through at once (``.inc()``/``.set()``/``.observe()``):
      the ingestion side of the get-or-create registry
    * ``.admission("reason")`` calls (reasons surface as summary keys)

  usages (each must resolve)
    * literal subscript reads / ``.get("k")`` on summary-typed locals
      (assigned from ``.summary()``/``.snapshot()``/``.run()``, or
      parameters named ``s``/``summary``/``snap``/``snapshot``/
      ``counters``)
    * literal subscript reads and ``+=`` updates on ``.counters`` dicts
    * registry ``.counter/.gauge/.histogram`` lookups not written through
      (a reader of a histogram's window)

  CTR001  literal key read with no registration site

It audits the serving modules, ``obs/export.py`` and ``launch/serve.py``.
Dynamically computed keys are out of scope (skipped, not guessed).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from .lint import (Finding, LintPass, Module, dotted_name,
                   enclosing_function, register)

#: the modules whose stringly-typed metric/summary keys are audited
_AUDIT_MARKERS = ("/serving/",)
_AUDIT_SUFFIXES = ("obs/export.py", "launch/serve.py")

_SUMMARY_FN_NAMES = ("summary", "_summary", "snapshot")
_SUMMARY_PRODUCERS = ("summary", "_summary", "snapshot", "run")
_SUMMARY_PARAM_NAMES = ("s", "summary", "snap", "snapshot", "counters")
_REGISTRY_CALLS = ("counter", "gauge", "histogram")
#: a registry lookup immediately chained into one of these is ingestion
_WRITE_METHODS = ("inc", "set", "observe", "add")


def is_audited(relpath: str) -> bool:
    return any(m in relpath for m in _AUDIT_MARKERS) \
        or relpath.endswith(_AUDIT_SUFFIXES)


@dataclasses.dataclass
class _Use:
    key: str
    relpath: str
    line: int
    what: str


def _str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_counters_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "counters"


class _Scope:
    """Summary-typed local names of one function (flow-insensitive)."""

    def __init__(self, fn: ast.AST | None, tree: ast.AST):
        self.names: set[str] = set()
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = fn.args
            for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
                if arg.arg in _SUMMARY_PARAM_NAMES:
                    self.names.add(arg.arg)
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr in _SUMMARY_PRODUCERS:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.names.add(tgt.id)


@register
class CounterNamePass(LintPass):
    name = "counter"
    description = ("stringly-typed counter/gauge/histogram/summary keys "
                   "must resolve to a registration site (a misspelt name "
                   "silently reads zero)")

    def __init__(self) -> None:
        self._registered: set[str] = set()
        self._used: list[_Use] = []

    # ------------------------------------------------------------ collect

    def check_module(self, mod: Module) -> Iterable[Finding]:
        if not is_audited(mod.relpath):
            return ()
        scopes: dict[int, _Scope] = {}
        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            scopes[id(fn)] = _Scope(fn, fn)
        module_scope = _Scope(None, mod.tree)

        def scope_of(node: ast.AST) -> _Scope:
            fn = enclosing_function(node)
            return scopes[id(fn)] if fn is not None else module_scope

        def in_summary_fn(node: ast.AST) -> bool:
            fn = enclosing_function(node)
            return fn is not None and fn.name in _SUMMARY_FN_NAMES

        def is_summary_dict(value: ast.AST, node: ast.AST) -> bool:
            if _is_counters_attr(value):
                return True
            return isinstance(value, ast.Name) \
                and value.id in scope_of(node).names

        for node in ast.walk(mod.tree):
            # ---- registrations
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Dict) \
                    and any(_is_counters_attr(t) for t in node.targets):
                for k in node.value.keys:
                    key = _str_const(k) if k is not None else None
                    if key:
                        self._registered.add(key)
            if isinstance(node, ast.Dict) and in_summary_fn(node):
                for k in node.keys:
                    key = _str_const(k) if k is not None else None
                    if key:
                        self._registered.add(key)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                arg0 = _str_const(node.args[0]) if node.args else None
                if attr in _REGISTRY_CALLS and arg0:
                    parent = getattr(node, "parent", None)
                    written = (isinstance(parent, ast.Attribute)
                               and parent.attr in _WRITE_METHODS)
                    if written:
                        self._registered.add(arg0)
                    else:
                        self._used.append(_Use(
                            arg0, mod.relpath, node.lineno,
                            f"registry .{attr}() lookup"))
                elif attr == "admission" and arg0:
                    self._registered.add(arg0)
                elif attr in ("update", "setdefault") \
                        and (in_summary_fn(node)
                             or is_summary_dict(node.func.value, node)):
                    for kw in node.keywords:
                        if kw.arg:
                            self._registered.add(kw.arg)
                    if attr == "update" and node.args \
                            and isinstance(node.args[0], ast.Dict):
                        for k in node.args[0].keys:
                            key = _str_const(k) if k is not None else None
                            if key:
                                self._registered.add(key)
                    if attr == "setdefault" and arg0:
                        self._registered.add(arg0)
                elif attr == "get" and node.args \
                        and is_summary_dict(node.func.value, node):
                    key = _str_const(node.args[0])
                    if key:
                        self._used.append(_Use(
                            key, mod.relpath, node.lineno, ".get() read"))
            # ---- subscripts on summary/counters dicts (any literal-key
            # store inside a summary-producing function registers, even on
            # a dict built locally from a literal)
            if isinstance(node, ast.Subscript):
                summaryish = is_summary_dict(node.value, node)
                key = _str_const(node.slice)
                if key is None:
                    continue
                parent = getattr(node, "parent", None)
                if isinstance(node.ctx, ast.Store) \
                        and not isinstance(parent, ast.AugAssign):
                    if summaryish or in_summary_fn(node):
                        self._registered.add(key)
                elif summaryish:
                    self._used.append(_Use(
                        key, mod.relpath, node.lineno, "subscript read"))
        return ()

    # ------------------------------------------------------------ resolve

    def finish(self) -> Iterable[Finding]:
        for use in self._used:
            if use.key not in self._registered:
                yield Finding(
                    use.relpath, use.line, "CTR001", self.name,
                    f"metric/summary key {use.key!r} ({use.what}) has no "
                    f"registration site: a misspelt name silently reads "
                    f"zero")
