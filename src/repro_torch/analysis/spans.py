"""Async-span lifecycle check (pass ``span``; port of
``repro/analysis/spans.py``): every async trace span can reach exactly its
declared terminal states.

The freeze and offload lifecycles are state machines: a page freeze ends
``installed``, ``dropped``, ``rolled_back`` or ``offloaded``; a page
offload ends ``restored``. The launcher's reconciliation
(``launch.serve._trace_reconcile``) checks counts on traced runs only;
this pass is its static complement: it collects every
``async_begin``/``async_end`` call site and checks that the sites realize
exactly the declared terminal-state set.

  SPAN001  the terminal states at async_end sites differ from the declared
           machine (a missing state is a lifecycle that can never close
           that way; an undeclared one a typo the reconciliation would
           count into nothing)
  SPAN002  async_end of a declared machine without a literal ``state=``
           (span names outside ``MACHINES``, plain spans like "prefill",
           are exempt)
  SPAN003  async_begin with no async_end call site anywhere
  SPAN004  async_end with no async_begin call site anywhere

Only string-literal span names take part: a dynamically named span is
invisible to a static check and out of its scope.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Mapping

from .lint import Finding, LintPass, Module, register

#: declared lifecycles: span name -> the exact set of terminal states its
#: async_end sites must cover (``serving/workers.py``'s machines:
#: page_freeze queued -> dispatched -> installed | dropped | rolled_back |
#: offloaded, page_offload -> restored)
MACHINES: dict[str, frozenset[str]] = {
    "page_freeze": frozenset(
        {"installed", "dropped", "rolled_back", "offloaded"}),
    "page_offload": frozenset({"restored"}),
}


@dataclasses.dataclass
class _Site:
    relpath: str
    line: int
    state: str | None          # literal state= value, if any
    has_state: bool            # a state= kwarg exists (literal or not)
    state_literal: bool


def _span_name(call: ast.Call) -> str | None:
    """async_begin(track, name, ...) / async_end(track, name, ...)."""
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    return None


@register
class SpanLifecyclePass(LintPass):
    name = "span"
    description = ("async_begin/async_end sites must realize exactly the "
                   "declared page_freeze/page_offload terminal states")

    def __init__(self, machines: Mapping[str, frozenset[str]] | None = None):
        self.machines = dict(MACHINES if machines is None else machines)
        self._begins: dict[str, list[_Site]] = {}
        self._ends: dict[str, list[_Site]] = {}

    def check_module(self, mod: Module) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("async_begin", "async_end")):
                continue
            name = _span_name(node)
            if name is None:
                continue
            state, has_state, literal = None, False, False
            for kw in node.keywords:
                if kw.arg == "state":
                    has_state = True
                    if isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str):
                        state, literal = kw.value.value, True
            site = _Site(mod.relpath, node.lineno, state, has_state, literal)
            bucket = (self._begins if node.func.attr == "async_begin"
                      else self._ends)
            bucket.setdefault(name, []).append(site)
        return ()

    def finish(self) -> Iterable[Finding]:
        for name, sites in sorted(self._begins.items()):
            if name not in self._ends:
                s = sites[0]
                yield Finding(
                    s.relpath, s.line, "SPAN003", self.name,
                    f"async_begin({name!r}) has no async_end call site "
                    f"anywhere: the span can never close")
        for name, sites in sorted(self._ends.items()):
            if name not in self._begins:
                s = sites[0]
                yield Finding(
                    s.relpath, s.line, "SPAN004", self.name,
                    f"async_end({name!r}) has no async_begin call site "
                    f"anywhere")

        for name, declared in sorted(self.machines.items()):
            begins = self._begins.get(name, [])
            ends = self._ends.get(name, [])
            if not begins and not ends:
                continue
            realized: set[str] = set()
            for s in ends:
                if not s.has_state or (s.has_state and not s.state_literal):
                    yield Finding(
                        s.relpath, s.line, "SPAN002", self.name,
                        f"async_end({name!r}) must carry a literal state= "
                        f"naming one of the declared terminal states "
                        f"({', '.join(sorted(declared))})")
                    continue
                realized.add(s.state)  # type: ignore[arg-type]
                if s.state not in declared:
                    yield Finding(
                        s.relpath, s.line, "SPAN001", self.name,
                        f"async_end({name!r}) closes with undeclared state "
                        f"{s.state!r}; declared terminal states: "
                        f"{', '.join(sorted(declared))}")
            missing = declared - realized
            if missing and begins:
                s = begins[0]
                yield Finding(
                    s.relpath, s.line, "SPAN001", self.name,
                    f"span {name!r} never reaches declared terminal "
                    f"state(s) {', '.join(sorted(missing))}: no async_end "
                    f"site closes with them")
