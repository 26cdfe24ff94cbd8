"""Framework for the port's stdlib-``ast`` lint passes (port of
``repro/analysis/lint.py``).

The serving stack rests on conventions that a test run alone does not
hold: no host sync in the decode hot loop, every async freeze/offload span
reaching exactly one declared terminal state, and stringly-typed counter
names resolving to a registration site. The passes of this package
(``hostsync``: ``sync``; ``spans``: ``span``; ``counters``: ``counter``)
turn them into findings; this module is their shared machinery:

  Module      parsed source file (AST + parent links + pragma map)
  Finding     one diagnostic, with a line-independent fingerprint
  LintPass    base class; ``register`` adds subclasses to the registry
  run_passes  drive the selected passes over a file set, apply pragma
              suppression, and emit pragma-hygiene findings
  baseline    a committed fingerprint set; only findings not in it fail

Pragma syntax (a suppression carries its reason)::

    nxt = last.argmax(-1).cpu().numpy()  # lint: sync(step-end token sync)

A pragma on line L suppresses that pass's findings anchored at L or L+1
(so it can sit on its own line above a long statement). Several pragmas
separate with commas: ``# lint: sync(reason), span(reason)``. A pragma
with an empty reason, an unknown pass name, or that suppresses nothing is
itself a finding (LINT001/LINT002/LINT003).
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Iterable, Iterator

# --------------------------------------------------------------- findings


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic. The fingerprint deliberately excludes the line
    number so committed baselines don't churn when unrelated edits move
    code; ``message`` must therefore be stable (name things, not lines)."""

    path: str          # posix path as scanned (repo-relative in CI)
    line: int
    code: str          # e.g. "SYNC001"
    pass_name: str     # registry name of the emitting pass
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.path}:{self.code}:{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} [{self.pass_name}] " \
               f"{self.message}"

    def to_json(self) -> dict:
        return {"path": self.path, "line": self.line, "code": self.code,
                "pass": self.pass_name, "message": self.message}


# --------------------------------------------------------------- pragmas

_PRAGMA_RE = re.compile(r"#\s*lint:\s*(?P<body>.+)$")
_PRAGMA_ITEM_RE = re.compile(r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
                             r"\((?P<reason>[^()]*)\)")


@dataclasses.dataclass
class Pragma:
    line: int
    pass_name: str
    reason: str
    used: bool = False


def parse_pragmas(source: str) -> list[Pragma]:
    """Pragmas from real COMMENT tokens only: pragma examples quoted in
    docstrings do not count (tokenize, not a line regex)."""
    out: list[Pragma] = []
    toks = tokenize.generate_tokens(io.StringIO(source).readline)
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if not m:
            continue
        for item in _PRAGMA_ITEM_RE.finditer(m.group("body")):
            out.append(Pragma(tok.start[0], item.group("name"),
                              item.group("reason").strip()))
    return out


# --------------------------------------------------------------- modules


class Module:
    """One parsed source file handed to every pass.

    ``relpath`` is the path as given on the command line (posix-ified):
    fingerprints embed it, so scans must address files the same way (the
    command line and the self-check test both scan ``src/repro_torch``
    from the repository root). Every AST node gets a ``parent`` link
    before the passes run.
    """

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=relpath)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child.parent = node  # type: ignore[attr-defined]
        self.pragmas = parse_pragmas(source)
        self._by_line: dict[tuple[int, str], Pragma] = {
            (p.line, p.pass_name): p for p in self.pragmas}

    @classmethod
    def load(cls, path: Path, relpath: str | None = None) -> "Module":
        rel = relpath if relpath is not None else path.as_posix()
        return cls(path, rel, path.read_text())

    def suppressing_pragma(self, pass_name: str, line: int) -> Pragma | None:
        """The pragma (if any) covering a finding of ``pass_name`` at
        ``line``: same line, or the line directly above."""
        for ln in (line, line - 1):
            p = self._by_line.get((ln, pass_name))
            if p is not None:
                return p
        return None


def enclosing_function(node: ast.AST) -> ast.AST | None:
    """Nearest FunctionDef/AsyncFunctionDef ancestor, if any."""
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def dotted_name(node: ast.AST) -> str | None:
    """'torch.cuda.synchronize' for Attribute chains / Names; None for
    anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ----------------------------------------------------------- pass registry


class LintPass:
    """Base class. ``check_module`` runs once per file and may emit
    findings immediately; passes needing whole-program context collect in
    ``check_module`` and emit from ``finish`` (called once, after every
    module)."""

    name = ""
    description = ""

    def check_module(self, mod: Module) -> Iterable[Finding]:
        return ()

    def finish(self) -> Iterable[Finding]:
        return ()


PASSES: dict[str, type[LintPass]] = {}


def register(cls: type[LintPass]) -> type[LintPass]:
    assert cls.name and cls.name not in PASSES, cls
    PASSES[cls.name] = cls
    return cls


def all_passes() -> dict[str, type[LintPass]]:
    # the import registers the bundled passes, once
    from . import counters, hostsync, spans  # noqa: F401
    return PASSES


# ----------------------------------------------------------------- runner


def iter_python_files(paths: Iterable[str]) -> Iterator[tuple[Path, str]]:
    """(path, relpath) for every .py under ``paths``, deterministic order.

    ``relpath`` keeps the spelling given on the command line, so baseline
    fingerprints are stable across machines."""
    for raw in paths:
        p = Path(raw)
        if p.is_file():
            yield p, p.as_posix()
        else:
            for f in sorted(p.rglob("*.py")):
                yield f, f.as_posix()


def run_passes(modules: list[Module],
               passes: Iterable[type[LintPass]] | None = None,
               ) -> list[Finding]:
    """Run passes over the modules; returns pragma-filtered findings plus
    pragma-hygiene findings, sorted by (path, line, code)."""
    classes = list(passes) if passes is not None \
        else list(all_passes().values())
    raw: list[Finding] = []
    for cls in classes:
        inst = cls()
        for mod in modules:
            raw.extend(inst.check_module(mod))
        raw.extend(inst.finish())

    by_rel = {m.relpath: m for m in modules}
    kept: list[Finding] = []
    for f in raw:
        mod = by_rel.get(f.path)
        pragma = mod.suppressing_pragma(f.pass_name, f.line) if mod else None
        if pragma is None:
            kept.append(f)
        else:
            pragma.used = True

    known = {cls.name for cls in classes}
    for mod in modules:
        for p in mod.pragmas:
            if p.pass_name not in known:
                kept.append(Finding(
                    mod.relpath, p.line, "LINT002", "pragma",
                    f"pragma names unknown pass {p.pass_name!r} "
                    f"(known: {', '.join(sorted(known))})"))
            elif not p.reason:
                kept.append(Finding(
                    mod.relpath, p.line, "LINT001", "pragma",
                    f"pragma {p.pass_name!r} must carry a reason: "
                    f"# lint: {p.pass_name}(why this is safe)"))
            elif not p.used:
                kept.append(Finding(
                    mod.relpath, p.line, "LINT003", "pragma",
                    f"unused pragma {p.pass_name!r} at line {p.line} "
                    f"suppresses nothing; delete it"))
    return sorted(kept, key=lambda f: (f.path, f.line, f.code, f.message))


def run_paths(paths: Iterable[str],
              passes: Iterable[type[LintPass]] | None = None,
              ) -> list[Finding]:
    modules = [Module.load(p, rel) for p, rel in iter_python_files(paths)]
    return run_passes(modules, passes)


# --------------------------------------------------------------- baseline


def load_baseline(path: Path | None) -> set[str]:
    """Committed fingerprint set; a missing file is an empty baseline."""
    if path is None or not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("fingerprints", []))


def save_baseline(path: Path, findings: Iterable[Finding]) -> None:
    fps = sorted({f.fingerprint for f in findings})
    path.write_text(json.dumps(
        {"version": 1,
         "comment": "accepted repro_torch.analysis findings; regenerate "
                    "with `python -m repro_torch.analysis <paths> "
                    "--write-baseline`. Must stay empty for "
                    "src/repro_torch/serving and src/repro_torch/kernels.",
         "fingerprints": fps}, indent=2) + "\n")


def partition_baseline(findings: Iterable[Finding], baseline: set[str],
                       ) -> tuple[list[Finding], list[Finding]]:
    """(new, baselined): only ``new`` findings fail the check."""
    new: list[Finding] = []
    old: list[Finding] = []
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
