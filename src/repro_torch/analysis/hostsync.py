"""Host-sync check of the port's hot path (the counterpart of the
reference's ``repro/analysis/hostsync.py``, pass ``sync``, for torch).

A call that makes the host wait for the card inside the engine's step, a
page freeze or a kernel wrapper stalls the host against the device, and a
CUDA graph admits none inside its capture. This check reads the hot
modules (``HOT_MODULES``, under ``src/repro_torch``) and flags, in every
function, each call of

  .item() .cpu() .tolist() .numpy()    a device value read by the host
  .synchronize()                       torch.cuda.synchronize, and the
                                       host's waits on an event or stream
  .to(<device>) .cuda()                on a tensor built on the host
                                       (``torch.as_tensor``, ``from_numpy``
                                       or ``tensor`` with no ``device=``,
                                       or a name the function assigned one
                                       to): a copy from pageable host
                                       memory, which waits for the stream
  torch.tensor / as_tensor(device=)    the same copy, made by the call

(``Event.wait`` and ``Stream.wait_event`` make a stream wait, on the card,
and are not flagged.) What it cannot see is a sync the code does not spell
as one of these calls (``int(t)``, ``bool(t)``, a copy of a host tensor
that reached the function as an argument). An intentional sync carries a
pragma with its reason, as a comment on the call's line or the line before
it::

    nxt = last.argmax(-1).cpu().numpy()   # lint: sync(step-end token sync)

A pragma that covers no call is reported as stale.

    python -m repro_torch.analysis.hostsync      # exit 1 on any finding
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import sys
import tokenize
from pathlib import Path

#: the modules the engine's step, a freeze and the kernel wrappers run
HOT_MODULES = (
    "serving/workers.py",
    "serving/kv_cache.py",
    "kernels/paged_attention.py",
    "kernels/quant_matmul.py",
    "kernels/page_quant.py",
    "kernels/fista_quant.py",
)
SYNC_CALLS = ("item", "cpu", "tolist", "numpy", "synchronize")
HOST_BUILDERS = ("as_tensor", "from_numpy", "tensor")
_DTYPES = {"float16", "bfloat16", "float32", "float64", "float", "half",
           "double", "int8", "uint8", "int16", "int32", "int64", "long",
           "int", "bool", "dtype"}
PACKAGE = Path(__file__).resolve().parents[1]

_PRAGMA = re.compile(r"#\s*lint:\s*sync\((?P<reason>[^)]*)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    what: str          # ".cpu()", ..., ".to() host-to-device", or
    #                    "stale pragma"
    reason: str | None = None      # the pragma's, if one covers it

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.what}"


def _pragmas(source: str) -> dict[int, str]:
    """Line -> reason of each ``# lint: sync(reason)`` comment."""
    out = {}
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type == tokenize.COMMENT:
            m = _PRAGMA.search(tok.string)
            if m:
                out[tok.start[0]] = m.group("reason").strip()
    return out


def _torch_call(node, names=HOST_BUILDERS) -> bool:
    """``node`` is a call ``torch.<one of names>(...)``."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in names
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "torch")


def _device_kw(call: ast.Call) -> bool:
    return any(k.arg == "device" for k in call.keywords)


def _host_built(node, names: set[str]) -> bool:
    """``node`` is a tensor in host memory: made by a host builder with no
    ``device=``, or a name the scope assigned one to."""
    if isinstance(node, ast.Name):
        return node.id in names
    return _torch_call(node) and not _device_kw(node)


def _to_device(call: ast.Call) -> bool:
    """``call`` (a ``.to``) names a device, not only a dtype."""
    if len(call.args) > 1 or _device_kw(call):
        return True
    if not call.args:
        return False
    a = call.args[0]
    return not (isinstance(a, ast.Attribute) and a.attr in _DTYPES)


def _host_names(body) -> set[str]:
    return {t.id for stmt in body for n in ast.walk(stmt)
            if isinstance(n, ast.Assign) and _host_built(n.value, set())
            for t in n.targets if isinstance(t, ast.Name)}


class _Syncs(ast.NodeVisitor):
    """(line, what) of each sync call, host tensors tracked per
    function."""

    def __init__(self, tree: ast.Module):
        self.names = [_host_names(tree.body)]
        self.found: list[tuple[int, str]] = []

    def visit_FunctionDef(self, node):
        self.names.append(_host_names(node.body))
        self.generic_visit(node)
        self.names.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in SYNC_CALLS:
            self.found.append((f.end_lineno, f".{f.attr}()"))
        elif (isinstance(f, ast.Attribute) and f.attr in ("to", "cuda")
              and _host_built(f.value, self.names[-1])
              and (f.attr == "cuda" or _to_device(node))):
            self.found.append((f.end_lineno, f".{f.attr}() host-to-device"))
        elif _torch_call(node, ("tensor", "as_tensor")) and _device_kw(node):
            self.found.append((node.lineno,
                               f"torch.{f.attr}(device=) host-to-device"))
        self.generic_visit(node)


def scan_source(source: str, path: str = "<source>") -> list[Finding]:
    """Every sync call in ``source`` (with the reason of the pragma that
    covers it, if any), then every stale pragma."""
    pragmas = _pragmas(source)
    used = set()
    found = []
    visitor = _Syncs(tree := ast.parse(source))
    visitor.visit(tree)
    for line, what in visitor.found:
        at = next((ln for ln in (line, line - 1) if ln in pragmas), None)
        if at is not None:
            used.add(at)
        found.append(Finding(path, line, what, pragmas.get(at)))
    found += [Finding(path, ln, "stale pragma", r)
              for ln, r in pragmas.items() if ln not in used]
    return sorted(found, key=lambda f: (f.line, f.what))


def scan(package: Path = PACKAGE) -> list[Finding]:
    """Findings in the hot modules of the package at ``package``."""
    out = []
    for rel in HOT_MODULES:
        out += scan_source((package / rel).read_text(), rel)
    return out


def violations(findings) -> list[Finding]:
    """The findings that fail the check: syncs with no pragma, stale
    pragmas."""
    return [f for f in findings
            if f.reason is None or f.what == "stale pragma"]


def main() -> int:
    bad = violations(scan())
    for f in bad:
        print(f.render())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
