"""The port's lint suite (``repro_torch.analysis``: the framework ``lint``,
the passes ``sync``, ``span`` and ``counter``, the command line), held to
the reference's ``repro.analysis`` on shared fixture sources. Mirrors the
span, counter, pragma, baseline and command-line tests of
``tests/test_analysis_lint.py``.

Both packages' ``span`` and ``counter`` passes give the same (code, line)
findings on the same fixture; the pragma and baseline machinery answers as
the reference's. The ``sync`` pass is the port's own host-sync check
(torch spellings), so its fixtures are torch code. The self-check: the
suite over ``src/repro_torch`` reports nothing, with an empty baseline
for ``serving/`` and ``kernels/``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as jax_lint
from repro.analysis.counters import CounterNamePass as JaxCounterNamePass
from repro.analysis.spans import SpanLifecyclePass as JaxSpanLifecyclePass
from repro_torch.analysis import hostsync, lint
from repro_torch.analysis.__main__ import BASELINE
from repro_torch.analysis.counters import CounterNamePass
from repro_torch.analysis.hostsync import HostSyncPass
from repro_torch.analysis.spans import MACHINES, SpanLifecyclePass

REPO_ROOT = Path(__file__).resolve().parents[1]

HOT_PATH = "fx/serving/workers.py"       # a hot module of the sync pass
AUDITED_PATH = "fx/serving/metrics.py"   # audited by the counter pass
COLD_PATH = "fx/launch/tool.py"


def run_src(src, relpath=HOT_PATH, passes=None, lint_mod=lint):
    src = textwrap.dedent(src).lstrip("\n")
    mod = lint_mod.Module(Path(relpath), relpath, src)
    return lint_mod.run_passes([mod], passes)


def line_of(src, needle):
    """1-based line of the first source line containing ``needle``."""
    src = textwrap.dedent(src).lstrip("\n")
    for i, ln in enumerate(src.splitlines(), start=1):
        if needle in ln:
            return i
    raise AssertionError(f"needle {needle!r} not in fixture")


def codes(findings):
    return sorted((f.code, f.line) for f in findings)


def both(src, relpath, port_pass, ref_pass):
    """(code, line) of the port's pass and of the reference's."""
    return (codes(run_src(src, relpath, [port_pass])),
            codes(run_src(src, relpath, [ref_pass], jax_lint)))


# ------------------------------------------------------------------ sync

SYNC_BAD = """
import torch


class W:
    def step(self, logits, ids, dev):
        nxt = logits.argmax(-1).cpu()
        torch.cuda.synchronize()
        v = logits.max().item()
        toks = torch.as_tensor(ids).to(dev)
        return nxt, v, toks
"""


def test_sync_codes_and_lines():
    findings = run_src(SYNC_BAD, passes=[HostSyncPass])
    assert codes(findings) == [
        ("SYNC001", line_of(SYNC_BAD, "synchronize")),
        ("SYNC002", line_of(SYNC_BAD, ".cpu()")),
        ("SYNC003", line_of(SYNC_BAD, ".item()")),
        ("SYNC006", line_of(SYNC_BAD, ".to(dev)")),
    ]
    assert all("W.step" in f.message for f in findings)


def test_sync_pass_reads_the_hot_modules_only():
    assert run_src(SYNC_BAD, relpath=COLD_PATH, passes=[HostSyncPass]) == []
    for rel in hostsync.HOT_MODULES:
        assert hostsync.is_hot_module(f"src/repro_torch/{rel}")


def test_sync_pass_finds_what_the_host_sync_check_finds():
    """The framework's ``sync`` pass and ``python -m
    repro_torch.analysis.hostsync`` read the same sites of the package."""
    paths = [str(hostsync.PACKAGE / rel) for rel in hostsync.HOT_MODULES]
    mods = [lint.Module(Path(p), p, Path(p).read_text()) for p in paths]
    raw = []
    inst = HostSyncPass()
    for m in mods:
        raw += [(Path(f.path).name, f.line) for f in inst.check_module(m)]
    check = [(Path(f.path).name, f.line) for f in hostsync.scan()
             if f.what != "stale pragma"]
    assert sorted(raw) == sorted(check)


def test_a_stale_sync_pragma_is_reported_once():
    src = """
    def step(x):
        # lint: sync(covers nothing)
        return x
    """
    (f,) = run_src(src, passes=[HostSyncPass])
    assert f.code == "LINT003"


# ------------------------------------------------------------------ span

SPAN_BAD = """
def freeze(tr, sid):
    tr.async_begin("w0", "page_freeze", sid)
    tr.async_end("w0", "page_freeze", sid, state="installed")
    tr.async_end("w0", "page_freeze", sid, state="dropped")
    tr.async_end("w0", "page_freeze", sid, state="rolled_back")
    tr.async_end("w0", "page_freeze", sid, state="zombie")
    tr.async_end("w0", "page_freeze", sid, state=mode)
    tr.async_begin("w0", "orphan", sid)
    tr.async_end("w0", "ghost", sid)
"""

SPAN_GOOD = """
def freeze(tr, sid):
    tr.async_begin("w0", "page_freeze", sid)
    tr.async_end("w0", "page_freeze", sid, state="installed")
    tr.async_end("w0", "page_freeze", sid, state="dropped")
    tr.async_end("w0", "page_freeze", sid, state="rolled_back")
    tr.async_end("w0", "page_freeze", sid, state="offloaded")
    tr.async_begin("w0", "page_offload", sid)
    tr.async_end("w0", "page_offload", sid, state="restored")
    tr.async_begin("w0", "plain_span", sid)
    tr.async_end("w0", "plain_span", sid)
"""

SPAN_OFFLOAD = """
def offload(tr, sid, ok):
    tr.async_begin("w0", "page_offload", sid)
    if ok:
        tr.async_end("w0", "page_offload", sid)
    tr.async_end("w0", "page_offload", sid, state="lost")
"""


def test_span_codes_and_lines():
    findings = run_src(SPAN_BAD, relpath=COLD_PATH,
                       passes=[SpanLifecyclePass])
    begin_line = line_of(SPAN_BAD, 'async_begin("w0", "page_freeze"')
    assert codes(findings) == [
        ("SPAN001", begin_line),                        # no "offloaded"
        ("SPAN001", line_of(SPAN_BAD, '"zombie"')),     # undeclared state
        ("SPAN002", line_of(SPAN_BAD, "state=mode")),   # non-literal state
        ("SPAN003", line_of(SPAN_BAD, '"orphan"')),
        ("SPAN004", line_of(SPAN_BAD, '"ghost"')),
    ]
    missing = [f for f in findings if f.line == begin_line]
    assert "offloaded" in missing[0].message


def test_span_complete_machine_is_clean():
    assert run_src(SPAN_GOOD, relpath=COLD_PATH,
                   passes=[SpanLifecyclePass]) == []


@pytest.mark.parametrize("src", [SPAN_BAD, SPAN_GOOD, SPAN_OFFLOAD])
def test_span_findings_equal_the_reference(src):
    port, ref = both(src, COLD_PATH, SpanLifecyclePass, JaxSpanLifecyclePass)
    assert port == ref


def test_span_machines_are_the_references():
    from repro.analysis.spans import MACHINES as JAX_MACHINES

    assert MACHINES == JAX_MACHINES
    assert MACHINES["page_freeze"] == {"installed", "dropped", "rolled_back",
                                       "offloaded"}
    assert MACHINES["page_offload"] == {"restored"}


# --------------------------------------------------------------- counter

COUNTER_BAD = """
class Worker:
    def __init__(self):
        self.counters = {"tokens": 0}

    def summary(self):
        out = {"spec_steps": 1}
        out["extra"] = 2
        return out


def ingest(stats, sched):
    stats.gauge("hbm_bytes_per_token").set(1.0)
    sched.admission("backpressure")


def report(s, stats):
    ok = (s.get("tokens", 0), s.get("spec_steps", 0), s.get("extra", 0),
          s.get("backpressure", 0))
    h = stats.histogram("hbm_bytes_per_token")
    bad = s.get("typo_key", 0)
    worse = stats.gauge("hbm_bytez")
    return ok, h, bad, worse
"""

COUNTER_HELPERS = """
def _finish(out):
    out["tokens_per_step"] = 1.0


def _finish_named(summary):
    summary["offload_compression"] = 2.0


def run(eng):
    s = eng.run()
    return (s["tokens_per_step"], s.get("offload_compression"),
            s["quant_matmul_launches"])
"""


def test_counter_codes_and_lines():
    findings = run_src(COUNTER_BAD, relpath=AUDITED_PATH,
                       passes=[CounterNamePass])
    assert codes(findings) == [
        ("CTR001", line_of(COUNTER_BAD, '"typo_key"')),
        ("CTR001", line_of(COUNTER_BAD, '"hbm_bytez"')),
    ]


def test_counter_skips_unaudited_modules():
    assert run_src(COUNTER_BAD, relpath="fx/core/solver.py",
                   passes=[CounterNamePass]) == []


@pytest.mark.parametrize("src", [COUNTER_BAD, COUNTER_HELPERS])
@pytest.mark.parametrize("relpath", [AUDITED_PATH, "fx/obs/export.py",
                                     "fx/launch/serve.py", COLD_PATH])
def test_counter_findings_equal_the_reference(src, relpath):
    port, ref = both(src, relpath, CounterNamePass, JaxCounterNamePass)
    assert port == ref


def test_counter_sees_a_helper_store_only_into_a_summary_name():
    """A key stored by a helper whose parameter is named ``out`` has no
    registration the pass can see; named ``summary`` it has."""
    found = run_src(COUNTER_HELPERS, relpath=AUDITED_PATH,
                    passes=[CounterNamePass])
    assert sorted(f.message.split("'")[1] for f in found) == [
        "quant_matmul_launches", "tokens_per_step"]


# --------------------------------------------------------------- pragmas


def test_pragma_suppresses_on_same_line():
    src = """
    class W:
        def step(self, x):
            return x.cpu()  # lint: sync(step-end sync)
    """
    assert run_src(src, passes=[HostSyncPass]) == []


def test_pragma_suppresses_from_line_above():
    src = """
    class W:
        def step(self, x):
            # lint: sync(step-end sync on purpose)
            return x.cpu()
    """
    assert run_src(src, passes=[HostSyncPass]) == []


def test_pragma_is_per_pass():
    src = """
    class W:
        def step(self, x):
            # lint: span(wrong pass name for this site)
            return x.cpu()
    """
    findings = run_src(src, passes=[HostSyncPass, SpanLifecyclePass])
    assert [f.code for f in findings] == ["LINT003", "SYNC002"]


def test_pragma_empty_reason_is_lint001():
    src = """
    class W:
        def step(self, x):
            return x.cpu()  # lint: sync()
    """
    (f,) = run_src(src, passes=[HostSyncPass])
    assert f.code == "LINT001"


def test_pragma_unknown_pass_is_lint002():
    (f,) = run_src("x = 1  # lint: hotloop(no such pass)\n",
                   relpath=COLD_PATH, passes=[HostSyncPass])
    assert f.code == "LINT002"
    assert "hotloop" in f.message


def test_pragma_unused_is_lint003():
    (f,) = run_src("x = 1  # lint: sync(nothing here needed it)\n",
                   relpath=COLD_PATH, passes=[HostSyncPass])
    assert f.code == "LINT003"


def test_docstring_pragma_examples_do_not_count():
    src = '''
    def helper():
        """Example:  # lint: sync(docstring, not a comment)"""
        return 1
    '''
    assert run_src(src, relpath=COLD_PATH, passes=[HostSyncPass]) == []


@pytest.mark.parametrize("line", [
    "x = 1  # lint: span(a reason), counter(another)",
    "x = 1  # lint: sync()", "x = 1  # lint: nosuch(r)",
    "x = 1  # lint: span(r)"])
def test_pragma_findings_equal_the_reference(line):
    port = codes(run_src(line + "\n", relpath=COLD_PATH,
                         passes=[SpanLifecyclePass, CounterNamePass]))
    ref = codes(run_src(line + "\n", relpath=COLD_PATH,
                        passes=[JaxSpanLifecyclePass, JaxCounterNamePass],
                        lint_mod=jax_lint))
    assert port == ref


# -------------------------------------------------------------- baseline


def test_baseline_round_trip(tmp_path):
    findings = run_src(SYNC_BAD, passes=[HostSyncPass])
    assert findings
    bpath = tmp_path / "baseline.json"
    lint.save_baseline(bpath, findings)
    baseline = lint.load_baseline(bpath)
    new, old = lint.partition_baseline(findings, baseline)
    assert new == [] and len(old) == len(findings)
    extra = lint.Finding("fx/serving/workers.py", 99, "SYNC002", "sync",
                         "a finding the baseline has never seen")
    new, old = lint.partition_baseline(findings + [extra], baseline)
    assert new == [extra]


def test_baseline_fingerprint_is_line_independent():
    f1 = lint.Finding("a.py", 10, "SYNC001", "sync", "msg")
    f2 = lint.Finding("a.py", 99, "SYNC001", "sync", "msg")
    assert f1.fingerprint == f2.fingerprint
    assert f1.fingerprint == jax_lint.Finding(
        "a.py", 10, "SYNC001", "sync", "msg").fingerprint
    assert lint.load_baseline(None) == set()


def test_missing_baseline_is_empty(tmp_path):
    assert lint.load_baseline(tmp_path / "nope.json") == set()


# ------------------------------------------------------------ self-check


def test_repo_scans_clean():
    """No unbaselined finding over src/repro_torch, and none at all under
    serving/ and kernels/; the port's baseline holds nothing there."""
    findings = lint.run_paths([str(REPO_ROOT / "src" / "repro_torch")])
    baseline = lint.load_baseline(BASELINE)
    new, _ = lint.partition_baseline(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)
    hot = [f for f in findings
           if "/serving/" in f.path or "/kernels/" in f.path]
    assert hot == [], "\n".join(f.render() for f in hot)
    assert not [fp for fp in baseline
                if "/serving/" in fp or "/kernels/" in fp]
    assert BASELINE.parent == REPO_ROOT / "src" / "repro_torch" / "analysis"


def test_all_passes_registered():
    assert set(lint.all_passes()) == {"sync", "span", "counter"}


# ------------------------------------------------------------------- CLI


def _run_cli(*argv, cwd=REPO_ROOT):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_cli_repo_gate_passes():
    r = _run_cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new finding(s)" in r.stdout


def test_cli_fails_on_injected_violation(tmp_path):
    bad = tmp_path / "serving" / "workers.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(textwrap.dedent("""
        class W:
            def step(self, logits):
                tr.async_end("w0", "page_freeze", 1, state="lost")
                return logits.max().item()
    """).lstrip("\n"))
    r = _run_cli(str(bad), "--baseline", str(tmp_path / "none.json"))
    assert r.returncode == 1
    assert "SYNC003" in r.stdout and "SPAN004" in r.stdout


def test_cli_json_format(tmp_path):
    bad = tmp_path / "serving" / "workers.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\n\n\ndef step(x):\n"
                   "    torch.cuda.synchronize()\n")
    r = _run_cli(str(bad), "--format", "json",
                 "--baseline", str(tmp_path / "none.json"))
    assert r.returncode == 1
    payload = json.loads(r.stdout)
    assert payload["scanned_files"] == 1
    assert [f["code"] for f in payload["new"]] == ["SYNC001"]
    assert payload["baselined"] == []
    # accepted into a baseline, the same finding no longer fails
    base = tmp_path / "b.json"
    assert _run_cli(str(bad), "--baseline", str(base),
                    "--write-baseline").returncode == 0
    r = _run_cli(str(bad), "--baseline", str(base), "--passes", "sync")
    assert r.returncode == 0 and "1 baselined" in r.stdout


def test_cli_list_passes():
    r = _run_cli("--list-passes")
    assert r.returncode == 0
    for name in ("sync", "span", "counter"):
        assert name in r.stdout
    assert "retrace" not in r.stdout
