"""The port's host-sync check (``repro_torch.analysis.hostsync``): the hot
modules make no host sync but those with a pragma (nine read-backs and
waits, sixteen pageable host-to-device copies), and the check finds each
construct it names, honours a pragma on the call's line or the line
before, and reports stale pragmas."""
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import hostsync

REPO = Path(__file__).resolve().parents[1]


def test_hot_modules_sync_only_where_a_pragma_says_why():
    findings = hostsync.scan()
    assert hostsync.violations(findings) == []
    sites = sorted({(f.path, f.what) for f in findings})
    assert sites == [("serving/kv_cache.py", ".cpu()"),
                     ("serving/kv_cache.py", ".synchronize()"),
                     ("serving/kv_cache.py", ".to() host-to-device"),
                     ("serving/kv_cache.py",
                      "torch.as_tensor(device=) host-to-device"),
                     ("serving/speculative.py", ".cpu()"),
                     ("serving/speculative.py", ".numpy()"),
                     ("serving/speculative.py", ".to() host-to-device"),
                     ("serving/transfer.py", ".cpu()"),
                     ("serving/transfer.py",
                      "torch.as_tensor(device=) host-to-device"),
                     ("serving/workers.py", ".cpu()"),
                     ("serving/workers.py", ".numpy()"),
                     ("serving/workers.py", ".to() host-to-device")]
    lines = {(f.path, f.line) for f in findings}
    # the speculative path adds the verify read-backs (token ids, recorded
    # logits), the draft's per-step token read-back, and the pageable
    # copies of the window's and the draft prompt's token ids; the
    # per-page host freeze of the count methods without a device solver
    # adds its pages' read-back and the copies of their page ids, codes
    # and codebooks; page migration adds the payload's staging to the host
    # (gated on its events by the harvest; preempt's demotion blocks on
    # it), one copy of page ids (source or destination) and the copy of
    # the staged pages and codes; overload adds no site of its own
    assert len(lines) == 25
    assert len([f for f in findings if "host-to-device" in f.what]) == 16
    assert all(f.reason for f in findings)


def test_every_hot_module_is_read():
    for rel in hostsync.HOT_MODULES:
        assert (hostsync.PACKAGE / rel).is_file(), rel
    assert {"serving/workers.py", "serving/kv_cache.py",
            "serving/speculative.py", "serving/transfer.py",
            "serving/overload.py",
            "kernels/fista_quant.py"} <= set(hostsync.HOT_MODULES)


@pytest.mark.parametrize("call", [
    "x.item()", "x.cpu()", "x.tolist()", "x.numpy()",
    "torch.cuda.synchronize()", "ev.synchronize()",
    "torch.cuda.current_stream().synchronize()"])
def test_each_sync_construct_is_found(call):
    src = f"def step(x, ev):\n    y = {call}\n    return y\n"
    (f,) = hostsync.scan_source(src)
    assert f.line == 2 and f.reason is None
    assert hostsync.violations([f]) == [f]


@pytest.mark.parametrize("call", [
    "torch.as_tensor(ids).to(dev)", "torch.from_numpy(ids).to(dev)",
    "torch.tensor(ids).to(device=dev)", "torch.tensor(ids).cuda()",
    "torch.as_tensor(ids).to(dev, torch.int64)",
    "torch.tensor(1e30, device=dev)", "torch.as_tensor(ids, device=dev)"])
def test_each_host_to_device_copy_is_found(call):
    src = f"def step(ids, dev):\n    y = {call}\n    return y\n"
    (f,) = hostsync.scan_source(src)
    assert f.line == 2 and "host-to-device" in f.what
    assert hostsync.violations([f]) == [f]


def test_a_name_holding_a_host_tensor_is_tracked_in_its_function():
    src = ("def step(ids, dev, x):\n"
           "    h = torch.as_tensor(ids)\n"
           "    a = h.to(dev)\n"
           "    b = x.to(dev)\n"
           "    return a, b, h.to(torch.int32), h.to(x.dtype)\n"
           "def other(h, dev):\n"
           "    return h.to(dev)\n")
    assert [(f.line, f.what) for f in hostsync.scan_source(src)] == [
        (3, ".to() host-to-device")]


def test_device_side_waits_and_host_numpy_are_not_syncs():
    src = ("def step(ev, s, ids):\n"
           "    ev.wait(s)\n"
           "    s.wait_event(ev)\n"
           "    return np.asarray(sorted(ids))\n")
    assert hostsync.scan_source(src) == []


def test_pragma_on_the_line_or_the_line_before_and_stale_pragmas():
    src = ("def step(x):\n"
           "    a = x.item()  # lint: sync(needed here)\n"
           "    # lint: sync(and here)\n"
           "    b = x.cpu()\n"
           "    # lint: sync(covers nothing)\n"
           "    return a, b\n")
    found = hostsync.scan_source(src)
    assert [(f.line, f.what, f.reason) for f in found] == [
        (2, ".item()", "needed here"), (4, ".cpu()", "and here"),
        (5, "stale pragma", "covers nothing")]
    assert [f.line for f in hostsync.violations(found)] == [5]


def test_command_line_exits_0_on_the_repo():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.hostsync"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": ""},
        capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
