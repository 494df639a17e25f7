"""The port's stall watchdog (symmetry_ode_discovery_tpu_torch/utils/watchdog.py):
the cases of tests/test_watchdog.py against the port's module (timing,
the CPU no-op probe, the real relaunch-once and exit-42 process behaviour,
the heartbeat), plus SODT_NO_WATCHDOG, the fire's cleanup callbacks, and
the CLIs' main on the CPU arming no thread. Every subprocess has a 30 s
timeout; no test sleeps for more than a second."""

import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from symmetry_ode_discovery_tpu_torch.utils import watchdog as wd
from symmetry_ode_discovery_tpu_torch.utils.watchdog import (
    STALL_EXIT_CODE, probe_first_dispatch, run_with_watchdog)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SODT_WATCHDOG_RETRIED", "SODT_NO_WATCHDOG", "SODT_WATCHDOG_TIMEOUT")}
    env.update(extra)
    return env


def test_fast_fn_does_not_fire():
    fired = []
    assert run_with_watchdog(lambda: 7, timeout_s=5.0, fire=fired.append) == 7
    time.sleep(0.05)
    assert not fired


def test_slow_fn_fires():
    fired = []
    out = run_with_watchdog(lambda: time.sleep(0.5) or "done", timeout_s=0.1,
                            fire=lambda: fired.append(1))
    assert out == "done"  # an injected fire does not end the process
    assert fired == [1]


def test_probe_is_noop_on_cpu():
    t0 = time.time()
    assert probe_first_dispatch(device="cpu", timeout_s=5.0) == 0.0
    assert time.time() - t0 < 2.0


def test_probe_without_cuda_is_noop(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_first_dispatch(timeout_s=5.0) == 0.0


def test_no_watchdog_variable_disables_probe_and_heartbeat(monkeypatch):
    monkeypatch.setenv("SODT_NO_WATCHDOG", "1")
    fired = []
    assert probe_first_dispatch(device="cuda", timeout_s=0.01, fire=lambda: fired.append(1)) == 0.0
    wd.stop_heartbeat()
    wd.start_heartbeat(timeout_s=0.05, fire=lambda: fired.append(1), poll_s=0.02)
    assert not wd.armed()
    time.sleep(0.2)
    assert not fired


def test_timeout_variable_overrides(monkeypatch):
    monkeypatch.setenv("SODT_WATCHDOG_TIMEOUT", "0.1")
    fired = []
    wd.stop_heartbeat()
    wd.start_heartbeat(timeout_s=3600.0, fire=lambda: fired.append(1), poll_s=0.02)
    time.sleep(0.4)
    wd.stop_heartbeat()
    assert fired == [1]


def test_relaunch_once_then_succeed(tmp_path):
    """A process that stalls on its first launch is re-executed and
    completes on the relaunch. A script file: os.execv re-runs sys.argv,
    which a -c invocation cannot carry."""
    script = tmp_path / "stall_once.py"
    script.write_text(textwrap.dedent("""\
        import os, sys, time
        sys.path.insert(0, %r)
        from symmetry_ode_discovery_tpu_torch.utils.watchdog import run_with_watchdog

        def work():
            if not os.environ.get("SODT_WATCHDOG_RETRIED"):
                time.sleep(60)  # a stalled first dispatch
            return "RECOVERED"

        print(run_with_watchdog(work, timeout_s=0.5))
    """ % REPO))
    r = subprocess.run([sys.executable, str(script)], env=_env(), capture_output=True,
                       text=True, timeout=30)
    assert r.returncode == 0, r.stderr
    assert "RECOVERED" in r.stdout
    assert "relaunching self once" in r.stderr
    assert "stalled CUDA dispatch" in r.stderr


def test_second_stall_exits_42():
    script = textwrap.dedent("""\
        import sys, time
        sys.path.insert(0, %r)
        from symmetry_ode_discovery_tpu_torch.utils.watchdog import run_with_watchdog
        run_with_watchdog(lambda: time.sleep(60), timeout_s=0.3)
    """ % REPO)
    r = subprocess.run([sys.executable, "-c", script], env=_env(SODT_WATCHDOG_RETRIED="1"),
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == STALL_EXIT_CODE
    assert "device wedged" in r.stderr


def test_heartbeat_fires_without_beats():
    fired = []
    wd.stop_heartbeat()
    wd.start_heartbeat(timeout_s=0.2, fire=lambda: fired.append(1), poll_s=0.05)
    assert wd.armed()
    time.sleep(0.6)
    wd.stop_heartbeat()
    assert fired == [1]


def test_heartbeat_beats_keep_it_alive():
    fired = []
    wd.stop_heartbeat()
    wd.start_heartbeat(timeout_s=0.3, fire=lambda: fired.append(1), poll_s=0.05)
    for _ in range(10):
        time.sleep(0.1)
        wd.beat()
    assert not fired
    wd.stop_heartbeat()
    time.sleep(0.2)
    assert not fired  # a disarmed thread must not fire


def test_heartbeat_beat_is_noop_when_unarmed():
    wd.stop_heartbeat()
    wd.beat()
    assert not wd.armed()


def test_heartbeat_relaunch_appends_resume(tmp_path):
    """A stalled run (no beats) is re-executed with --resume appended; the
    relaunch sees the flag and exits cleanly. The callbacks registered with
    at_fire run first."""
    script = tmp_path / "hb_stall.py"
    script.write_text(textwrap.dedent("""\
        import os, sys, time
        sys.path.insert(0, %r)
        from symmetry_ode_discovery_tpu_torch.utils import watchdog as wd

        if "--resume" in sys.argv:
            print("RESUMED-OK", os.environ.get("CLEANED"))
            sys.exit(0)
        wd.at_fire(lambda: os.environ.__setitem__("CLEANED", "yes"))
        wd.start_heartbeat(timeout_s=0.3, extra_argv=["--resume"], poll_s=0.05)
        time.sleep(60)   # a stalled run, no beats
    """ % REPO))
    r = subprocess.run([sys.executable, str(script)], env=_env(), capture_output=True,
                       text=True, timeout=30)
    assert r.returncode == 0, r.stderr
    assert "RESUMED-OK yes" in r.stdout
    assert "relaunching self once" in r.stderr


def test_relaunch_preserves_module_invocation(tmp_path):
    """`python -m pkg.mod` is re-executed as -m (argv[0] is the module's
    file then; run as a script it breaks relative imports)."""
    pkg = tmp_path / "wdpkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "helper.py").write_text("VALUE = 'FROM-RELATIVE-IMPORT'\n")
    (pkg / "mod.py").write_text(textwrap.dedent("""\
        import os, sys, time
        sys.path.insert(0, %r)
        from .helper import VALUE
        from symmetry_ode_discovery_tpu_torch.utils import watchdog as wd

        if os.environ.get("SODT_WATCHDOG_RETRIED"):
            print("OK", VALUE)
            sys.exit(0)
        wd.start_heartbeat(timeout_s=0.3, poll_s=0.05)
        time.sleep(60)
    """ % REPO))
    env = _env(PYTHONPATH=str(tmp_path) + os.pathsep + REPO)
    r = subprocess.run([sys.executable, "-m", "wdpkg.mod"], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "OK FROM-RELATIVE-IMPORT" in r.stdout


def test_at_fire_unregisters():
    ran = []
    remove = wd.at_fire(lambda: ran.append(1))
    remove()
    wd._run_at_fire()
    assert not ran


@pytest.mark.parametrize("cli", ["main", "main_gp", "main_sindy", "main_wsindy"])
def test_cli_main_on_cpu_arms_no_thread(cli, monkeypatch):
    """Without a CUDA device a CLI's main probes nothing and arms no
    heartbeat; its run then refuses to leave the card unasked."""
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd.stop_heartbeat()
    mod = importlib.import_module(f"symmetry_ode_discovery_tpu_torch.cli.{cli}")
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--config", "lv/noise99_eq_sindy_2.cfg", "--n_seeds", "1"])
    assert not wd.armed()
    new = {t.name for t in threading.enumerate()} - before
    assert "heartbeat-watchdog" not in new, new


def _report_rank(dp, device, n):
    for _ in range(n):
        dp.report_progress()
    dp.barrier()
    return dp.rank


def test_dp_ranks_feed_the_launchers_heartbeat():
    """parallel/dp.py::launch: rank 0's progress reports beat the launching
    process's heartbeat; the launch's fire cleanup is unregistered after."""
    from symmetry_ode_discovery_tpu_torch.parallel.dp import launch

    fired = []
    wd.stop_heartbeat()
    wd.start_heartbeat(timeout_s=3600.0, fire=lambda: fired.append(1), poll_s=0.5)
    beats = []
    orig = wd.beat
    wd.beat = lambda: beats.append(1) or orig()
    try:
        assert launch(_report_rank, ["cpu", "cpu"], args=(3,)) == 0
    finally:
        wd.beat = orig
        wd.stop_heartbeat()
    assert len(beats) == 3
    assert not wd._at_fire and not fired
