"""Stall watchdog: a watched first CUDA dispatch and a liveness heartbeat,
each relaunching the process once, then exiting with code 42.

The port's counterpart of symmetry_ode_discovery_tpu/utils/watchdog.py,
with the same names, constants, environment variables and exit code.

A process whose CUDA dispatch stalls sits in an uninterruptible driver
call, where no signal or exception reaches Python. A daemon thread watches
instead; when the watched work has not finished in time it either

  - re-executes the same command line once (``os.execv`` replaces the
    whole process image, stuck threads included), marked by
    SODT_WATCHDOG_RETRIED so that a second stall does not loop, or
  - exits with STALL_EXIT_CODE (42) when this already is the relaunch.

``probe_first_dispatch()`` watches CUDA initialisation and a 32 MB
host-to-device copy; ``start_heartbeat()`` arms the watchdog for the rest
of the run, fed by ``beat()`` at the training loops' progress points (a
LaLiGAN epoch, a sweep's host step, a GP chunk). The long-running CLIs
(cli/main.py, cli/main_gp.py) probe and arm the heartbeat when they run on
CUDA; cli/main.py appends --resume on the relaunch, so that an interrupted
LaLiGAN training continues from its snapshot, and the sweeps resume from
their per-seed files. cli/main_sindy.py and cli/main_wsindy.py probe only.

Environment: SODT_NO_WATCHDOG disables both; SODT_WATCHDOG_TIMEOUT
overrides both timeouts (seconds); SODT_WATCHDOG_RETRIED marks the
relaunch. Child processes that must not outlive a relaunch (the
data-parallel ranks) are registered with ``at_fire``.
"""

from __future__ import annotations

import os
import sys
import threading
import time

STALL_EXIT_CODE = 42
_RETRY_ENV = "SODT_WATCHDOG_RETRIED"

# callbacks run before a relaunch or exit (e.g. ending the data-parallel
# ranks, which would otherwise keep the card and the rendezvous file)
_at_fire = []


def at_fire(fn):
    """Run ``fn()`` before the watchdog relaunches or exits; returns a
    callable that unregisters it."""
    _at_fire.append(fn)

    def remove():
        if fn in _at_fire:
            _at_fire.remove(fn)

    return remove


def _run_at_fire():
    for fn in list(_at_fire):
        try:
            fn()
        except Exception as e:  # the relaunch must happen regardless
            sys.stderr.write(f"watchdog: cleanup before relaunch failed: {e!r}\n")


def _default_fire(extra_argv=()):
    """Relaunch this exact command line once; exit 42 on the second stall."""
    _run_at_fire()
    if os.environ.get(_RETRY_ENV):
        sys.stderr.write(
            "watchdog: CUDA dispatch stalled again after relaunch; "
            f"exiting {STALL_EXIT_CODE} (device wedged)\n")
        sys.stderr.flush()
        os._exit(STALL_EXIT_CODE)
    sys.stderr.write(
        "watchdog: no dispatch progress in time (stalled CUDA dispatch); "
        "relaunching self once\n")
    sys.stderr.flush()
    os.environ[_RETRY_ENV] = "1"
    argv = [sys.executable] + _self_argv()
    for a in extra_argv:
        if a not in argv:
            argv.append(a)
    try:
        os.execv(sys.executable, argv)
    except OSError:  # not re-executable: fall back to the exit code
        os._exit(STALL_EXIT_CODE)


def _self_argv():
    """argv (without the interpreter) that re-runs this process. Under
    ``python -m pkg.mod`` sys.argv[0] is the module's file, which run as a
    script breaks relative imports, so the -m form is rebuilt from
    __main__.__spec__."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    if spec is not None and spec.name:
        name = spec.name
        if name.endswith(".__main__"):
            name = name[: -len(".__main__")]
        return ["-m", name] + sys.argv[1:]
    return list(sys.argv)


def run_with_watchdog(fn, timeout_s: float, fire=None):
    """Run ``fn()`` in the calling thread; if it has not returned after
    timeout_s, call ``fire`` (default: relaunch once, then exit 42) from a
    daemon thread. Returns fn()'s result when it completes. ``fire`` is
    injectable for tests."""
    fire = _default_fire if fire is None else fire
    done = threading.Event()

    def _watch():
        if not done.wait(timeout_s):
            fire()

    t = threading.Thread(target=_watch, daemon=True, name="dispatch-watchdog")
    t.start()
    try:
        return fn()
    finally:
        done.set()


def probe_first_dispatch(device=None, timeout_s: float = 600.0, nbytes: int = 32 << 20,
                         fire=None) -> float:
    """This process's first CUDA dispatch under a watchdog: CUDA
    initialisation, then an ``nbytes`` host-to-device copy and a
    synchronize. Returns the copy's wall clock in seconds; 0.0 on the CPU
    (``device`` "cpu", or None without a CUDA device) and with
    SODT_NO_WATCHDOG set."""
    if os.environ.get("SODT_NO_WATCHDOG"):
        return 0.0
    env_t = os.environ.get("SODT_WATCHDOG_TIMEOUT")
    if env_t:
        timeout_s = float(env_t)

    def _probe():
        # torch's CUDA initialisation runs inside the watchdog on purpose:
        # a wedged driver blocks it too
        import torch

        dev = torch.device(device) if device is not None else (
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))
        if dev.type != "cuda":
            return 0.0
        host = torch.zeros(nbytes // 4, dtype=torch.float32)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        a = host.to(dev)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        del a
        return dt

    dt = run_with_watchdog(_probe, timeout_s, fire=fire)
    if dt > 30.0:
        print(f"watchdog: first dispatch took {dt:.1f} s", file=sys.stderr)
    return dt


# ---------------------------------------------------------------------------
# Heartbeat. A stall can hit any dispatch, not only the first, so the
# training loops feed beat() at their progress points; when no beat lands
# within the window, the same relaunch-once-then-exit-42 action fires.
# ---------------------------------------------------------------------------

_hb = {"last": None, "thread": None, "timeout": 0.0, "fire": None, "stop": None}


def beat() -> None:
    """Record progress. A no-op unless start_heartbeat() armed the watchdog."""
    if _hb["last"] is not None:
        _hb["last"] = time.time()


def armed() -> bool:
    """Whether the heartbeat watchdog is armed in this process."""
    return _hb["thread"] is not None


def start_heartbeat(timeout_s: float = 900.0, extra_argv=(), fire=None,
                    poll_s: float = 15.0) -> None:
    """Arm the liveness watchdog until stop_heartbeat().

    extra_argv: flags appended on the relaunch when absent (e.g.
    ["--resume"], so that an interrupted LaLiGAN training continues from
    its snapshot; the sweeps resume from their per-seed files without
    flags)."""
    if os.environ.get("SODT_NO_WATCHDOG") or _hb["thread"] is not None:
        return
    env_t = os.environ.get("SODT_WATCHDOG_TIMEOUT")
    if env_t:
        timeout_s = float(env_t)
    _hb["last"] = time.time()
    _hb["timeout"] = timeout_s
    _hb["fire"] = fire if fire is not None else (lambda: _default_fire(extra_argv))
    stop = _hb["stop"] = threading.Event()

    def _watch():
        while not stop.wait(poll_s):
            last = _hb["last"]
            if last is None:
                return  # disarmed
            if time.time() - last > _hb["timeout"]:
                _hb["fire"]()
                return  # an injected fire does not exit: do not spin

    t = threading.Thread(target=_watch, daemon=True, name="heartbeat-watchdog")
    t.start()
    _hb["thread"] = t


def stop_heartbeat() -> None:
    """Disarm the heartbeat; its thread ends at once."""
    thread, stop = _hb["thread"], _hb["stop"]
    _hb.update(last=None, thread=None, stop=None)
    if stop is not None:
        stop.set()
    if thread is not None and thread is not threading.current_thread():
        thread.join(timeout=1.0)
