"""Child processes that end with the process that started them.

A harness (``scripts/torch_chaos_fleet.py``, ``torch_chaos_pod.py``,
``torch_fleet_bench.py``, ``torch_traffic_replay.py``) starts replicas or
ranks. When it exits, returns, raises or is sent SIGTERM (a caller's time
limit), every process it started is terminated, killed after a grace
and waited on: nothing it started outlives it.

    from howtotrainyourmamlpytorch_tpu_torch.utils import reaper
    reaper.install()                 # in main(): atexit + SIGTERM
    proc = reaper.spawn([...], stdout=..., ...)   # subprocess.Popen's args

A child started in a session of its own (``start_new_session=True``)
is tracked as its whole process group: ``spawn`` then returns the
:class:`Group`, whose :meth:`Group.end` ends the group at once (a
time-out). ``track`` tracks a process started some other way.

``install`` turns SIGTERM into ``SystemExit(143)`` on the main thread,
so ``finally`` blocks and the exit hook run; a handler someone else
installed is left alone. A SIGTERM that arrives while ``spawn`` runs
on the main thread is held until the new process is tracked: raised
between the fork and the tracking, it would leave that process
running untracked after the exit. Stdlib only.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import signal
import subprocess
import threading
import time
from typing import Any, List

# Processes tracked in this process (a harness's, by contract).
_procs: List[Any] = []
_lock = threading.Lock()
_installed = False
# Main-thread depth inside spawn(), and a SIGTERM held there.
_spawning = 0
_held = False


class Group:
    """The process group of a ``Popen`` started with
    ``start_new_session=True``: ``terminate`` and ``kill`` signal every
    process of the group (grandchildren included), ``poll`` and ``wait``
    are the leader's."""

    def __init__(self, proc: Any):
        self.proc = proc

    def poll(self):
        return self.proc.poll()

    def wait(self, timeout=None):
        return self.proc.wait(timeout=timeout)

    def _signal(self, sig) -> None:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(self.proc.pid, sig)

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def end(self, grace_s: float = 5.0) -> None:
        """SIGTERM the group while its leader runs, SIGKILL what is left
        after ``grace_s`` (a member that outlived its leader too), then
        wait on the leader."""
        if self.proc.poll() is None:
            self.terminate()
            with contextlib.suppress(subprocess.TimeoutExpired):
                self.proc.wait(timeout=grace_s)
        self.kill()
        self.proc.wait()


def track(proc: Any) -> Any:
    """Reap ``proc`` (anything with ``poll``, ``terminate``, ``kill`` and
    ``wait``) when this process exits; returns it."""
    with _lock:
        _procs[:] = [p for p in _procs if p.poll() is None]
        _procs.append(proc)
    return proc


def spawn(*args: Any, **kwargs: Any) -> Any:
    """``subprocess.Popen(*args, **kwargs)``, tracked before a SIGTERM
    on the main thread can end this process: returns the process, or its
    :class:`Group` when it starts a session of its own."""
    global _spawning, _held
    main = threading.current_thread() is threading.main_thread()
    _spawning += main
    try:
        proc = subprocess.Popen(*args, **kwargs)
        return track(Group(proc) if kwargs.get("start_new_session")
                     else proc)
    finally:
        _spawning -= main
        if main and not _spawning and _held:
            _held = False
            raise SystemExit(128 + signal.SIGTERM)


def reap(grace_s: float = 5.0) -> int:
    """Terminate every tracked process still running, kill what is left
    after ``grace_s`` and wait on each; returns how many were running."""
    with _lock:
        live = [p for p in _procs if p.poll() is None]
        _procs.clear()
    for p in live:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = time.monotonic() + grace_s
    for p in live:
        while p.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
        p.wait()
    return len(live)


def _on_sigterm(signum, frame) -> None:
    global _held
    if _spawning:
        _held = True
        return
    raise SystemExit(128 + signal.SIGTERM)


def install() -> None:
    """Reap at interpreter exit, and make SIGTERM an exit that does
    (main thread only; an existing non-default handler is kept)."""
    global _installed
    if _installed:
        return
    _installed = True
    atexit.register(reap)
    if threading.current_thread() is threading.main_thread():
        if signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, None):
            signal.signal(signal.SIGTERM, _on_sigterm)
