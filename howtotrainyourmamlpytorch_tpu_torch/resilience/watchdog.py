"""Watchdog: hang detection via progress beacons and per-phase deadlines
(the port's copy of the JAX package's ``resilience/watchdog.py``).

Every long-running layer stamps a named phase on a process-wide
:class:`ProgressBeacon` (``step``, ``feed``, ``compile``,
``serve_request``, ``ckpt`` — host-side Python only), and a daemon
:class:`Watchdog` thread checks the age of the *current* phase against
that phase's deadline from config (``watchdog_step_timeout_s`` & friends;
``0`` disables a phase; compile phases get a separate, much larger
budget so a first call's build does not trip the step deadline). On a
missed deadline the watchdog dumps all-thread stacks and the flight ring
into a crash bundle (:func:`~.flightrec.write_crash_bundle`), flushes the
telemetry registry, and exits ``resilience.EXIT_HUNG`` (74) so a
scheduler resubmits into the resume path. With the pod fault domain
(``cluster=``, ``resilience/cluster.py``) the poll loop also keeps this
rank's heartbeat lease fresh, and a ``collective`` trip past the cluster
budget goes to its attributed peer-lost exit (73) instead.

On the card the host runs ahead of the device, so a wedged kernel is
seen only where the host waits for it: the step's loss fetch every
``dispatch_sync_every`` steps, the epoch end, a checkpoint's encode. The
main thread then sits in a CUDA sync with the interpreter lock released,
and this thread trips. Nothing on the trip path calls into CUDA (no
synchronize, no ``.item()``/``.cpu()`` of a device tensor, no
``mem_get_info``, no profiler stop): any of them could block behind the
same kernel, and exit 74 would never happen.

Disabled (every ``watchdog_*_timeout_s`` = 0) the subsystem installs
nothing: every stamp site is one module-global ``None`` check.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from howtotrainyourmamlpytorch_tpu_torch.resilience import flightrec

# Phase name -> MAMLConfig timeout field. Phases not in this map (the
# "idle"/"init" bookkeeping phases) never trip: an idle serving engine
# must not be killed for making no progress it was never asked to make.
PHASE_TIMEOUT_FIELDS = {
    "step": "watchdog_step_timeout_s",
    "feed": "watchdog_feed_timeout_s",
    "collective": "watchdog_collective_timeout_s",
    "compile": "watchdog_compile_timeout_s",
    "serve_request": "watchdog_serve_timeout_s",
    # Checkpoint saves the train thread waits on (a sync save, a
    # 'block'-policy enqueue, the preempt/exit drain: ckpt/writer.py).
    # The async writer's thread never stamps the beacon.
    "ckpt": "watchdog_ckpt_timeout_s",
}

TRIPS_COUNTER = "watchdog/trips"
PROGRESS_AGE_GAUGE = "watchdog/progress_age_seconds"
TRIP_EVENT = "watchdog_trip"


def deadlines_from_config(cfg: Any) -> Dict[str, float]:
    """The per-phase deadline map the watchdog enforces."""
    return {phase: float(getattr(cfg, field))
            for phase, field in PHASE_TIMEOUT_FIELDS.items()}


def watchdog_enabled(cfg: Any) -> bool:
    return any(v > 0 for v in deadlines_from_config(cfg).values())


class ProgressBeacon:
    """Named-phase progress stamps with monotonic timestamps.

    One beacon per process (installed via :func:`install_beacon`); any
    thread may :meth:`stamp`. The watchdog reads only the current phase:
    a stamp is the claim "I am now doing <phase> and just made progress",
    so a phase whose stamp grows old without a new stamp is stuck in that
    phase. Every stamp also appends a ``phase`` event to the flight ring.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._phase = "init"
        self._detail: Any = None
        self._stamp = time.monotonic()

    def stamp(self, phase: str, detail: Any = None) -> None:
        with self._lock:
            self._phase = phase
            self._detail = detail
            self._stamp = time.monotonic()
        flightrec.record("phase", phase=phase, detail=detail)

    def current(self) -> Tuple[str, float, Any]:
        """(phase, monotonic stamp, detail) — one consistent read."""
        with self._lock:
            return self._phase, self._stamp, self._detail

    def age(self, now: Optional[float] = None) -> float:
        """Seconds since the last stamp (any phase): the liveness number
        the heartbeat exports."""
        _, stamp, _ = self.current()
        return (time.monotonic() if now is None else now) - stamp

    @contextlib.contextmanager
    def phase(self, name: str, detail: Any = None):
        """Scoped phase: stamp ``name`` now, re-stamp the previous phase
        (with a fresh timestamp: completing the scoped work is progress)
        on exit."""
        prev_phase, _, prev_detail = self.current()
        self.stamp(name, detail)
        try:
            yield
        finally:
            self.stamp(prev_phase, prev_detail)


_beacon: Optional[ProgressBeacon] = None


def install_beacon(beacon: Optional[ProgressBeacon]
                   ) -> Optional[ProgressBeacon]:
    """Install the process-wide beacon; returns the previous one."""
    global _beacon
    prev = _beacon
    _beacon = beacon
    return prev


def get_beacon() -> Optional[ProgressBeacon]:
    return _beacon


def stamp(phase: str, detail: Any = None) -> None:
    """Stamp the installed beacon; one ``None`` check when disabled."""
    b = _beacon
    if b is not None:
        b.stamp(phase, detail)


@contextlib.contextmanager
def phase(name: str, detail: Any = None):
    """Scoped phase against the installed beacon (a no-op scope when no
    beacon is installed)."""
    b = _beacon
    if b is None:
        yield
        return
    with b.phase(name, detail):
        yield


class Watchdog:
    """Daemon monitor thread enforcing per-phase progress deadlines.

    :meth:`check` is a pure function of the beacon's current (phase,
    stamp) and the deadline map; :meth:`trip` performs the forensic dump
    and exits the process with ``resilience.EXIT_HUNG`` via ``os._exit``
    (a hung run cannot be trusted to unwind). Tests inject ``on_trip`` to
    observe a trip without dying.
    """

    def __init__(self, beacon: ProgressBeacon,
                 deadlines: Dict[str, float], *,
                 bundle_dir: str,
                 registry: Optional[Any] = None,
                 jsonl: Optional[Any] = None,
                 prom_path: Optional[str] = None,
                 poll_interval_s: float = 0.0,
                 on_trip: Optional[Callable[[Dict[str, Any]], None]] = None,
                 process_index: int = 0,
                 cluster: Optional[Any] = None):
        self.beacon = beacon
        self.deadlines = {k: float(v) for k, v in deadlines.items()}
        self.bundle_dir = bundle_dir
        self.registry = registry
        self.jsonl = jsonl
        self.prom_path = prom_path
        self.on_trip = on_trip
        self.process_index = int(process_index)
        # Pod fault domain (resilience/cluster.py): the poll loop keeps
        # this rank's heartbeat lease fresh (the thread proves the
        # PROCESS is alive while the main thread is blocked inside a
        # collective), and a tripped collective deadline that overran
        # the CLUSTER budget goes to its attributed peer-lost path.
        self.cluster = cluster
        enabled = [v for v in self.deadlines.values() if v > 0]
        self.enabled = bool(enabled)
        # Auto poll: fast enough to detect the tightest deadline with
        # ~25% overshoot, clamped so a 2 s chaos deadline does not spin
        # the host and a 2 h compile budget still gets sub-5 s response
        # to the other phases' deadlines.
        if poll_interval_s > 0:
            self.poll_interval_s = float(poll_interval_s)
        else:
            self.poll_interval_s = (min(min(enabled) / 4.0, 5.0)
                                    if enabled else 5.0)
            self.poll_interval_s = max(self.poll_interval_s, 0.05)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tripped: Optional[Dict[str, Any]] = None

    # -- deadline math (pure) ---------------------------------------------
    def deadline_for(self, phase_name: str) -> float:
        """Seconds of allowed silence in ``phase_name``; 0 = no deadline
        (a disabled phase or a bookkeeping phase like 'idle')."""
        return self.deadlines.get(phase_name, 0.0)

    def check(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Trip info if the current phase overran its deadline, else
        None. ``now`` is a monotonic instant (tests pass synthetic
        ones)."""
        if not self.enabled:
            return None
        phase_name, stamp, detail = self.beacon.current()
        budget = self.deadline_for(phase_name)
        if budget <= 0:
            return None
        age = (time.monotonic() if now is None else now) - stamp
        if age <= budget:
            return None
        return {"phase": phase_name, "detail": detail,
                "age_seconds": age, "deadline_seconds": budget,
                "process_index": self.process_index}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Watchdog":
        if self.enabled and self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            if self.cluster is not None:
                # Liveness, not progress: the lease stays fresh while
                # this rank waits in a collective, so a dead peer's
                # aging lease stands out against the (equally blocked)
                # survivors'. Rate-limited by the lease; fail-soft.
                self.cluster.heartbeat()
            info = self.check()
            if info is not None:
                self.trip(info)
                return

    # -- trip path --------------------------------------------------------
    def trip(self, info: Dict[str, Any]) -> None:
        """Forensics, then die: count the trip, write the crash bundle,
        flush the registry so the final counters survive, exit
        ``EXIT_HUNG``. Every step is best-effort: a failure mid-dump must
        not prevent the exit that frees the card.

        Host values only. ``Gauge.set`` stores a Python float when the
        main thread sets it, so ``snapshot``, ``flush_jsonl`` and
        ``write_prometheus`` here format stored floats and call nothing.
        The port's gauges, each set from a host value: ``train/*``,
        ``val/*``, ``test/*`` (epoch stats already fetched),
        ``feed/stall_frac`` (host clocks), ``memory/*``
        (``telemetry/instruments.py § device_memory_stats``: the caching
        allocator's host-side counters, read at the epoch rollup),
        ``algo/*`` and ``progress/epoch`` (ints), ``health/*`` (fetched
        at a sync point before publishing), the ``perf/*`` fractions and
        MFU (the sampler's host summary), the alerts' firing count and
        this module's progress age. The bundle's stack dump, flight ring
        and trace are host memory and files."""
        from howtotrainyourmamlpytorch_tpu_torch import resilience
        self.tripped = info
        if self.cluster is not None and self.cluster.owns_trip(info):
            # A collective past the CLUSTER deadline: the pod fault
            # domain names the suspect hosts from the lease ages and
            # exits EXIT_PEER_LOST instead of EXIT_HUNG.
            self.cluster.trip_peer_lost(info)
            return
        flightrec.record(TRIP_EVENT, **info)
        if self.registry is not None:
            try:
                self.registry.counter(TRIPS_COUNTER).inc()
                self.registry.gauge(PROGRESS_AGE_GAUGE).set(
                    info["age_seconds"])
            except Exception:
                pass
        try:
            flightrec.write_crash_bundle(
                self.bundle_dir, reason=f"hung_{info['phase']}",
                info=info, registry=self.registry,
                process_index=self.process_index)
        except Exception:
            pass
        if self.jsonl is not None:
            try:
                self.jsonl.log(TRIP_EVENT, **info,
                               bundle_dir=self.bundle_dir)
                if self.registry is not None:
                    self.registry.flush_jsonl(self.jsonl, phase=TRIP_EVENT)
            except Exception:
                pass
        if self.prom_path and self.registry is not None:
            try:
                self.registry.write_prometheus(self.prom_path)
            except Exception:
                pass
        if self.on_trip is not None:
            self.on_trip(info)
            return
        os._exit(resilience.EXIT_HUNG)
