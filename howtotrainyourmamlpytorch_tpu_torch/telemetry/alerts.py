"""Declarative alert rules over the live metrics plane (the port's copy
of the JAX package's ``telemetry/alerts.py``: the same rules and
snapshots give the same transitions, rows and firing summaries).

A rule engine that evaluates a declarative JSON rules file
against a metrics snapshot (``MetricsRegistry.snapshot()`` or any
name→value dict) plus staleness/burn signals, and drives each matching
condition through a full ``pending → firing → resolved`` lifecycle.

Rule types (docs/OBSERVABILITY.md § Alerting):

* ``threshold`` — compare a gauge/counter VALUE against a bound
  (``metric``, ``op``, ``value``).
* ``rate`` — compare a counter's per-second RATE between consecutive
  evaluations, reset-aware the way report.py accumulates counters (a
  value below its predecessor is a process restart: the new value
  contributes whole over the interval, never a negative rate).
* ``absence`` — a named liveness signal (heartbeat, replica lease) has
  gone stale: fires when ``ages[signal] > max_age_s`` or the signal is
  missing entirely; ``signal_prefix`` matches a family (one alert
  instance per matching signal, labelled by its full name).
* ``burn_rate`` — the PR-14 SLO ledger's currency: fires when a
  tenant's ``bad_frac / (1 - target)`` exceeds ``max_burn`` (per-tenant
  instances from the ``burn_rates`` mapping, labelled by tenant).

Every rule carries ``for_s`` hysteresis (the condition must hold
continuously that long before firing — a single noisy sample never
pages), a ``severity`` from :data:`SEVERITIES`, and dedups by
``(rule, labels)``: an already-firing instance re-observed true is
silent. Transitions emit one :data:`ALERT_EVENT` row each into the
caller's ``events.jsonl``; the active set lands in an ``ALERTS.json``
snapshot (atomic tmp+replace, the checkpoint-manifest idiom) and the
:data:`FIRING_GAUGE` series in ``metrics.prom``.

Stdlib-only.
"""

from __future__ import annotations

import difflib
import json
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

ALERT_EVENT = "alert"
# Gauge name chosen so the Prometheus series is literally
# ``maml_alert_firing`` (registry._prom_name maps '/' to '_'; here the
# name is already its own prom spelling).
FIRING_GAUGE = "maml_alert_firing"
SNAPSHOT_BASENAME = "ALERTS.json"

# Ascending severity; max_severity comparisons index into this.
SEVERITIES = ("info", "warn", "critical")

RULE_TYPES = ("threshold", "rate", "absence", "burn_rate")

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
}

# Allowed fields per rule type, for validation + did-you-mean.
_COMMON_FIELDS = ("name", "type", "severity", "for_s")
_FIELDS = {
    "threshold": _COMMON_FIELDS + ("metric", "op", "value"),
    "rate": _COMMON_FIELDS + ("metric", "op", "value"),
    "absence": _COMMON_FIELDS + ("signal", "signal_prefix", "max_age_s"),
    "burn_rate": _COMMON_FIELDS + ("max_burn",),
}
_REQUIRED = {
    "threshold": ("metric", "op", "value"),
    "rate": ("metric", "op", "value"),
    "absence": ("max_age_s",),
    "burn_rate": ("max_burn",),
}


def severity_rank(severity: str) -> int:
    return SEVERITIES.index(severity)


def max_severity(severities: Iterable[str]) -> Optional[str]:
    ranked = sorted(severities, key=severity_rank)
    return ranked[-1] if ranked else None


def _suggest(bad: str, options: Iterable[str]) -> str:
    close = difflib.get_close_matches(bad, list(options), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


class AlertRule:
    """One parsed rule. Construct via :func:`parse_rules` /
    :func:`load_rules` — the constructor trusts its inputs."""

    def __init__(self, doc: Dict[str, Any]):
        self.name: str = doc["name"]
        self.type: str = doc["type"]
        self.severity: str = doc.get("severity", "warn")
        self.for_s: float = float(doc.get("for_s", 0.0))
        self.metric: Optional[str] = doc.get("metric")
        self.op: str = doc.get("op", ">")
        self.value: float = float(doc.get("value", 0.0))
        self.signal: Optional[str] = doc.get("signal")
        self.signal_prefix: Optional[str] = doc.get("signal_prefix")
        self.max_age_s: float = float(doc.get("max_age_s", 0.0))
        self.max_burn: float = float(doc.get("max_burn", 0.0))

    def as_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "type": self.type,
               "severity": self.severity, "for_s": self.for_s}
        if self.type in ("threshold", "rate"):
            out.update(metric=self.metric, op=self.op, value=self.value)
        elif self.type == "absence":
            out.update(signal=self.signal,
                       signal_prefix=self.signal_prefix,
                       max_age_s=self.max_age_s)
        else:
            out.update(max_burn=self.max_burn)
        return out


def parse_rules(doc: Any) -> List[AlertRule]:
    """Validate a rules document (``{"rules": [...]}``) into rule
    objects. Every rejection is a ``ValueError`` naming the offending
    rule and, for misspellings, the closest accepted spelling — a rules
    file is operator-written config and deserves config.py-grade
    errors, not a KeyError at 3am."""
    if not isinstance(doc, dict) or not isinstance(doc.get("rules"), list):
        raise ValueError(
            "alert rules document must be an object with a 'rules' list, "
            "e.g. {\"rules\": [{\"name\": ..., \"type\": ...}]}")
    rules: List[AlertRule] = []
    seen: set = set()
    for i, rd in enumerate(doc["rules"]):
        where = f"alert rule #{i}"
        if not isinstance(rd, dict):
            raise ValueError(f"{where}: must be an object, got "
                             f"{type(rd).__name__}")
        name = rd.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError(f"{where}: missing a non-empty 'name'")
        where = f"alert rule {name!r}"
        if name in seen:
            raise ValueError(f"{where}: duplicate rule name (dedup is "
                             f"by (rule, labels) — names must be unique)")
        seen.add(name)
        rtype = rd.get("type")
        if rtype not in RULE_TYPES:
            raise ValueError(
                f"{where}: unknown type {rtype!r}"
                f"{_suggest(str(rtype), RULE_TYPES)}; expected one of "
                f"{list(RULE_TYPES)}")
        for key in rd:
            if key not in _FIELDS[rtype]:
                raise ValueError(
                    f"{where}: unknown field {key!r} for type "
                    f"{rtype!r}{_suggest(key, _FIELDS[rtype])}")
        for req in _REQUIRED[rtype]:
            if rtype == "absence" and req == "max_age_s" \
                    and "max_age_s" not in rd:
                raise ValueError(f"{where}: absence rules need "
                                 f"'max_age_s' (seconds)")
            if req not in rd:
                raise ValueError(f"{where}: type {rtype!r} requires "
                                 f"field {req!r}")
        if rtype == "absence" and not (rd.get("signal")
                                       or rd.get("signal_prefix")):
            raise ValueError(f"{where}: absence rules need 'signal' "
                             f"or 'signal_prefix'")
        sev = rd.get("severity", "warn")
        if sev not in SEVERITIES:
            raise ValueError(
                f"{where}: unknown severity {sev!r}"
                f"{_suggest(str(sev), SEVERITIES)}; expected one of "
                f"{list(SEVERITIES)}")
        op = rd.get("op", ">")
        if rtype in ("threshold", "rate") and op not in _OPS:
            raise ValueError(
                f"{where}: unknown op {op!r}"
                f"{_suggest(str(op), _OPS)}; expected one of "
                f"{sorted(_OPS)}")
        if float(rd.get("for_s", 0.0)) < 0:
            raise ValueError(f"{where}: for_s must be >= 0")
        rules.append(AlertRule(rd))
    return rules


def load_rules(path: str) -> List[AlertRule]:
    """Parse + validate a rules file. OSError propagates (a missing
    rules file the config named is a deployment error, not a
    degradable signal); invalid JSON and invalid rules both raise
    ValueError naming the file."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except ValueError as e:
            raise ValueError(f"alert rules file {path!r} is not valid "
                             f"JSON: {e}") from e
    try:
        return parse_rules(doc)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e


class AlertEvaluator:
    """Rule lifecycle state machine over successive evaluations.

    One evaluator per process; callers invoke :meth:`evaluate` at their
    existing flush points (the experiment epoch flush, the engine's
    ``flush_metrics``, the supervisor tick) — alerting adds no new
    clocks. All inputs are plain data: ``snapshot`` is a metric
    name→value mapping, ``ages`` maps liveness-signal names to seconds
    since last proof of life, ``burn_rates`` maps tenant → burn rate.
    """

    def __init__(self, rules: List[AlertRule], *, source: str = "",
                 snapshot_path: Optional[str] = None):
        self.rules = list(rules)
        self.source = source
        self.snapshot_path = snapshot_path
        # (rule_name, labels_key) -> {"state", "since", "severity", ...}
        self._state: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # metric -> (ts, value) for rate rules (reset-aware).
        self._prev: Dict[str, Tuple[float, float]] = {}
        self.fired_total = 0
        self.resolved_total = 0

    # -- condition evaluation ------------------------------------------

    @staticmethod
    def _labels_key(labels: Dict[str, str]) -> str:
        return json.dumps(labels, sort_keys=True)

    def _instances(self, rule: AlertRule, now: float,
                   snapshot: Dict[str, Any],
                   ages: Dict[str, float],
                   burn_rates: Dict[str, Any]
                   ) -> List[Tuple[Dict[str, str], float]]:
        """All (labels, observed_value) pairs for which the rule's
        condition is TRUE right now. An instance absent from the
        returned list counts as condition-false (and resolves if it was
        firing)."""
        true_now: List[Tuple[Dict[str, str], float]] = []
        if rule.type == "threshold":
            value = snapshot.get(rule.metric)
            if isinstance(value, (int, float)) \
                    and math.isfinite(float(value)) \
                    and _OPS[rule.op](float(value), rule.value):
                true_now.append(({}, float(value)))
        elif rule.type == "rate":
            value = snapshot.get(rule.metric)
            if isinstance(value, (int, float)) \
                    and math.isfinite(float(value)):
                prev = self._prev.get(rule.metric)
                self._prev[rule.metric] = (now, float(value))
                if prev is not None:
                    p_ts, p_val = prev
                    dt = now - p_ts
                    if dt > 0:
                        # Reset-aware (report.py's _accumulate_counter
                        # rule): a counter below its predecessor is a
                        # restarted process — the new value contributes
                        # whole, never a negative rate.
                        delta = (float(value) if float(value) < p_val
                                 else float(value) - p_val)
                        rate = delta / dt
                        if _OPS[rule.op](rate, rule.value):
                            true_now.append(({}, rate))
        elif rule.type == "absence":
            # Only signals PRESENT in ``ages`` are judged: each process
            # feeds the liveness signals it owns (trainer: heartbeat;
            # supervisor: one lease age per slot, ``inf`` for a lease
            # file that vanished), so a shared rules file never makes
            # the serving engine page about a heartbeat it does not
            # emit. ``inf`` ages render as null (strict-JSON rule).
            for sig, age in ages.items():
                matched = (sig == rule.signal
                           or (rule.signal_prefix is not None
                               and sig.startswith(rule.signal_prefix)))
                if matched and age > rule.max_age_s:
                    true_now.append((
                        {"signal": sig},
                        float(age) if math.isfinite(age) else None))
        else:  # burn_rate
            for tenant, burn in burn_rates.items():
                if isinstance(burn, (int, float)) \
                        and math.isfinite(float(burn)) \
                        and float(burn) > rule.max_burn:
                    true_now.append(({"tenant": str(tenant)},
                                     float(burn)))
        return true_now

    # -- lifecycle ------------------------------------------------------

    def evaluate(self, now: Optional[float] = None, *,
                 snapshot: Optional[Dict[str, Any]] = None,
                 ages: Optional[Dict[str, float]] = None,
                 burn_rates: Optional[Dict[str, Any]] = None,
                 jsonl: Any = None,
                 registry: Any = None) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the TRANSITION rows (state
        "firing" or "resolved" — pending entry/exit is silent, that is
        the hysteresis working). Each transition is logged as an
        :data:`ALERT_EVENT` row when ``jsonl`` is given; when
        ``registry`` is given the :data:`FIRING_GAUGE` gauge tracks the
        active count; when ``snapshot_path`` was configured the
        ALERTS.json active set is rewritten after every pass."""
        now = time.time() if now is None else float(now)
        snapshot = snapshot or {}
        ages = ages or {}
        burn_rates = burn_rates or {}
        transitions: List[Dict[str, Any]] = []
        for rule in self.rules:
            true_now = self._instances(rule, now, snapshot, ages,
                                       burn_rates)
            true_keys = set()
            for labels, value in true_now:
                key = (rule.name, self._labels_key(labels))
                true_keys.add(key)
                st = self._state.get(key)
                if st is None:
                    st = {"state": "pending", "since": now,
                          "labels": labels, "severity": rule.severity,
                          "rule": rule.name, "value": value}
                    self._state[key] = st
                st["value"] = value
                if st["state"] == "pending" \
                        and now - st["since"] >= rule.for_s:
                    st["state"] = "firing"
                    st["fired_ts"] = now
                    self.fired_total += 1
                    transitions.append(self._transition(
                        rule, st, "firing", now))
            # Condition-false sweep: resolve firing instances, drop
            # pendings (hysteresis reset — the condition blinked).
            for key in [k for k in self._state
                        if k[0] == rule.name and k not in true_keys]:
                st = self._state.pop(key)
                if st["state"] == "firing":
                    self.resolved_total += 1
                    transitions.append(self._transition(
                        rule, st, "resolved", now))
        if jsonl is not None:
            for t in transitions:
                jsonl.log(ALERT_EVENT, **t)
        if registry is not None:
            registry.gauge(FIRING_GAUGE).set(
                float(self.firing_summary()["count"]))
        if self.snapshot_path:
            self.write_snapshot(now=now)
        return transitions

    def _transition(self, rule: AlertRule, st: Dict[str, Any],
                    state: str, now: float) -> Dict[str, Any]:
        return {
            "rule": rule.name, "type": rule.type,
            "severity": rule.severity, "state": state,
            "labels": dict(st["labels"]), "value": st.get("value"),
            "since_ts": st["since"], "fired_ts": st.get("fired_ts"),
            "at_ts": now, "source": self.source,
        }

    # -- introspection --------------------------------------------------

    def active(self) -> List[Dict[str, Any]]:
        """Currently-firing instances (pendings excluded), critical
        first then by rule name — the ALERTS.json / console order."""
        rows = [dict(st) for st in self._state.values()
                if st["state"] == "firing"]
        rows.sort(key=lambda r: (-severity_rank(r["severity"]),
                                 r["rule"], self._labels_key(r["labels"])))
        return rows

    def firing_summary(self) -> Dict[str, Any]:
        """``{"count", "max_severity"}`` — the compact form heartbeat
        rows and replica lease payloads carry fleet-wide."""
        act = self.active()
        return {"count": len(act),
                "max_severity": max_severity(r["severity"] for r in act)}

    def write_snapshot(self, path: Optional[str] = None,
                       now: Optional[float] = None) -> Dict[str, Any]:
        """ALERTS.json: the active set, atomically replaced (tmp.pid →
        fsync → rename, the ckpt-manifest idiom — a console never reads
        a torn file)."""
        path = path or self.snapshot_path
        now = time.time() if now is None else float(now)
        act = self.active()
        counts = {sev: 0 for sev in SEVERITIES}
        for row in act:
            counts[row["severity"]] += 1
        doc = {"updated_ts": now, "source": self.source,
               "firing": act, "counts": counts,
               "fired_total": self.fired_total,
               "resolved_total": self.resolved_total}
        if path:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        return doc


def read_snapshots(paths: Iterable[str]) -> List[Dict[str, Any]]:
    """Parse ALERTS.json files, fail-soft (a torn/missing file is an
    empty contribution — the console must render a half-dead fleet)."""
    docs: List[Dict[str, Any]] = []
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("firing"), list):
            docs.append(doc)
    return docs
