"""One-screen text dashboard over a live session's rollups and alerts.

``render(target)`` returns a terminal-sized snapshot string;
``watch(target)`` re-renders on an interval. ``target`` is a
``DiskJoinIndex`` (with ``attach_live()`` called), an ``IndexRouter``
whose shards have live observers, or a bare ``LiveObserver``::

    index.attach_live(window_s=1.0)
    ... serve traffic ...
    print(repro_torch.obs.dash.render(index))

The dashboard is pull-based: each render polls the rollup (closing any
overdue windows), reads the merged ``live`` section, and formats spans
(rate + p50/p95/p99), counters, SLO burn states, active alerts, and the
live cost-model constants. No background thread, no extra bookkeeping —
everything shown is already in ``metrics_snapshot()["live"]``.
"""
from __future__ import annotations

import sys
import time

from repro_torch.obs.live import LiveObserver, merge_live_sections


def _fmt_s(v: float) -> str:
    """Duration → human units (µs/ms/s)."""
    if v <= 0:
        return "0"
    if v < 1e-3:
        return f"{v * 1e6:.0f}µs"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def _observers(target) -> list[LiveObserver]:
    if isinstance(target, LiveObserver):
        return [target]
    live = getattr(target, "live", None)           # DiskJoinIndex
    if live is not None:
        return [live]
    shards = getattr(target, "shards", None)       # IndexRouter
    if shards is not None:
        return [s.live for s in shards if s.live is not None]
    raise TypeError(
        f"dash target must be a DiskJoinIndex/IndexRouter with live "
        f"observability attached (attach_live()) or a LiveObserver, "
        f"got {type(target).__name__}")


def render(target, *, width: int = 78, title: str = "DiskJoin live"
           ) -> str:
    """One-screen text snapshot of rollups + SLOs + alerts."""
    observers = _observers(target)
    if not observers:
        return f"{title}: no live observers attached"
    for obs in observers:
        obs.poll()
    sections = [obs.section() for obs in observers]
    sec = sections[0] if len(sections) == 1 else \
        merge_live_sections(sections)

    lines = []
    head = (f"{title} · {len(observers)} session(s) · window "
            f"{sec.get('window_s', 0):g}s × {sec.get('windows', 0)} · "
            f"{sec.get('events', 0)} events")
    lines.append(head[:width])
    lines.append("─" * min(width, len(head)))

    spans = {n: a for n, a in (sec.get("spans") or {}).items() if a}
    if spans:
        lines.append(f"{'span':<24}{'n':>8}{'rate/s':>9}{'p50':>9}"
                     f"{'p95':>9}{'p99':>9}")
        horizon_s = (sec.get("window_s") or 1.0) * max(
            1, sec.get("windows") or 1)
        for name in sorted(spans):
            a = spans[name]
            lines.append(
                f"  {name:<22}{a['count']:>8}"
                f"{a['count'] / horizon_s:>9.1f}"
                f"{_fmt_s(a.get('p50', 0)):>9}"
                f"{_fmt_s(a.get('p95', 0)):>9}"
                f"{_fmt_s(a.get('p99', 0)):>9}")
    else:
        lines.append("(no spans in the retained windows — is tracing "
                     "enabled and traffic flowing?)")

    counters = sec.get("counters") or {}
    if counters:
        row = "  ".join(f"{n}={c['last']:g}(max {c['max']:g})"
                        for n, c in sorted(counters.items()))
        lines.append(f"counters: {row}"[:width])
    instants = sec.get("instants") or {}
    if instants:
        row = "  ".join(f"{n}×{c}" for n, c in sorted(instants.items()))
        lines.append(f"instants: {row}"[:width])

    cal = sec.get("calibration")
    if cal:
        cals = cal if isinstance(cal, list) else [cal]
        for i, c in enumerate(cals):
            parts = []
            r = c.get("read_s_per_bucket")
            if r:
                parts.append(f"read={_fmt_s(r['value'])}/bucket "
                             f"({r['samples']} spans/{r['windows']}w)")
            l = c.get("h2d_gb_s")
            if l:
                parts.append(f"link={l['value']:.2f} GB/s "
                             f"({l['samples']} spans)")
            tag = f" shard{i}" if len(cals) > 1 else ""
            lines.append(f"live cost{tag}: " + ", ".join(parts))

    slos = sec.get("slos") or {}
    if slos:
        lines.append("slos:")
        for name in sorted(slos):
            st = slos[name]
            state = st.get("state", "ok").upper()
            good = st.get("good_fraction")
            good_s = "  n/a " if good is None else f"{good:6.1%}"
            lines.append(
                f"  {name:<22}{state:>7}  good={good_s}  burn "
                f"fast={st.get('fast_burn', 0):.2f} "
                f"slow={st.get('slow_burn', 0):.2f}")
    alerts = sec.get("alerts") or {}
    if alerts:
        active = alerts.get("active", [])
        lines.append(f"alerts: {len(active)} active · "
                     f"{alerts.get('fired', 0)} fired · "
                     f"{alerts.get('resolved', 0)} resolved")
        for a in active:
            lines.append(f"  [FIRING] {a.get('slo')} burn "
                         f"fast={a.get('fast_burn', 0):.2f} "
                         f"slow={a.get('slow_burn', 0):.2f}")
    return "\n".join(lines)


def watch(target, *, interval_s: float = 2.0,
          iterations: int | None = None, out=None, clear: bool = True
          ) -> None:
    """Re-render ``target`` every ``interval_s`` seconds until
    interrupted (or for ``iterations`` renders — tests/demos pass a
    bound). ``clear`` prefixes the ANSI home+clear sequence so the
    screen updates in place."""
    out = out if out is not None else sys.stdout
    i = 0
    try:
        while iterations is None or i < iterations:
            text = render(target)
            if clear:
                out.write("\x1b[H\x1b[2J")
            out.write(text + "\n")
            out.flush()
            i += 1
            if iterations is not None and i >= iterations:
                break
            time.sleep(interval_s)
    except KeyboardInterrupt:
        pass
