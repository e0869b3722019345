"""Alert webhooks: push SLO burn alerts out of the process.

``SloMonitor`` delivers alerts to in-process callbacks on the window
fold path — the thread that closes rollup windows. Anything slow there
(a network call most of all) would stall the fold and distort the very
latencies being monitored. ``WebhookSink`` decouples the two: the
callback only enqueues the alert into a bounded queue (dropping, and
counting the drop, when full — never blocking); a daemon thread POSTs
queued alerts as JSON via stdlib ``urllib``. Delivery failures are
counted, never raised — losing a webhook must not take down serving.

Usage::

    sink = WebhookSink("http://alerts.example/hook")
    observer = index.attach_live(slos=default_serving_slos())
    observer.monitor.on_alert(sink)
    ...
    sink.close()
    sink.snapshot()   # {"delivered": ..., "dropped": ..., "failures": ...}
"""
from __future__ import annotations

import json
import queue
import threading
import urllib.request

_CLOSE = object()


class WebhookSink:
    """Non-blocking ``SloMonitor.on_alert`` sink POSTing alerts as JSON.

    Parameters:
      url: webhook endpoint (http/https).
      queue_size: bounded backlog; alerts beyond it are dropped and
        counted (``dropped``) — the fold path never waits.
      timeout_s: per-POST socket timeout.
      headers: extra HTTP headers (merged over Content-Type).
    """

    def __init__(self, url: str, *, queue_size: int = 256,
                 timeout_s: float = 2.0, headers: dict | None = None):
        self.url = str(url)
        self.timeout_s = float(timeout_s)
        self.headers = {"Content-Type": "application/json",
                        **(headers or {})}
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_size))
        self._lock = threading.Lock()
        self.delivered = 0
        self.dropped = 0
        self.failures = 0
        self._thread = threading.Thread(target=self._loop,
                                        name="diskjoin-webhook",
                                        daemon=True)
        self._thread.start()

    # -- fold-path side (must never block or raise) ---------------------------
    def __call__(self, alert) -> None:
        payload = alert.to_dict() if hasattr(alert, "to_dict") else dict(
            alert if isinstance(alert, dict) else vars(alert))
        try:
            self._q.put_nowait(payload)
        except queue.Full:
            with self._lock:
                self.dropped += 1

    # -- delivery side --------------------------------------------------------
    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _CLOSE:
                return
            try:
                self._post(item)
            except Exception:
                with self._lock:
                    self.failures += 1
            else:
                with self._lock:
                    self.delivered += 1

    def _post(self, payload: dict) -> None:
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers=self.headers, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s):
            pass

    # -- lifecycle ------------------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Flush queued alerts (best effort) and stop the thread."""
        self._q.put(_CLOSE)
        self._thread.join(timeout=timeout)

    def snapshot(self) -> dict:
        with self._lock:
            return {"url": self.url, "delivered": self.delivered,
                    "dropped": self.dropped, "failures": self.failures,
                    "queued": self._q.qsize()}
