"""Performance and resource monitoring — ``sentio_tpu/infra/monitoring.py``:
threshold alerts and a health verdict, served by ``/metrics/performance``.

:class:`PerformanceMonitor` keeps the last alerts of each threshold a
recorded value crossed; its ``collect_system`` reads the host through ``psutil`` when it is
importable (no system block otherwise, as in JAX) and each card's
allocated share of its memory as ``hbm_percent_dev{i}`` (JAX reads the
TPU's ``bytes_in_use`` / ``bytes_limit``). :class:`ResourceMonitor` adds
the default thresholds of what ``collect_system`` reads, the verdict and
its recommendations.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

try:
    import psutil

    PSUTIL_AVAILABLE = True
except ImportError:  # the card's machine may not have it
    PSUTIL_AVAILABLE = False

__all__ = ["Alert", "PerformanceMonitor", "ResourceMonitor", "performance_monitor",
           "resource_monitor"]


@dataclass
class Alert:
    metric: str
    value: float
    threshold: float
    severity: str
    at: float = field(default_factory=time.perf_counter)


class PerformanceMonitor:
    def __init__(self) -> None:
        self._thresholds: dict[str, tuple[float, str]] = {}
        self._alerts: deque = deque(maxlen=256)

    def set_threshold(self, metric: str, threshold: float, severity: str = "warning") -> None:
        self._thresholds[metric] = (threshold, severity)

    def record(self, metric: str, value: float) -> None:
        threshold = self._thresholds.get(metric)
        if threshold and value > threshold[0]:
            self._alerts.append(Alert(metric, value, threshold[0], threshold[1]))

    def recent_alerts(self) -> list[Alert]:
        return list(self._alerts)

    def collect_system(self) -> dict[str, float]:
        out: dict[str, float] = {}
        if PSUTIL_AVAILABLE:
            out["cpu_percent"] = psutil.cpu_percent(interval=None)
            mem = psutil.virtual_memory()
            out["memory_percent"] = mem.percent
            out["memory_available_mb"] = mem.available / 1e6
        try:
            import torch

            if torch.cuda.is_available():
                for dev in range(torch.cuda.device_count()):
                    total = torch.cuda.get_device_properties(dev).total_memory
                    used = torch.cuda.memory_stats(dev).get("allocated_bytes.all.current")
                    if used is not None and total:
                        out[f"hbm_percent_dev{dev}"] = 100.0 * used / total
        except Exception:  # noqa: BLE001 — the device-memory scrape is best-effort telemetry
            pass
        for metric, value in out.items():
            self.record(metric, value)
        return out


class ResourceMonitor:
    """Default thresholds, a health verdict and recommendations."""

    DEFAULT_THRESHOLDS = {
        "cpu_percent": (90.0, "warning"),
        "memory_percent": (90.0, "critical"),
    }

    def __init__(self, monitor: Optional[PerformanceMonitor] = None) -> None:
        self.monitor = monitor or PerformanceMonitor()
        for metric, (threshold, severity) in self.DEFAULT_THRESHOLDS.items():
            self.monitor.set_threshold(metric, threshold, severity)

    def health_verdict(self, system: Optional[dict[str, float]] = None) -> dict[str, Any]:
        """The verdict over ``system`` (collected now when None) and the
        alerts of the last five minutes."""
        if system is None:
            system = self.monitor.collect_system()
        alerts = self.monitor.recent_alerts()
        recent = [a for a in alerts if time.perf_counter() - a.at < 300]
        critical = [a for a in recent if a.severity == "critical"]
        status = "unhealthy" if critical else "degraded" if recent else "healthy"
        recommendations = []
        if system.get("memory_percent", 0) > 80:
            recommendations.append("host memory pressure: shrink caches or batch sizes")
        for key, value in system.items():
            if key.startswith("hbm_percent") and value > 85:
                recommendations.append(
                    f"{key}: device memory nearly full — reduce KV window, corpus, or batch")
        return {"status": status, "system": system, "recent_alerts": len(recent),
                "recommendations": recommendations}


performance_monitor = PerformanceMonitor()
resource_monitor = ResourceMonitor(performance_monitor)
