"""Tracing: OpenTelemetry spans when the package is importable and tracing
is on, a no-op :class:`MockSpan` otherwise, and the profiler windows of
the card — ``sentio_tpu/infra/tracing.py``.

* :class:`TracingManager` — ``span(name, **attributes)`` (an OTel span, or
  a ``MockSpan``), ``profile_step(name, step)`` (a
  ``torch.profiler.record_function`` range named ``"{name}#{step}"`` around
  one pump tick, where JAX opens a ``StepTraceAnnotation``, so a profile
  window's device timeline lines up with the flight recorder's ticks) and
  ``enabled``, the one bool the serving hot path tests before touching
  either (False when ``TRACING_ENABLED`` is off or OTel is absent);
* :func:`profile_window` — ``/debug/profile``'s window: a
  ``torch.profiler.profile`` over the CPU of every thread (the pump's
  ranges included, where the installed PyTorch offers
  ``profile_all_threads``) and, with a card, CUDA activity for
  ``seconds``, written as a Chrome trace under ``log_dir``; single-flight,
  never raises;
* :func:`warm_profiler` — the profiler's first start in a process sets up
  CUPTI, which takes seconds on the card (7–9 s on an H100 80GB HBM3 at
  700 W): the server pays it once when it is built, so a window opens when
  it is asked for.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

from sentio_tpu_torch.config import ObservabilityConfig

logger = logging.getLogger(__name__)

__all__ = ["MockSpan", "TracingManager", "get_tracing", "set_tracing", "profile_window",
           "warm_profiler"]


class MockSpan:
    def set_attribute(self, key: str, value: Any) -> "MockSpan":
        return self

    def record_exception(self, exc: BaseException) -> None:
        pass

    def set_status(self, *a, **k) -> None:
        pass

    def __enter__(self) -> "MockSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


class TracingManager:
    def __init__(self, config: Optional[ObservabilityConfig] = None) -> None:
        self.config = config or ObservabilityConfig.from_env()
        self._tracer = None
        # the hot path's guard: the pipeline and the pump test this one
        # bool before span() / profile_step()
        self.enabled = False
        if self.config.tracing_enabled:
            self._setup()

    def _setup(self) -> None:
        try:
            from opentelemetry import trace
            from opentelemetry.sdk.resources import Resource
            from opentelemetry.sdk.trace import TracerProvider
            from opentelemetry.sdk.trace.export import (
                BatchSpanProcessor,
                ConsoleSpanExporter,
                SimpleSpanProcessor,
            )

            provider = TracerProvider(
                resource=Resource.create({"service.name": self.config.service_name}))
            if self.config.otlp_endpoint:
                try:
                    from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                        OTLPSpanExporter,
                    )

                    provider.add_span_processor(BatchSpanProcessor(
                        OTLPSpanExporter(endpoint=self.config.otlp_endpoint)))
                except ImportError:
                    logger.warning("OTLP exporter unavailable; skipping")
            if self.config.console_exporter:
                provider.add_span_processor(SimpleSpanProcessor(ConsoleSpanExporter()))
            trace.set_tracer_provider(provider)
            self._tracer = trace.get_tracer(self.config.service_name)
            self.enabled = True
            logger.info("tracing enabled for %s", self.config.service_name)
        except ImportError:
            logger.info("opentelemetry not installed; tracing is a no-op")
            self._tracer = None
            self.enabled = False

    @contextmanager
    def span(self, name: str, **attributes: Any):
        if self._tracer is None:
            span = MockSpan()
            for k, v in attributes.items():
                span.set_attribute(k, v)
            yield span
            return
        with self._tracer.start_as_current_span(name) as span:
            for k, v in attributes.items():
                span.set_attribute(k, v)
            yield span

    @contextmanager
    def profile_step(self, name: str, step: int = 0):
        """A ``record_function`` range ``"{name}#{step}"`` and a span around
        the body. Only the range's setup is guarded: an exception of the
        body propagates unchanged (the pump's crash containment keys off
        it)."""
        scope = None
        try:
            import torch

            scope = torch.profiler.record_function(f"{name}#{step}")
            scope.__enter__()
        except Exception:  # noqa: BLE001 — no profiler range: the span alone
            scope = None
        try:
            with self.span(f"gpu.{name}", step=step):
                yield
        finally:
            if scope is not None:
                try:
                    scope.__exit__(*sys.exc_info())
                except Exception:  # noqa: BLE001 — closing a range is best-effort
                    logger.debug("record_function exit failed", exc_info=True)


_tracing: Optional[TracingManager] = None
_tracing_lock = threading.Lock()


def get_tracing() -> TracingManager:
    global _tracing
    with _tracing_lock:
        if _tracing is None:
            _tracing = TracingManager()
        return _tracing


def set_tracing(manager: Optional[TracingManager]) -> None:
    global _tracing
    with _tracing_lock:
        _tracing = manager


# ------------------------------------------------------- windowed profiler

_profile_lock = threading.Lock()
_profile_active = False
_profiler_warm = False


def _profiler(torch):
    """A profiler over the CPU and, with a card, its kernels. Every
    thread's ``record_function`` ranges are recorded where the installed
    PyTorch can (the pump opens its ranges on its own thread; by default
    only the starting thread's are)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):  # an older PyTorch: this thread's ranges only
        return torch.profiler.profile(activities=activities)
    return torch.profiler.profile(activities=activities, experimental_config=config)


def warm_profiler() -> bool:
    """Start and stop the profiler once, so that the process's first
    window opens at once; a no-op after the first call or when a window is
    open. Never raises; True when the profiler is warm."""
    global _profile_active, _profiler_warm
    with _profile_lock:
        if _profiler_warm or _profile_active:
            return _profiler_warm
        _profile_active = True
    try:
        import torch

        with _profiler(torch):
            pass
        _profiler_warm = True
    except Exception:  # noqa: BLE001 — a cold profiler only makes the first window late
        logger.warning("profiler warm-up failed", exc_info=True)
    finally:
        with _profile_lock:
            _profile_active = False
    return _profiler_warm


def profile_window(seconds: float, log_dir: str) -> dict:
    """Profile the whole process for ``seconds`` and write the window as a
    Chrome trace (``profile-<ms>.json``) under ``log_dir``: CPU activity
    and, with a card, its kernels. Single-flight: the profiler is
    process-wide, so a second window while one is open is refused.
    Blocking (sleeps through the window); returns ``{"started",
    "seconds", "log_dir"}`` or ``{"started": False, "error"}``, never
    raises."""
    global _profile_active, _profiler_warm
    with _profile_lock:
        if _profile_active:
            return {"started": False, "error": "a profile window is already active"}
        _profile_active = True
    try:
        try:
            import torch

            os.makedirs(log_dir, exist_ok=True)
            prof = _profiler(torch)
            prof.start()
            _profiler_warm = True
        except Exception as exc:  # noqa: BLE001 — an operator's answer, not a 500
            return {"started": False, "error": f"profiler start failed: {exc}"}
        try:
            time.sleep(max(float(seconds), 0.0))
        finally:
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"profile-{int(time.time() * 1e3)}.json"))
            except Exception:  # noqa: BLE001 — the window is over either way
                logger.warning("profiler stop or export failed", exc_info=True)
        return {"started": True, "seconds": float(seconds), "log_dir": log_dir}
    finally:
        with _profile_lock:
            _profile_active = False
