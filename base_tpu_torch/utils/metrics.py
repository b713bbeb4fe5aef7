"""Observability: structured metrics, throughput counters, profiling (port
of base_tpu.utils.metrics).

- `MetricsLogger` writes structured JSONL (one object per window) with
  samples/sec, logpost-evals/sec, acceptance, R-hat/ESS summaries.
- `profile_trace` wraps a region in a torch.profiler session and writes
  a Chrome trace (`trace.json`) to a directory: for reading where the time
  goes, not for timing a kernel (short sessions have lost their records
  on the card: PERF.md section 6).
- `named_scope` is `torch.profiler.record_function`, which labels a
  region in that trace.
- `debug_guards` turns on autograd's anomaly mode with NaN checks.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, Any

import torch

named_scope = torch.profiler.record_function


class MetricsLogger:
    """Append-only JSONL metrics stream with wall-clock deltas."""

    def __init__(self, path: str | None = None, stream: IO | None = None):
        self._fh = open(path, "a") if path else stream
        self._t0 = time.perf_counter()
        self._last = self._t0

    def log(self, event: str, **fields: Any) -> dict:
        now = time.perf_counter()
        rec = dict(
            event=event,
            t=round(now - self._t0, 4),
            dt=round(now - self._last, 4),
            **{
                k: (float(v) if hasattr(v, "item") else v)
                for k, v in fields.items()
            },
        )
        self._last = now
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def throughput(
        self, event: str, n_samples: int, n_evals: int, seconds: float,
        **extra: Any,
    ) -> dict:
        """The north-star counters: samples/sec and evals/sec."""
        return self.log(
            event,
            samples_per_sec=n_samples / max(seconds, 1e-9),
            evals_per_sec=n_evals / max(seconds, 1e-9),
            wall_s=seconds,
            **extra,
        )

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """torch.profiler session over the region, its Chrome trace written to
    `logdir/trace.json`; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def debug_guards(enable: bool = True):
    """Debug-mode numeric guards: autograd anomaly detection with NaN
    checks (a backward that produces NaN raises, naming the forward op),
    the previous mode restored on exit."""
    if not enable:
        yield
        return
    prev = torch.is_anomaly_enabled()
    prev_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev, check_nan=prev_nan)
