"""Named wall-clock timer registry (≙ src/timer.{h,c};
a copy of splatt_tpu/utils/timers.py).

The reference keeps a global array of named timers with verbosity levels
gating which are reported (timers[TIMER_NTIMERS], src/timer.h:36-85;
report_times, src/timer.c:67-90).  Same idea here: a process-global
registry, `timers.start/stop(name)` brackets, and a leveled report.

Every timer bracket is also a ``timer.<name>`` span of
:mod:`splatt_tpu_torch.trace`: with tracing on, the brackets this module
sums appear on the exported Chrome trace; with tracing off the span
handles are shared no-ops and only the wall-clock totals exist.

A started-but-never-stopped timer reports its live total:
:meth:`Timer.current` folds the running interval in, and
:meth:`TimerRegistry.report` marks such timers ``(running)``.

CUDA work is asynchronous: a bracket measures the card's time only when
it closes after a fence (``utils/env.host_fence``), as the profiled
sweeps do; elsewhere it measures the host's enqueue.
"""

from __future__ import annotations

import time
from typing import Dict

# Report levels (≙ timer_lvl in src/timer.h): 0 none, 1 summary, 2 detail.
_DEFAULT_LEVELS = {
    "total": 1,
    "io": 1,
    "blocked_build": 1,   # ≙ TIMER_CSF
    "sort": 2,            # ≙ TIMER_SORT
    "cpd": 1,             # ≙ TIMER_CPD
    "mttkrp": 2,          # ≙ TIMER_MTTKRP
    "solve": 2,           # ≙ TIMER_INV
    "normalize": 2,       # ≙ TIMER_MATNORM
    "gram": 2,            # ≙ TIMER_ATA
    "fit": 2,             # ≙ TIMER_FIT
    "reorder": 2,         # ≙ TIMER_PART
    "bench": 1,
}


class Timer:
    __slots__ = ("name", "seconds", "_t0", "running", "level", "_span")

    def __init__(self, name: str, level: int = 2) -> None:
        self.name = name
        self.seconds = 0.0
        self._t0 = 0.0
        self.running = False
        self.level = level
        self._span = None

    def start(self) -> None:
        if not self.running:
            self.running = True
            # the bracket is also a timer.<name> span (a shared no-op
            # when tracing is off) — one accounting, two views
            from splatt_tpu_torch import trace

            self._span = trace.begin(f"timer.{self.name}")
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.running:
            self.seconds += time.perf_counter() - self._t0
            self.running = False
            if self._span is not None:
                from splatt_tpu_torch import trace

                trace.end(self._span)
                self._span = None

    def current(self) -> float:
        """Accumulated seconds INCLUDING the still-running interval —
        the honest total a report must print (the old `.seconds` read
        went stale the moment a bracket was left open)."""
        if self.running:
            return self.seconds + (time.perf_counter() - self._t0)
        return self.seconds

    def reset(self) -> None:
        self.seconds = 0.0
        self.running = False
        if self._span is not None:
            # close (not drop) a still-open bracket's span: a leaked
            # open handle would stay in the recorder forever and
            # mis-parent every later span in this context
            from splatt_tpu_torch import trace

            trace.end(self._span)
            self._span = None


class TimerRegistry:
    def __init__(self) -> None:
        self._timers: Dict[str, Timer] = {}
        for name, lvl in _DEFAULT_LEVELS.items():
            self._timers[name] = Timer(name, lvl)

    def get(self, name: str, level: int = 2) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name, level)
        return self._timers[name]

    def start(self, name: str) -> None:
        self.get(name).start()

    def stop(self, name: str) -> None:
        self.get(name).stop()

    def reset(self) -> None:
        for t in self._timers.values():
            t.reset()

    def __getitem__(self, name: str) -> float:
        return self.get(name).current()

    class _Bracket:
        def __init__(self, timer: Timer) -> None:
            self.timer = timer

        def __enter__(self):
            self.timer.start()
            return self.timer

        def __exit__(self, *exc):
            self.timer.stop()
            return False

    def time(self, name: str) -> "TimerRegistry._Bracket":
        return self._Bracket(self.get(name))

    def report(self, level: int = 1) -> str:
        """≙ report_times (src/timer.c:67-90).  Running (never-stopped)
        timers report their live total, marked ``(running)``."""
        lines = ["", "Timing information ---------------------------------"]
        for t in self._timers.values():
            secs = t.current()
            if secs > 0 and t.level <= level:
                mark = "  (running)" if t.running else ""
                lines.append(f"  {t.name + ':':<16s} {secs:0.3f}s{mark}")
        return "\n".join(lines)


timers = TimerRegistry()
