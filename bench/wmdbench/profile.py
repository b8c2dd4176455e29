"""The traced window: ``torch.profiler`` (CPU and CUDA activity) over a run
of calls, reduced to what the per-layer metrics read.

Device time is the union of the intervals of every kernel, copy and set
on the device inside the window (so overlapping work and copies count
once); the window runs from the first call's start to the last call's
end, each call inside a ``bench.call`` span."""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import NamedTuple

from bench.wmdbench.window import run_calls

# runtime calls the host makes to launch a kernel or wait for the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
RUNTIME_PREFIXES = ("cuda", "cu")
# host ops looked back through to name an idle gap
SCAN = 512


class Trace(NamedTuple):
    device: list        # (name, start_us, end_us) of every device event
    host: list          # (name, start_us, end_us) of host ops and runtime
                        # calls
    runtime: Counter    # runtime-call counts inside the window
    spans: dict         # bench.* span name -> (count, device us in them)
    window: tuple       # (start_us, end_us)
    calls: list         # the traced window's calls

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernel_us(self, patterns) -> float:
        """Device time of the events whose name holds one of
        ``patterns``."""
        return sum(e - s for n, s, e in self.device
                   if any(p in n for p in patterns))

    def busy_us(self) -> float:
        """Union of the device intervals, clipped to the window."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                    if e > lo and s < hi)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def gaps(self) -> list:
        """(start_us, end_us) of each interval of the window in which the
        device ran nothing."""
        lo, hi = self.window
        out, t = [], lo
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                    if e > lo and s < hi)
        for s, e in iv:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out


def traced_calls(system, batch: int, pool_size: int, seconds: float,
                 start: int, device) -> Trace:
    """Calls for ``seconds`` under the profiler, reduced to a Trace (on
    the host alone where ``device`` is the CPU: no device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    if on_card:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        calls = run_calls(system, batch, pool_size, seconds, start,
                          profile_span=record_function)
        if on_card:
            torch.cuda.synchronize(device)
    device, host, spans_raw, runtime_all = [], [], [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith("bench."):
            # a span also shows on the device's timeline: not device work
            if e.device_type != DeviceType.CUDA:
                spans_raw.append((e.name, s, t, e.device_time_total))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, s, t))
        else:
            if e.name.startswith(RUNTIME_PREFIXES):
                runtime_all.append((e.name, s))
            host.append((e.name, s, t))
    calls_iv = [(s, t) for n, s, t, _ in spans_raw if n == "bench.call"]
    window = ((min(s for s, _ in calls_iv), max(t for _, t in calls_iv))
              if calls_iv else (0.0, 0.0))
    runtime = Counter(n for n, s in runtime_all
                      if window[0] <= s <= window[1])
    spans = defaultdict(lambda: [0, 0.0])
    for n, s, t, dev_us in spans_raw:
        spans[n][0] += 1
        spans[n][1] += dev_us
    return Trace(device=device, host=host, runtime=runtime,
                 spans={k: tuple(v) for k, v in spans.items()},
                 window=window, calls=calls)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing then: the innermost host op or runtime call
    running at the gap's middle, or "python after <op>" (the op that ended
    last before it) where none was; each list at most ``top`` long."""
    ops = defaultdict(float)
    lo, hi = trace.window
    for n, s, e in trace.device:
        if e > lo and s < hi:
            ops[n[:160]] += (min(e, hi) - max(s, lo)) / 1e6
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = defaultdict(float)
    for s, e in trace.gaps():
        mid = 0.5 * (s + e)
        name, after = None, None
        # the latest-starting op that still runs at mid is the innermost
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(-1, last - SCAN), -1):
            if host[i][2] >= mid:
                name = host[i][0][:160]
                break
            if after is None or host[i][2] > after[1]:
                after = (host[i][0], host[i][2])
        if name is None:
            name = "python after " + (after[0][:140] if after else "start")
        idle[name] += (e - s) / 1e6
    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": best(ops), "idle_gaps": best(idle)}
