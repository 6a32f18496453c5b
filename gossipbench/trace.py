"""The traced run's reading of a ``torch.profiler`` trace: the device's
busy time (the union of its intervals), device time by kernel name, the
largest idle gaps with what the host was doing in each, and a kernel's
share of its roofline.

The busy-time arithmetic is a copy of the program's
``bench.device_breakdown``; the host-side labels read the same trace.
"""

from __future__ import annotations

import importlib
import re
from typing import Optional

import torch

TOP = 10


def profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def short_name(name: str) -> str:
    for noise in ("(anonymous namespace)::", "at::native::"):
        name = name.replace(noise, "")
    return name.removeprefix("void ")[:96]


def events(prof) -> tuple:
    """(device spans, host spans): sorted ``(start_us, end_us, name)``."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, short_name(e.name))
        if e.device_type == DeviceType.CUDA:
            dev.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    return sorted(dev), sorted(host)


def busy(spans) -> tuple:
    """(busy µs, the merged intervals) of sorted device spans."""
    merged = []
    for s, e, _ in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _host_at(host, t: float) -> str:
    """The innermost host span that holds ``t``."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "untraced host code"


def breakdown(dev, host) -> dict:
    """The ``breakdown`` of a traced run: the device operations that
    took most time, and the longest idle gaps between device intervals,
    each named by the host span it fell in."""
    by_name: dict = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    _, merged = busy(dev)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    return {"device_ops": [[k, v * 1e-6] for k, v in ops],
            "idle_gaps": [[_host_at(host, m), g * 1e-6] for g, m in gaps]}


def roofline(ctx, kernel: str) -> Optional[float]:
    """100 x the least time of one launch of ``kernel`` (its frozen count
    in ``bounds/<kernel>.py`` at the published peaks) over the kernel's
    mean device time a launch in the trace; None where the trace holds
    no launch of it."""
    pat = re.compile(rf"\b{kernel}<")
    times = [e - s for s, e, name in ctx.dev if pat.search(name)]
    if not times:
        return None
    bound = importlib.import_module(f"gossipbench.bounds.{kernel}")
    least = bound.bound_s(ctx.cfg, ctx.traffic, ctx.n)
    return 100.0 * least / (sum(times) / len(times) * 1e-6)
