"""Hierarchical named timers — the Pacer/GPTL analogue (share/pacer/Pacer.h).

`Timers` keeps a registry of named accumulating timers with nesting levels;
`auto_fence` waits for the card's queued work at scope exit
(`torch.cuda.synchronize()`) so device work is attributed to the right
scope (the reference's AutoFence Kokkos fences, configs/Default.yml
Timing.AutoFence). A scope fences only when it is given a CUDA tensor (or
a tuple of tensors, the first of which is looked at) to fence on. For
kernel-level profiles use torch.profiler; these timers are the cheap
always-on layer.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Timers:
    def __init__(self, level: int = 2, auto_fence: bool = False):
        self.level = level
        self.auto_fence = auto_fence
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._stack = []

    @contextlib.contextmanager
    def scope(self, name: str, level: int = 1, fence_on=None):
        if level > self.level:
            yield
            return
        full = "/".join([*self._stack, name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if (self.auto_fence and isinstance(fence_on, torch.Tensor)
                    and fence_on.is_cuda):
                torch.cuda.synchronize()
            self.totals[full] += time.perf_counter() - t0
            self.counts[full] += 1
            self._stack.pop()

    def report(self) -> str:
        lines = ["timer                                    calls     total(s)"]
        for name in sorted(self.totals):
            lines.append(f"{name:40s} {self.counts[name]:6d} "
                         f"{self.totals[name]:12.6f}")
        return "\n".join(lines)


_global = Timers()


def timer(name: str, level: int = 1, fence_on=None):
    return _global.scope(name, level, fence_on)
