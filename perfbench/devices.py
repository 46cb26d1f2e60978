"""The card: the check that it is there, the device path each run drives,
and the reading of the profiler's trace.

The controller's path never touches the card; the port's only device
path is the graft entry's MLP (``agac_tpu_torch/graft_entry.py``).  A
run drives it once at the start of its window, so a traced run has
device work to read, and reports the card's idle share beside it.
"""

from __future__ import annotations

import sys
import time


class NoCard(SystemExit):
    pass


class Card:
    """The first ``chips`` CUDA devices; exits the run without a result
    when they are not there."""

    platform = "gpu"

    def __init__(self, chips: int, seed: int):
        try:
            import torch
        except ImportError as err:
            print(f"perfbench: torch is not importable: {err}", file=sys.stderr)
            raise NoCard(3) from None
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: the cell needs {chips} CUDA device(s), found {count}", file=sys.stderr)
            raise NoCard(3)
        self.torch = torch
        self.count = chips
        self.kind = torch.cuda.get_device_name(0)
        from agac_tpu_torch import graft_entry

        generator = torch.Generator(device="cuda").manual_seed(seed % 2**63)
        self.model = graft_entry.GraftMLP(graft_entry.init_params(generator))
        self.x = (0.02 * torch.randn(graft_entry.BATCH, graft_entry.FEATURES, generator=generator,
                                     device="cuda")).to(torch.bfloat16)
        self.step()  # warm: context, kernels

    def step(self) -> None:
        with self.torch.no_grad():
            self.model(self.x)
        self.torch.cuda.synchronize()

    def memory_peak_bytes(self) -> int:
        return int(max(self.torch.cuda.max_memory_allocated(i) for i in range(self.count)))

    def tracer(self) -> "Tracer":
        return Tracer(self.torch)


class Tracer:
    """``torch.profiler`` over the window: the seconds in which a kernel
    ran on the card (the union of their intervals), the window's length,
    and the kernels that took most time."""

    def __init__(self, torch):
        self.torch = torch
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.profile = torch.profiler.profile(activities=activities)

    def __enter__(self):
        self.profile.__enter__()
        self.started = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.window_s = time.monotonic() - self.started
        self.profile.__exit__(*exc)
        spans, by_name = [], {}
        cuda = self.torch.autograd.DeviceType.CUDA
        for event in self.profile.events():
            if event.device_type != cuda:
                continue
            start, end = event.time_range.start, event.time_range.end
            spans.append((start, end))
            by_name[event.name] = by_name.get(event.name, 0.0) + (end - start) / 1e6
        busy, reach = 0.0, None
        for start, end in sorted(spans):
            if reach is None or start > reach:
                busy += end - start
                reach = end
            elif end > reach:
                busy += end - reach
                reach = end
        self.busy_s = busy / 1e6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return False


class NoDevice:
    """Stands in for the card in the CPU tests, which drive every other
    part of a run; its numbers are not the card's and are never printed
    as a result of the benchmark's command."""

    platform, kind, count = "cpu", "none", 1

    def step(self) -> None:
        pass

    def memory_peak_bytes(self) -> int:
        return 0

    def tracer(self):
        return _NoTracer()


class _NoTracer:
    busy_s, window_s, device_ops = 0.0, 0.0, []

    def __enter__(self):
        self.started = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.window_s = time.monotonic() - self.started
        return False
