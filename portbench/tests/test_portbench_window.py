"""The window's arithmetic: a rate is all the work over all the time of
the window, so a stall inside it moves the rate; and a traced window
profiles with the program's tracer off and spans the rest."""

import time

import pytest
import torch

from portbench import cell as cell_mod
from portbench import devtrace, manifest
from portbench.cell import Run


def _run(**kw):
    return Run("c", {"num_workers": 4}, {}, "cpu", None, **kw)


def test_rate_is_all_updates_over_the_whole_window():
    read = manifest.metric("updates_per_s").read
    assert read(_run(updates=1000, window_s=2.5)) == pytest.approx(400.0)
    assert read(_run(updates=1000, window_s=0.0)) is None


def _window(tiny, stall_s):
    """A small cell's window of 0.6 s on the CPU, its first call held up
    by `stall_s` seconds that the call's own timing does not see."""
    cr = cell_mod.CellRun(tiny("mlp4096.fused.backlog"), 7, 0.6, False,
                          "cpu", time.perf_counter())
    cr.build()
    cr.first_rounds()
    call = cr.call
    stalls = [stall_s]

    def held_up(rounds):
        if stalls:
            time.sleep(stalls.pop())
        return call(rounds)
    cr.call = held_up
    cr.window()
    cr.close()
    return cr.run


def test_a_stall_in_the_window_counts_in_the_rate(tiny):
    stalled = _window(tiny, 0.5)
    busy = sum(s for _, s in stalled.calls)     # the calls' own time
    assert stalled.window_s >= busy + 0.5
    rate = manifest.metric("updates_per_s").read
    assert rate(stalled) == pytest.approx(stalled.updates
                                          / stalled.window_s)
    assert rate(stalled) <= stalled.updates / (busy + 0.5)
    assert sum(r for r, _ in stalled.calls) * 4 == stalled.updates


class _Event:
    """A device event as torch.profiler's raw results give it."""

    def __init__(self, start_ns, end_ns):
        self.start, self.end = start_ns, end_ns

    def name(self):
        return "wide_update_pass"

    def device_type(self):
        return "DeviceType.CUDA"

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start


class _Profiler:
    def start(self):
        self.t0_ns = time.time_ns()

    def stop(self):
        self.t1_ns = time.time_ns()
        return [_Event(self.t0_ns, (self.t0_ns + self.t1_ns) // 2)]


def test_a_traced_window_profiles_with_the_tracer_off(tiny, monkeypatch):
    cr = cell_mod.CellRun(tiny("mlp4096.fused.backlog"), 5, 0.8, True,
                          "cpu", time.perf_counter())
    cr.build()
    cr.first_rounds()
    tracing = []
    call = cr.call

    def spy(rounds):
        tracing.append(cr.tracer.enabled)
        return call(rounds)
    cr.call = spy
    # the card's side of a traced window, on the CPU
    monkeypatch.setattr(devtrace, "Profiler", _Profiler)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cell_mod, "PROFILE_S", 0.3)
    cr.cuda = True
    cr.window()
    cr.close()
    run = cr.run
    n = len(run.profiled_calls)
    assert n >= 1 and len(tracing) > n
    assert tracing[:n] == [False] * n and all(tracing[n:])
    assert run.profile.busy_s == pytest.approx(run.profile.window_s / 2,
                                               rel=0.01)
    spans = run.spans["bsp.step"]
    assert sum(a["rounds"] for _, a in spans) == sum(
        r for r, _ in run.calls[n:])


def test_every_reader_reads_nothing_from_an_empty_run():
    """A reader that finds nothing to read returns None, never 0."""
    import os
    here = os.path.join(manifest.HERE, "metrics")
    for f in sorted(os.listdir(here)):
        if f.endswith(".py"):
            name = f[:-3]
            value = manifest.metric(name).read(_run(window_s=0.0))
            assert value is None or name == "setup_s", name
