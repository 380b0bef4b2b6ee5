"""The program stretch's arithmetic (``program.Program``) on synthetic
profiler events and a synthetic export, the cost of arming's arithmetic,
the program stretch of a tiny Scheduler on the CPU, and the readers of the
tier's counter rates."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import program, spec

ROOT = Path(__file__).resolve().parents[2]

BASE = 1_700_000_000_000_000_000        # the profiler's Unix-epoch ns
OFF = BASE - 5_000_000_000              # CLOCK_REALTIME - CLOCK_MONOTONIC
DRIVING, WORKER = 11, 12
US = 1000


class Ev:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, a, b, device=False):
        self._n, self._a, self._d, self._dev = name, a, b - a, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def activity_type(self):
        return "kernel" if self._dev else "cpu_op"


def at(us):
    """Profiler ns at ``us`` µs into the stretch."""
    return BASE + us * US


def span(name, a_us, b_us, tid=DRIVING, off=OFF):
    """An export event at profiler µs a..b, written on CLOCK_MONOTONIC."""
    return {"name": name, "ph": "X", "tid": tid, "pid": 1,
            "ts": (at(a_us) - off) / 1e3, "dur": (b_us - a_us),
            "args": {"obj": "0x0", "bytes": 0}}


#: The export's clock anchors: CLOCK_REALTIME is OFF ahead, no drift.
ANCHORS = {"armed": [1000, 1000 + OFF],
           "exported": [9_000_000, 9_000_000 + OFF]}


def doc_of(events, export_dropped=0):
    return {"traceEvents": events + [{
        "name": "tpurm.export", "ph": "i", "tid": 0, "pid": 1, "ts": 0,
        "args": {"recorded": len(events), "ringDropped": 0,
                 "exportDropped": export_dropped}}]}


def stretch():
    """The stretch span over 0..1000 µs, the device's kernels alone in the
    profile: two decode steps (idle 100 + 100 µs), a read of pages whose
    fault pass (idle 200 µs) a worker's op covers half of, and 50 µs of
    idle after the round, under no span."""
    prof = [Ev("k", at(a), at(b), device=True) for a, b in
            ((100, 200), (300, 400), (600, 900), (950, 1000))]
    native = [span(program.STRETCH_SPAN, 0, 1000),
              span("sched.round", 0, 900),
              span("serve.decode_scan", 0, 400),
              span("serve.decode_step", 0, 200),
              span("serve.decode_step", 200, 400),
              span("tier.read_pages", 400, 600),
              span("tier.fault_pass", 400, 600),
              span("memring.op", 500, 700, tid=WORKER)]
    return prof, native


def reading(native=None, prof=None):
    p, nat = stretch()
    return program.Program(prof or p, doc_of(native or nat), DRIVING,
                         {"recorded": 8, "dropped": 0}, ANCHORS)


def test_idle_goes_to_the_innermost_program_span():
    p = reading()
    gaps = dict(p.idle_gaps())
    # idle: 0-100, 200-300 (steps), 400-600 (fault pass), 900-950
    assert gaps == pytest.approx({"serve.decode_step": 200e-6,
                                  "tier.fault_pass": 200e-6,
                                  "host.other": 50e-6})
    assert sum(gaps.values()) == pytest.approx(p.facts["idle_s"])
    assert p.facts["window_s"] == pytest.approx(1e-3)
    assert p.facts["program_idle_share"] == pytest.approx(100 * 400 / 450)
    assert p.decode_steps == 2
    assert p.idle_ms_per_step == pytest.approx(0.1)


def test_fault_worker_share_is_the_overlap_with_other_threads_ops():
    p = reading()
    assert p.fault_worker_share == pytest.approx(50.0)
    prof, nat = stretch()
    # an op on the driving thread itself is no worker's
    nat[-1]["tid"] = DRIVING
    assert reading(nat).fault_worker_share == 0.0
    assert reading([n for n in nat if n["name"] != "tier.fault_pass"]
                   ).fault_worker_share is None


def test_the_mapping_check_and_the_facts():
    p = reading()
    assert p.facts["containment_err_us"] == 0
    assert p.facts["containment_margins_us"] == [100.0, 0.0]
    assert p.facts["export_dropped"] == 0 and p.facts["dropped"] == 0
    assert p.facts["clock_drift_us"] == 0
    # a device op that ends 3 µs after the stretch span closes
    prof, _ = stretch()
    prof.append(Ev("k", at(990), at(1003), device=True))
    assert reading(prof=prof).facts["containment_err_us"] == \
        pytest.approx(3.0)
    # an export without the stretch span maps nothing
    _, nat = stretch()
    with pytest.raises(RuntimeError):
        reading(nat[1:])


def test_clock_map_interpolates_between_the_anchors():
    c = program.ClockMap((0, 100), (1000, 1100 + 10))
    assert c(0) == 100 and c(1000) == 1110 and c(500) == 605
    assert c.drift_ns == 10


def test_innermost_sweep_nests_and_skips_empty_spans():
    segs = program.innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"),
                            (5, 5, "z")])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a")]


def test_cost_is_the_armed_round_over_the_disarmed_one():
    def rnd(armed, s, step_ms, admitted=0):
        return {"armed": armed, "s": s, "step_ms": step_ms,
                "admitted": admitted, "records": 100 if armed else 0}
    pairs = [{True: rnd(True, 1.1, 2.2), False: rnd(False, 1.0, 2.0)},
             {True: rnd(True, 1.0, 2.0, 1), False: rnd(False, 1.0, 2.0)},
             {True: rnd(True, 0.9, 2.0), False: rnd(False, 1.0, 2.0)}]
    c = program.cost(pairs)
    assert c["armed_over_disarmed_step_ms"]["median"] == pytest.approx(1.0)
    assert c["armed_over_disarmed_step_ms"]["n"] == 3
    assert c["armed_over_disarmed_round_s"]["median"] == pytest.approx(1.0)
    assert c["records_per_armed_round"] == 100
    q = program.quartiles([1.0, 2.0, 3.0, 4.0])
    assert (q["q1"], q["median"], q["q3"]) == (1.25, 2.5, 3.75)
    assert q["spread"] == pytest.approx(1.0)
    assert program.quartiles([1.0]) is None


STRETCH = """
import json, sys, torch
from portbench import harness, loadgen, program, run, spec, weights
from portbench.tests import tiny
run.set_env()
cpu = torch.device("cpu")
m = spec.model_fields(tiny.TINY)
s = run.scheduler(tiny.MIX, m, weights.make(m, 7, cpu), cpu)
try:
    loop = harness.Loop(s, loadgen.Traffic(tiny.MIX, 7, m["vocab_size"]))
    loop.start()
    while not loop.admitted_all():
        loop.round()
    p = program.stretch(loop, cpu, 0.5)
finally:
    s.close()
print(json.dumps({"facts": p.facts, "gaps": p.idle_gaps(),
                  "steps": p.decode_steps}))
"""


def test_program_stretch_of_a_tiny_scheduler_on_the_cpu():
    """On the CPU the profile holds no device op, so the whole stretch is
    idle, and the port's spans on the driving thread take all of it."""
    out = subprocess.run([sys.executable, "-c", STRETCH], cwd=ROOT,
                         env=dict(os.environ), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    facts, gaps = res["facts"], dict(res["gaps"])
    assert facts["dropped"] == 0 and facts["export_dropped"] == 0
    assert facts["containment_err_us"] is None
    assert facts["idle_s"] == pytest.approx(facts["window_s"])
    assert sum(gaps.values()) == pytest.approx(facts["idle_s"])
    assert facts["program_idle_share"] > 90
    assert res["steps"] > 0 and gaps["serve.decode_step"] > 0
    assert {"sched.round", "sched.readback"} & set(gaps)


def test_tier_rates_read_the_ports_counters(monkeypatch):
    from open_gpu_kernel_modules_tpu_torch import utils
    c = {"tputier_read_bytes": 3_000_000_000, "tputier_read_ns": 2_000_000_000,
         "tputier_flush_bytes": 400_000_000, "tputier_flush_ns": 1_000_000_000}
    monkeypatch.setattr(utils, "counter", lambda name: c.get(name, 0))
    assert spec.reader("tier.read_gbps")(None) == pytest.approx(1.5)
    assert spec.reader("tier.flush_gbps")(None) == pytest.approx(0.4)
    # a port without the counters reads nothing
    c = dict.fromkeys(c, 0)
    assert spec.reader("tier.read_gbps")(None) is None
    assert spec.reader("tier.flush_gbps")(None) is None


def test_per_layer_sources_are_the_contracts():
    for m in spec.benchmark()["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock"), m["name"]
