"""The port's serving and tier spans and counters, on the CPU.

A tiny ``Scheduler`` over a ``ManagedKVBacking`` runs with the native trace
armed.  Every application span that ``models/serving.py`` and
``runtime/sched.py`` emit is read back from the export: present, nested as
the layers call each other, with the byte counts the shapes give, and the
spans of an admission under the request's flow id.  The ``tputier_*``
counters sum the spans' bytes, and count while tracing is disarmed, when
no span is recorded.  The export's clock anchors set a native span around
a ``torch.profiler`` annotation onto the profiler's timeline.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from open_gpu_kernel_modules_tpu_torch import utils
from open_gpu_kernel_modules_tpu_torch.models import llama
from open_gpu_kernel_modules_tpu_torch.runtime import sched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAGE = 16
TPR = 4
PROMPTS = (20, 35, 50)
NEW = 12
COUNTERS = ("tputier_read_bytes", "tputier_read_ns", "tputier_flush_bytes",
            "tputier_flush_ns")

#: Each span, with the span it runs inside.
NESTED = {
    "serve.prefill": "serve.prefill_group",
    "serve.decode_step": "serve.decode_scan",
    "tier.fault_pass": "tier.read_pages",
    "tier.gather": "tier.read_pages",
    "tier.upload": "tier.activate",
    "tier.download": "tier.flush",
    "tier.writeback": "tier.flush",
    "sched.readback": "sched.round",
    "serve.decode_scan": "sched.round",
    "serve.prefill_group": "sched.admit",
}
SPANS = set(NESTED) | set(NESTED.values()) | {"tier.sync_from",
                                              "tier.release"}


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=256, max_seq_len=256),
        dtype=torch.float32, num_kv_heads=4)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return cfg, params


def _serve(model, armed):
    """Serve the prompts to their end; (the export's complete events, the
    counters' deltas, the records the rings took)."""
    cfg, params = model
    # four sequence slots: the managed backing a whole number of 64 KiB
    s = sched.Scheduler(cfg, params, max_seqs=4, max_len=128,
                        page_size=PAGE, oversub=1, tokens_per_round=TPR,
                        device="cpu")
    rng = np.random.default_rng(0)
    utils.trace_stop()
    utils.trace_reset()
    c0 = utils.counters(COUNTERS)
    try:
        if armed:
            utils.trace_start()
        reqs = [s.submit(rng.integers(0, 256, n).astype(np.int32), NEW)
                for n in PROMPTS]
        while any(r.state is not sched.RequestState.FINISHED for r in reqs):
            s.step()
        utils.trace_stop()
        c1 = utils.counters(COUNTERS)
        records = utils.trace_stats()["recorded"]
        events = [e for e in utils.trace_export()["traceEvents"]
                  if e["ph"] == "X"]
    finally:
        utils.trace_stop()
        utils.trace_reset()
        utils.flow_reset()
        s.close()
    return events, {k: c1[k] - c0[k] for k in COUNTERS}, records


@pytest.fixture(scope="module")
def served(model):
    return _serve(model, armed=True)


def _by_name(events):
    out = {}
    for e in events:
        out.setdefault(e["name"], []).append(e)
    return out


def _inside(inner, outer):
    # the export writes µs with three decimals
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"] and
            inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 2e-3)


def test_every_span_is_emitted(served):
    names = set(_by_name(served[0]))
    assert SPANS <= names, sorted(SPANS - names)


@pytest.mark.parametrize("inner", sorted(NESTED))
def test_spans_nest_as_the_layers_call(served, inner):
    spans = _by_name(served[0])
    outer = spans[NESTED[inner]]
    assert spans[inner]
    for e in spans[inner]:
        assert any(_inside(e, o) for o in outer), (inner, e)


def test_decode_steps_are_the_rounds_tokens(served):
    spans = _by_name(served[0])
    rounds = len(spans["serve.decode_scan"])
    assert rounds == len(spans["sched.readback"])
    assert len(spans["serve.decode_step"]) == rounds * TPR
    for e in spans["serve.decode_step"]:
        # a power-of-two batch: the running streams, row 0 repeated
        assert int(e["args"]["obj"], 16) in (1, 2, 4)


def test_bytes_follow_the_shapes(served, model):
    cfg, _ = model
    page = PAGE * cfg.num_kv_heads * cfg.head_dim * 4      # float32
    record = 2 * cfg.num_layers * page                      # K and V
    spans = _by_name(served[0])
    for name in ("tier.read_pages", "tier.fault_pass", "tier.gather",
                 "tier.upload", "tier.activate", "tier.flush",
                 "tier.download", "tier.writeback"):
        for e in spans[name]:
            pages = int(e["args"]["obj"], 16)
            assert e["args"]["bytes"] == pages * record, (name, e)
    assert sum(int(e["args"]["obj"], 16) for e in spans["tier.flush"]) > 0
    token = record // PAGE
    assert sorted(e["args"]["bytes"] for e in
                  spans["serve.prefill_group"]) == \
        sorted(n * token for n in PROMPTS)
    for name in ("serve.prefill", "serve.decode_scan", "tier.sync_from",
                 "tier.release", "sched.readback"):
        assert all(e["args"]["bytes"] == 0 for e in spans[name]), name


def test_counters_sum_the_spans(served):
    events, delta, _ = served
    spans = _by_name(events)

    def total(name, key):
        return sum(e["args"]["bytes"] if key == "bytes" else
                   round(e["dur"] * 1000) for e in spans[name])
    assert delta["tputier_read_bytes"] == total("tier.read_pages", "bytes")
    assert delta["tputier_flush_bytes"] == total("tier.flush", "bytes")
    assert delta["tputier_read_bytes"] > 0
    # the read counter times the whole call; the flush counter its
    # write-back, the readback and the page writes
    assert delta["tputier_read_ns"] >= total("tier.read_pages", "dur")
    assert total("tier.download", "dur") + total("tier.writeback", "dur") \
        <= delta["tputier_flush_ns"] <= total("tier.flush", "dur")


def test_an_admissions_spans_carry_its_flow(served):
    spans = _by_name(served[0])
    admits = [e for e in spans["sched.admit"] if "flow" in e["args"]]
    assert len(admits) == len(PROMPTS)
    for name in ("serve.prefill_group", "serve.prefill", "tier.flush"):
        for e in spans[name]:
            owner = [a for a in admits if _inside(e, a)]
            assert len(owner) == 1, (name, e)
            assert e["args"]["flow"] == owner[0]["args"]["flow"]
    assert len({a["args"]["flow"] for a in admits}) == len(PROMPTS)


def test_disarmed_records_nothing_and_counters_count(model, served):
    events, delta, records = _serve(model, armed=False)
    assert records == 0 and events == []
    assert delta["tputier_read_bytes"] == served[1]["tputier_read_bytes"]
    assert delta["tputier_flush_bytes"] == served[1]["tputier_flush_bytes"]
    assert delta["tputier_read_ns"] > 0 and delta["tputier_flush_ns"] > 0


def test_a_native_span_holds_a_profiler_annotation_once_mapped():
    """Within 200 µs on this host's clocks, with the export's anchors."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import program

    utils.trace_stop()
    utils.trace_reset()
    errors = []
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            utils.trace_start()
            for i in range(5):
                with utils.span(f"hold.{i}"):
                    with torch.profiler.record_function(f"held.{i}"):
                        torch.ones(64).sum()
            utils.trace_stop()
        doc = utils.trace_export()
    finally:
        utils.trace_reset()
    anchors = doc[utils.CLOCK_ANCHORS]
    assert anchors["armed"][0] <= anchors["exported"][0]
    clock = program.ClockMap(anchors["armed"], anchors["exported"])
    native = {n: (clock(a), clock(b))
              for _, a, b, n in program.native_spans(doc)}
    held = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("held.")}
    assert len(held) == 5
    for i in range(5):
        (na, nb), (pa, pb) = native[f"hold.{i}"], held[f"held.{i}"]
        errors.append(max(0, na - pa, pb - nb))
    assert max(errors) <= 200_000, errors


def _python(code, env=None):
    e = dict(os.environ)
    e.update(env or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e,
                          capture_output=True, text=True, timeout=120)


def test_a_span_before_the_engine_loads_nothing():
    out = _python(
        "from open_gpu_kernel_modules_tpu_torch import utils\n"
        "from open_gpu_kernel_modules_tpu_torch.runtime import native\n"
        "with utils.span('serve.prefill'):\n"
        "    pass\n"
        "print(native.loaded())\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


def test_export_holds_every_record_past_16_mib():
    """Rings holding more than the export's least buffer export whole."""
    n = 80000
    out = _python(
        "import json\n"
        "from open_gpu_kernel_modules_tpu_torch import utils\n"
        "utils.trace_reset(); utils.trace_start()\n"
        "utils.flow_set(utils.flow_mint(3, 7))\n"
        f"for i in range({n}):\n"
        "    with utils.span('x' * 23, obj=2 ** 63, nbytes=2 ** 63):\n"
        "        pass\n"
        "utils.trace_stop()\n"
        "text = utils.trace_export_json()\n"
        "doc = json.loads(text)\n"
        "meta = doc['traceEvents'][-1]['args']\n"
        "print(json.dumps([len(text), len(doc['traceEvents']), meta]))\n",
        {"TPUMEM_TRACE_RING": str(1 << 17)})
    assert out.returncode == 0, out.stderr[-2000:]
    size, events, meta = json.loads(out.stdout.strip().splitlines()[-1])
    assert size > utils.TRACE_EXPORT_BYTES
    # each span and its flow event, then the export's own event
    assert events == 2 * n + 1
    assert meta["exportDropped"] == 0 and meta["ringDropped"] == 0
