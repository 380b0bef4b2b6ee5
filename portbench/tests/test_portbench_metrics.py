"""The metric arithmetic: rates over the window, tails over all requests."""

import numpy as np

from portbench import flops, harness, spec


class Req:
    def __init__(self, plen):
        self.prompt = np.zeros(plen, np.int32)


def run_of(recs, t_open=10.0, t_close=20.0):
    m = {"hidden_size": 8, "intermediate_size": 16, "num_layers": 2,
         "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "vocab_size": 32}
    return harness.Run(model=m, t_open=t_open,
                       t_close=t_close, recs=recs,
                       rounds=[(9.0, 10.0), (10.0, 12.0), (12.0, 20.0),
                               (20.0, 21.0)],
                       setup_s=5.0, stats_delta={})


def rec(submit, emits, plen=4):
    r = harness.Rec(req=Req(plen), client=0, submit_t=submit)
    r.emits = emits
    return r


def test_rate_counts_every_token_in_the_window_over_its_length():
    recs = [rec(9.0, [(10.0, 8), (12.0, 8), (20.0, 8), (21.0, 8)]),
            rec(11.0, [(12.0, 8), (20.0, 3)])]
    r = run_of(recs)
    # emissions at 12 and 20 are inside (10, 20]; 10.0 and 21.0 are not
    assert r.emitted() == 8 + 8 + 8 + 3
    assert spec.reader("client.tok_s")(r) == 27 / 10.0


def test_tails_are_over_all_requests_and_gaps():
    recs = [rec(float(i), [(10.5 + i * 0.01, 8), (12.0 + i * 0.01, 8)])
            for i in range(100)]
    r = run_of(recs)
    ttft = r.ttft_s()
    assert len(ttft) == 100
    expect = np.percentile([10.5 + i * 0.01 - i for i in range(100)], 95)
    assert abs(spec.reader("client.ttft_p95_ms")(r) - 1e3 * expect) < 1e-9
    itl = r.itl_s()
    assert len(itl) == 100 and all(abs(x - 1.5 / 8) < 1e-9 for x in itl)
    assert abs(spec.reader("client.itl_p95_ms")(r) - 1e3 * 1.5 / 8) < 1e-9


def test_first_token_outside_the_window_gives_no_ttft():
    r = run_of([rec(1.0, [(9.5, 8), (11.0, 8)])])
    assert r.ttft_s() == []
    assert spec.reader("client.ttft_p95_ms")(r) is None
    assert r.itl_s() == [1.5 / 8]


def test_round_tail():
    r = run_of([])
    assert r.round_s() == [2.0, 8.0]
    assert spec.reader("sched.round_p95_ms")(r) == 1e3 * float(
        np.percentile([2.0, 8.0], 95))


def test_mfu_counts_prompt_and_tokens_in_the_window():
    r = run_of([rec(9.0, [(11.0, 2), (12.0, 1)], plen=4)])
    m = r.model
    # the prefill's token is fed, not emitted: emitted token k is decoded
    # over 4 + 1 + k keys
    f = flops.prefill_flops(m, 4) + flops.decode_flops(m, [5, 6, 7])
    assert r.window_flops() == f
    assert abs(spec.reader("model.step_mfu")(r) -
               100 * f / (10.0 * flops.PEAK_BF16_FLOPS)) < 1e-12


def test_flops_and_bytes_from_shapes():
    m = {"hidden_size": 8, "intermediate_size": 16, "num_layers": 2,
         "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "vocab_size": 32}
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    assert flops.matmul_flops_per_token(m) == 2 * 2 * per_layer
    assert flops.prefill_flops(m, 3) == (
        3 * flops.matmul_flops_per_token(m) + 2 * 8 * 32 +
        4 * 6 * 2 * 4 * 2)
    assert flops.b1_bytes(m, [10, 3]) == (13 * 2 * 1 * 4 * 2 +
                                          2 * 2 * 2 * 4 * 2)


def test_readers_without_data_return_nothing():
    r = run_of([])
    for name in ("card_ms_per_ktok", "prefill.ms_per_ktok",
                 "decode.enqueue_ms_per_step",
                 "tier.host_share", "kernel.b1_roofline",
                 "device.idle_share", "model.step_mfu"):
        assert spec.reader(name)(r) is None, name


def test_traffic_gives_every_seed_the_same_sizes():
    from portbench import loadgen
    mix = spec.traffic("chat")
    a = loadgen.Traffic(mix, 2 ** 31 + 11, 100)
    b = loadgen.Traffic(mix, 7, 100)
    assert a.queues == b.queues
    for k in (1, 5):        # the k-th requests of all clients: one set
        assert sorted(q[k].prompt_len for q in a.queues) == \
            sorted(q[2].prompt_len for q in a.queues)
        assert sorted(q[k].max_new_tokens for q in a.queues) == \
            sorted(q[2].max_new_tokens for q in a.queues)
    assert not (a.tokens(a.queues[0][0]) == b.tokens(b.queues[0][0])).all()
    c = loadgen.Traffic(mix, 2 ** 31 + 11, 100)
    assert (a.tokens(a.queues[0][0]) == c.tokens(c.queues[0][0])).all()
    assert max(s.prompt_len + s.max_new_tokens
               for q in a.queues for s in q) <= mix["max_len"]
    # a client that ran through its queue starts it again, the first whole
    q = a.queues[3]
    for _ in range(len(q)):
        a.next(3)
    again = a.next(3)
    assert again.prompt_len == q[0].prompt_len
    assert again.max_new_tokens >= q[0].max_new_tokens


class Ev:
    """A profiler event as ``torch.profiler`` gives it (``_KinetoEvent``)."""

    def __init__(self, name, a, b, dev, kind=None):
        self._n, self._a, self._b, self._dev = name, a, b, dev
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType." + self._dev


def trace_events(with_kind):
    k = (lambda x: x) if with_kind else (lambda x: None)
    return [
        Ev("bench.window", 0, 1000, "CPU", k("user_annotation")),
        Ev("bench.step", 0, 1000, "CPU", k("user_annotation")),
        Ev("bench.flush", 600, 900, "CPU", k("user_annotation")),
        Ev("bench.step", 0, 1000, "CUDA", k("gpu_user_annotation")),
        Ev("paged_decode_tc", 100, 300, "CUDA", k("kernel")),
        Ev("gemm", 250, 500, "CUDA", k("kernel")),
        Ev("Memcpy DtoH", 950, 1200, "CUDA", k("gpu_memcpy")),
        Ev("aten::mm", 100, 200, "CPU", k("cpu_op")),
    ]


def test_trace_summary_with_and_without_activity_type():
    from portbench import trace
    for with_kind in (True, False):
        s = trace.Summary(trace_events(with_kind))
        assert s.window_s == 1e-6
        # kernels 100-500 and a copy 950-1000 inside the window
        assert abs(s.busy_s - 450e-9) < 1e-15
        assert abs(s.kernel_s("paged_decode") - 200e-9) < 1e-15
        # idle 0-100 and 500-950: flush over 600-900, the step elsewhere
        gaps = dict(s.idle_gaps())
        assert abs(gaps["bench.flush"] - 300e-9) < 1e-15
        assert abs(gaps["bench.step"] - 250e-9) < 1e-15
        assert [n for n, _ in s.device_ops()] == ["gemm", "paged_decode_tc",
                                                 "Memcpy DtoH"]


def test_card_time_leaves_out_pageable_copies_and_counts_overlap_once():
    from portbench import trace
    ev = [
        Ev("gemm", 100, 300, "CUDA", "kernel"),
        Ev("paged_decode_tc", 250, 400, "CUDA", "kernel"),
        Ev("Memset (Device)", 500, 520, "CUDA", "gpu_memset"),
        Ev("Memcpy DtoD (Device -> Device)", 600, 650, "CUDA", "gpu_memcpy"),
        Ev("Memcpy HtoD (Pageable -> Device)", 700, 900, "CUDA",
           "gpu_memcpy"),
        Ev("Memcpy DtoH (Device -> Pageable)", 850, 1000, "CUDA",
           "gpu_memcpy"),
        Ev("cudaLaunchKernel", 90, 110, "CPU", "cuda_runtime"),
    ]
    assert trace.card_ns(ev) == (300 + 20 + 50, 300)


def test_card_ms_per_ktok_is_the_windows_card_time_over_its_tokens():
    from portbench import trace
    r = run_of([rec(9.0, [(12.0, 600), (20.0, 400), (21.0, 8)])])
    r.card = trace.CardTime()
    r.card.card_s = 0.25
    # 1000 tokens in the window, 0.25 s of the card: 250 ms a thousand
    assert abs(spec.reader("card_ms_per_ktok")(r) - 250.0) < 1e-9
