"""Run one cell of ``BENCHMARK.json`` on the CUDA card it is started on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): build the port's
kernels and native engine if they are not built, make the weights on the
card from the seed, build the ``Scheduler`` with its slot pool and managed
backing, serve one request of the mix's longest prompt, then submit every
client's first request and step until all are admitted.  The thread
that drives the Scheduler is then pinned to the fastest of the process's
CPUs (``harness.Placement``), and placed anew every ``PLACE_ROUNDS``
rounds.  The window runs for ``--seconds``, counting every token emitted
in it.  With ``--trace 0`` every round of the window is profiled for the
card's time (``trace.CardTime``; the profiler is first started in set-up,
over the request of the longest prompt).
With ``--trace 1`` the calls into each layer are wrapped and timed, prefills
synchronised, and a few rounds after the window are traced by the profiler.
Then the served tokens are compared with the plain reference.

The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "_portbench_cache"
# The native engine's fake device arena: the device tier the UVM engine
# faults pages into (as the port's own smoke run sets it for serving).
ARENA_MB = "1024"
TRACE_SECONDS = 2.0         # the traced stretch after the window
PLACE_ROUNDS = 8            # the driving thread is placed anew this often
SAMPLE_TOKENS = 512         # served tokens compared with the reference
SAMPLE_REQUESTS = 8
FORBIDDEN = ("jax", "jaxlib", "flax", "open_gpu_kernel_modules_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_env() -> None:
    """Caches at fixed paths inside the checkout; the engine's arena; no
    JAX through a library."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("TPUMEM_FAKE_HBM_MB", ARENA_MB)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_io() -> dict:
    """The process's peak resident memory and the bytes it had written to
    storage (``/proc/self/io``)."""
    import resource
    out = {"host_rss_max_gib": resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
        out["disk_write_gib"] = int(io["write_bytes"]) / 2 ** 30
    except (OSError, KeyError, ValueError):
        pass
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def build() -> None:
    """nvcc for the port's kernels and make for the native engine, at once.
    Both skip what is already built (the first run of a checkout builds)."""
    from open_gpu_kernel_modules_tpu_torch.ops import _build
    from open_gpu_kernel_modules_tpu_torch.runtime import native
    err = []

    def make():
        try:
            native.build_native()
        except Exception as e:        # reported after the join
            err.append(e)
    t = threading.Thread(target=make)
    t.start()
    try:
        _build.build_all()
    finally:
        t.join()
    if err:
        raise err[0]


def scheduler(mix: dict, m: dict, params, device):
    """The port's Scheduler for a traffic mix: its own TieredKVCache over a
    ManagedKVBacking, one sequence slot a client."""
    from open_gpu_kernel_modules_tpu_torch.models import llama
    from open_gpu_kernel_modules_tpu_torch.runtime import sched
    return sched.Scheduler(llama.LlamaConfig(**m), params,
                           max_seqs=mix["clients"], max_len=mix["max_len"],
                           page_size=mix["page_size"], oversub=mix["oversub"],
                           tokens_per_round=mix["tokens_per_round"],
                           device=device)


def serve(cell, seed: int, seconds: float, trace: bool, device,
          parts: dict):
    """Set up, warm up, run the window (and the traced stretch) of
    ``cell`` on ``device``, timing set-up's parts into ``parts``; returns
    (Run, params, model sizes, memory peak).  The Scheduler is closed
    before returning."""
    import torch

    from open_gpu_kernel_modules_tpu_torch.runtime import native, sched

    from . import harness, loadgen, spec, weights
    from . import trace as trace_mod

    mix = cell.traffic
    m = spec.model_fields(cell.config)
    # One thread drives the card; a CPU pool made after the driving thread
    # is pinned would share its one CPU.
    torch.set_num_threads(1)
    t = time.perf_counter()
    native.load()
    parts["engine_s"] = time.perf_counter() - t

    t = time.perf_counter()
    params = weights.make(m, seed, device)
    harness.sync(device)
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    s = scheduler(mix, m, params, device)
    parts["scheduler_s"] = time.perf_counter() - t
    probes = None
    try:
        traffic = loadgen.Traffic(mix, seed, m["vocab_size"])
        loop = harness.Loop(s, traffic)
        card = (trace_mod.CardTime()
                if not trace and device.type == "cuda" else None)
        t = time.perf_counter()
        # The longest prompt once, so the allocator holds its transients
        # before the window, under the profiler that the window's card
        # time uses, so that it is first started here; then every client's
        # first request.
        longest = traffic.longest_prompt()
        if card is not None:
            card.start()
        w = s.submit(traffic.tokens(loadgen.Spec(longest, 1, 1 << 40)),
                     mix["tokens_per_round"])
        while w.state is not sched.RequestState.FINISHED:
            s.step()
        if card is not None:
            card.stop(lambda: harness.sync(device))
            card = trace_mod.CardTime()
        loop.start()
        while not loop.admitted_all():
            loop.round()
        harness.sync(device)
        parts["warmup_s"] = time.perf_counter() - t
        stats0 = dict(s.stats)

        if trace:
            probes = harness.Probes(device=device,
                                    running=loop.running_lens,
                                    max_len=s.max_len)
            probes.install()
            probes.counting = True
            probes.sync_prefill = True
        gc.collect()
        gc.freeze()
        placement = harness.Placement()
        placement.place()
        setup_s = process_age_s()
        if card is not None:
            card.start()
        t_open = harness.clock()
        n = 0
        while True:
            t_end = loop.round()
            if t_end - t_open >= seconds:
                break
            n += 1
            if card is not None and n % card.ROUNDS == 0:
                card.lap(lambda: harness.sync(device))
            if n % PLACE_ROUNDS == 0:
                placement.place()
        if card is not None:
            card.stop(lambda: harness.sync(device))
        placement.release()
        parts["placed"] = placement.picks
        stats1 = dict(s.stats)
        run = harness.Run(
            model=m, t_open=t_open, t_close=t_end, recs=loop.recs,
            rounds=loop.rounds, setup_s=setup_s, stats_delta={k: stats1[k] - stats0.get(k, 0) for k in stats1},
            probes=probes, card=card)
        if trace:
            probes.counting = False
            probes.sync_prefill = False
            run.trace, run.b1_trace_bytes = traced_stretch(
                loop, probes, m, device)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        loop.open = False
    finally:
        if probes is not None:
            probes.remove()
        s.close()
    return run, params, m, peak


def traced_stretch(loop, probes, m, device):
    """Profile whole rounds for about TRACE_SECONDS after the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import flops, harness, trace

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    harness.sync(device)
    probes.b1_contexts.clear()
    with profile(activities=acts) as prof:
        probes.annotating = True
        probes.tracing = True
        with torch.profiler.record_function(trace.WINDOW):
            t0 = harness.clock()
            while harness.clock() - t0 < TRACE_SECONDS:
                with torch.profiler.record_function("bench.step"):
                    loop.round()
            harness.sync(device)
        probes.annotating = False
        probes.tracing = False
    summary = trace.summarize(prof)
    nbytes = sum(flops.b1_bytes(m, c) for c in probes.b1_contexts) * \
        m["num_layers"]
    return summary, nbytes


def result(cell, run, rows, ok, peak, trace, device, attempted, failed):
    import torch

    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        v = metric.read(run)
        if v is not None:
            metrics[metric.name] = {"value": v, "unit": metric.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    from . import check
    out["compared"] = check.line(rows)
    return out


def judge(cell, run, params, m, seed, device, control=False):
    """(numbers, rows, ok): the sample of the window's finished requests
    against the reference, with the configuration's limit."""
    from . import check, harness
    done = harness.served_in_window(run)
    picked = check.sample(done, seed, SAMPLE_TOKENS, SAMPLE_REQUESTS)
    numbers = check.compare(m, params, picked, device, control=control)
    limit = float(cell.config["limits"]["max_logit_gap"])
    rows = check.verdict(numbers, limit, len(done))
    return numbers, rows, check.ok(rows)


def attempted_failed(run, states):
    """Requests live in the window, and those of them the program ended
    in error or cancelled."""
    live = [r for r in run.recs
            if r.submit_t <= run.t_close and
            (r.end_t is None or r.end_t > run.t_open)]
    bad = [r for r in live if r.req.state in (states.ERROR,
                                             states.CANCELLED)]
    return len(live), len(bad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env()

    from . import spec
    cell = spec.cell(args.workload)
    t = time.perf_counter()
    try:
        import open_gpu_kernel_modules_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port open_gpu_kernel_modules_tpu_torch is "
              f"not importable here: {e}", file=sys.stderr)
        return 5
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    parts = {"import_s": process_age_s()}
    build()
    parts["build_s"] = time.perf_counter() - t
    card = power_limit()

    run, params, m, peak = serve(cell, args.seed, args.seconds,
                                 bool(args.trace), device, parts)
    from open_gpu_kernel_modules_tpu_torch.runtime.sched import RequestState
    attempted, failed = attempted_failed(run, RequestState)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, rows, ok = judge(cell, run, params, m, args.seed, device)
    check_s = time.perf_counter() - t

    from . import harness
    ttft, itl, rnd = run.ttft_s(), run.itl_s(), run.round_s()
    placed = parts.pop("placed", [])
    print("setup " + json.dumps({k: round(v, 3) for k, v in parts.items()}
                                | {"setup_s": round(run.setup_s, 3)}))
    print(f"card {card}; peaks: bf16 989 TFLOP/s, HBM 3.35 TB/s "
          "(H100 SXM data sheet, 700 W)")
    print("window " + json.dumps({
        "window_s": run.window_s, "rounds": len(rnd),
        "tokens": run.emitted(), "ttft_n": len(ttft),
        "ttft_median_ms": 1e3 * (harness.median(ttft) or 0),
        "itl_n": len(itl), "itl_median_ms": 1e3 * (harness.median(itl) or 0),
        "round_median_ms": 1e3 * (harness.median(rnd) or 0),
        "tok_s": run.emitted() / run.window_s,
        "card_s": run.card.card_s if run.card else None,
        "pageable_s": run.card.pageable_s if run.card else None,
        "card_profiles": run.card.profiles if run.card else None,
        "stats": run.stats_delta, "check_s": round(check_s, 3),
        "compared_requests": numbers["compared_requests"],
        "compared_tokens": numbers["compared_tokens"],
        "placed": [[c, round(best, 3), round(med, 3)]
                   for c, best, med in placed]} | host_io()))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not use: {bad}",
              file=sys.stderr)
        return 4
    out = result(cell, run, rows, ok, peak, bool(args.trace), device,
                 attempted, failed)
    from . import check
    print(check.text(rows), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
