"""Readings that the limit of ``correct`` is set from (not part of a run).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 30

In one process and over one ``Scheduler`` (its set-up is long), for each
seed: the weights are drawn anew in place, the cell's clients are served
for a short window at the cell's own load, and the window's finished
requests are sampled and compared as a run compares them.  Each seed prints
the program's widest gap and the control's (the same reference computed
with float8 weights, in the program's place), and the verdict of the
harness's own check (``check.verdict``, ``check.ok``) on each: the program's
has to be correct and the control's not.  The limit goes between the
largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from . import run
    run.set_env()
    from . import check, harness, loadgen, spec, weights
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    device = torch.device("cuda", 0)
    run.build()
    mix = cell.traffic
    m = spec.model_fields(cell.config)
    params = weights.make(m, seeds[0], device)
    s = run.scheduler(mix, m, params, device)
    rows = []
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            weights.refill(params, m, seed)
            loop = harness.Loop(s, loadgen.Traffic(mix, seed,
                                                   m["vocab_size"]))
            loop.start()
            while not loop.admitted_all():
                loop.round()
            t_open = harness.clock()
            t_end = t_open
            while t_end - t_open < args.seconds:
                t_end = loop.round()
            loop.open = False
            for rec in list(loop.live.values()):
                s.cancel(rec.req.rid)
            r = harness.Run(model=m, t_open=t_open, t_close=t_end,
                            recs=loop.recs, rounds=loop.rounds, setup_s=0.0,
                            stats_delta={})
            done = harness.served_in_window(r)
            picked = check.sample(done, seed, run.SAMPLE_TOKENS,
                                  run.SAMPLE_REQUESTS)
            numbers = check.compare(m, params, picked, device, control=True)
            limit = float(cell.config["limits"]["max_logit_gap"])
            numbers["ok"] = check.ok(check.verdict(numbers, limit,
                                                   len(done)))
            numbers["control_ok"] = check.ok(check.verdict(
                check.as_control(numbers), limit, len(done)))
            numbers.update(seed=seed, finished=len(done),
                           tok_s=r.emitted() / r.window_s,
                           seconds=time.perf_counter() - t0)
            rows.append(numbers)
            print(json.dumps(numbers), flush=True)
    finally:
        s.close()
    served = [x["max_logit_gap"] for x in rows]
    sound = all(x["ok"] for x in rows) and not any(x["control_ok"]
                                                    for x in rows)
    control = [x["control_logit_gap"] for x in rows]
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "served_max": max(served), "control_min": min(control),
                      "ratio": min(control) / max(max(served), 1e-12),
                      "program_correct": all(x["ok"] for x in rows),
                      "control_correct": any(x["control_ok"] for x in rows)}))
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
