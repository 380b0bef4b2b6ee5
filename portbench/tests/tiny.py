"""A tiny cell for the CPU tests: the Mistral topology at toy widths, a
closed loop of four clients, the port's plain paths on the CPU.

    python -m portbench.tests.tiny [--trace 1] [--fault <name>]

prints the run's result line as ``portbench.run`` does, then one line of
the modules it loaded whose top-level name the port must not load."""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("TPUMEM_FAKE_HBM_MB", "64")

TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 4096, "sliding_window": None,
        "hidden_act": "silu", "tie_word_embeddings": False,
        # set from tiny readings: served 0.02-0.04, control 0.39-0.44
        "limits": {"max_logit_gap": 0.15}}
MIX = {"clients": 4, "schedule_seed": 0, "requests_per_client": 8, "oversub": 1,
       "tokens_per_round": 8, "page_size": 16, "max_len": 256,
       "prompt": {"median": 48, "sigma": 0.5, "min": 16, "max": 96},
       "output": {"median": 24, "sigma": 0.5, "min": 8, "max": 56}}


def cell(mix=None):
    from portbench import spec
    bench = spec.benchmark()

    def mk(key):
        return [spec.Metric(m["name"], m["unit"], spec.reader(m["name"]))
                for m in bench[key]]
    return spec.Cell("tiny.chat", "tiny", "chat", 1, TINY, mix or MIX,
                     mk("end_to_end"), mk("per_layer"))


# --------------------------------------------------------------- faults
# Each breaks the timed path underneath the Scheduler, as a faulty program
# would; the run must then come out not correct.

def _stale_state():
    """A decode step that leaves the KV pool as it found it."""
    from open_gpu_kernel_modules_tpu_torch.models import serving
    orig = serving.decode_step

    def broken(cfg, params, tokens, cache):
        k, v = cache.k_pages.clone(), cache.v_pages.clone()
        logits, out = orig(cfg, params, tokens, cache)
        cache.k_pages.copy_(k)
        cache.v_pages.copy_(v)
        return logits, out
    serving.decode_step = broken


def _half_batch():
    """Decode only the first half of the batch; the rest get its rows."""
    import dataclasses
    import torch
    from open_gpu_kernel_modules_tpu_torch.models import serving
    orig = serving.decode_step

    def broken(cfg, params, tokens, cache):
        b = tokens.shape[0]
        h = max(1, b // 2)
        part = dataclasses.replace(cache, page_table=cache.page_table[:h],
                                   seq_lens=cache.seq_lens[:h])
        logits, part = orig(cfg, params, tokens[:h], part)
        idx = torch.arange(b, device=logits.device) % h
        out = dataclasses.replace(
            cache, seq_lens=torch.clamp(cache.seq_lens + 1,
                                        max=cache.max_len))
        return logits[idx], out
    serving.decode_step = broken


def _altered_token():
    """One token of every decode call altered where it is produced."""
    from open_gpu_kernel_modules_tpu_torch.models import serving
    orig = serving.decode_scan

    def broken(cfg, params, tokens, cache, n):
        tok, cache, toks = orig(cfg, params, tokens, cache, n)
        toks = toks.clone()
        toks[n // 2, 0] = (toks[n // 2, 0] + 1) % cfg.vocab_size
        return tok, cache, toks
    serving.decode_scan = broken


FAULTS = {"stale_state": _stale_state, "half_batch": _half_batch,
          "altered_token": _altered_token}


def run(trace=False, fault=None, seed=2 ** 31 + 5, seconds=3.0,
        control=False, mix=None):
    import torch
    from portbench import run as prun
    from open_gpu_kernel_modules_tpu_torch.runtime.sched import RequestState
    if fault:
        FAULTS[fault]()
    c = cell(mix)
    dev = torch.device("cpu")
    r, params, m, peak = prun.serve(c, seed, seconds, trace, dev, {})
    numbers, rows, ok = prun.judge(c, r, params, m, seed, dev,
                                   control=control)
    a, f = prun.attempted_failed(r, RequestState)
    return prun.result(c, r, rows, ok, peak, trace, dev, a, f), numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    out, _ = run(bool(args.trace), args.fault)
    print(json.dumps(out))
    from portbench import run as prun
    print(json.dumps({"forbidden": prun.forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
