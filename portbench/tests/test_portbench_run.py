"""The harness end to end on the CPU at a tiny size (the kernels' plain
paths): the result line, the check that decides ``correct`` and its
control, the faults it must catch, and what a run may load and write."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def _tiny(args, env=None, timeout=300):
    e = dict(os.environ)
    e.update(env or {})
    out = subprocess.run([sys.executable, "-m", "portbench.tests.tiny",
                          *args], cwd=ROOT, env=e, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def check_line(res, trace):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"
    assert isinstance(res["correct"], bool)
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    assert isinstance(res["failed"], int)
    for name, v in res["metrics"].items():
        assert isinstance(v["value"], float) and isinstance(v["unit"], str)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    for v in res["compared"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_line_and_modules(trace):
    res, loaded = _tiny(["--trace", str(trace)])
    check_line(res, trace)
    assert res["correct"] is True
    names = set(res["metrics"])
    if trace:
        assert {"client.tok_s", "client.ttft_p95_ms", "client.itl_p95_ms",
                "sched.round_p95_ms", "decode.enqueue_ms_per_step",
                "prefill.ms_per_ktok", "tier.host_share"} <= names
    else:
        # the card's time needs a card: on the CPU its reader finds nothing
        assert names == {"setup_s"}
    # whole top-level names: the port's name begins with the JAX package's
    assert loaded["forbidden"] == []


@pytest.mark.parametrize("fault", sorted(tiny.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    res, _ = _tiny(["--fault", fault])
    assert res["correct"] is False, res["compared"]


def test_control_in_the_programs_place_fails_the_limit():
    """float8 weights in the reference, the program's place taken: its
    widest gap is over the limit on every seed, the program's under."""
    from portbench import check
    limit = tiny.TINY["limits"]["max_logit_gap"]
    for seed in (3, 2 ** 31 + 9, 2 ** 32 + 1):
        res, numbers = tiny.run(seed=seed, seconds=2.0, control=True)
        assert numbers["max_logit_gap"] < limit / 3, numbers
        assert numbers["control_logit_gap"] > limit, numbers
        # the harness's own verdict: the program correct, the control not
        finished = res["compared"]["finished_in_window"]["value"]
        assert res["correct"] is True
        assert check.ok(check.verdict(numbers, limit, finished))
        rows = check.verdict(check.as_control(numbers), limit, finished)
        assert check.ok(rows) is False, rows


def test_without_a_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the full cell would run")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mistral-nemo-12b.chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "needs 1 CUDA card" in out.stderr


def test_only_benchmark_files_no_result(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone: the cell is
    found, the port is not, and no result is printed."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mistral-nemo-12b.chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "open_gpu_kernel_modules_tpu_torch is not importable" in \
        out.stderr, out.stderr[-2000:]


def test_writes_stay_in_the_checkout_and_the_given_dirs(tmp_path):
    """With HOME, XDG_CACHE_HOME and TMPDIR of its own, a run leaves
    nothing in /dev/shm or at a fixed /tmp path."""
    dirs = {k: tmp_path / k for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR")}
    for d in dirs.values():
        d.mkdir()
    shm0 = set(os.listdir("/dev/shm"))
    tmp0 = set(os.listdir("/tmp"))
    res, _ = _tiny(["--trace", "1"], {k: str(v) for k, v in dirs.items()})
    assert res["correct"] is True
    assert set(os.listdir("/dev/shm")) <= shm0
    new_tmp = {n for n in set(os.listdir("/tmp")) - tmp0
               if "portbench" in n or "tpurm" in n or "tpumem" in n}
    assert new_tmp == set()


@pytest.mark.cuda
def test_tiny_cell_on_the_card_and_its_control():
    """The tiny cell through the card's kernels (B1 in every decode layer):
    correct, and the float8 control over the limit."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import check
    from portbench import run as prun
    from open_gpu_kernel_modules_tpu_torch.runtime.sched import RequestState
    prun.build()
    c = tiny.cell()
    dev = torch.device("cuda", 0)
    r, params, m, peak = prun.serve(c, 2 ** 31 + 21, 3.0, True, dev, {})
    numbers, rows, ok = prun.judge(c, r, params, m, 2 ** 31 + 21, dev,
                                   control=True)
    assert ok, rows
    limit = c.config["limits"]["max_logit_gap"]
    assert numbers["control_logit_gap"] > limit
    finished = rows[0][1]
    control_rows = check.verdict(check.as_control(numbers), limit, finished)
    assert check.ok(control_rows) is False, control_rows
    assert r.trace.busy_s > 0 and peak > 0
    a, f = prun.attempted_failed(r, RequestState)
    assert a > 0 and f == 0
