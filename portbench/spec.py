"""Find a cell's files by name: the workload in ``BENCHMARK.json``, its
configuration under ``configs/``, its traffic under ``traffic/`` and the
readers of its metrics under ``metrics/``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: Callable[[object], Optional[float]]


def reader(name: str) -> Callable[[object], Optional[float]]:
    """``read(run)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(workload: str, bench: Optional[dict] = None) -> Cell:
    """The cell named ``workload`` with its files and the metrics it
    reports: every end-to-end metric and per-layer metric whose
    ``workloads`` (when given) name it."""
    bench = bench if bench is not None else benchmark()
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]

    def metrics(key: str) -> List[Metric]:
        return [Metric(m["name"], m["unit"], reader(m["name"]))
                for m in bench[key] if _applies(m, workload)]
    return Cell(name=workload, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=config(w["config"]), traffic=traffic(w["traffic"]),
                end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))


def model_fields(cfg: dict) -> Dict[str, object]:
    """The port's ``LlamaConfig`` fields of a Mistral ``config.json``.
    Refuses what the port's decoder does not compute (a sliding window,
    another activation, tied embeddings)."""
    if cfg.get("sliding_window") not in (None, 0):
        raise ValueError("the port's decoder has no sliding window")
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's MLP is SwiGLU (silu)")
    if cfg.get("tie_word_embeddings"):
        raise ValueError("the port keeps lm_head apart from embed")
    heads = cfg["num_attention_heads"]
    return dict(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=heads,
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        rope_theta=float(cfg["rope_theta"]), rms_eps=float(cfg["rms_norm_eps"]),
        max_seq_len=cfg["max_position_embeddings"])
