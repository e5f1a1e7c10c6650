"""A copy of the benchmark at tiny sizes for the CPU tests.

``tiny_root(path)`` writes ``BENCHMARK.json`` and the benchmark's files
under ``path``, with tiny configurations and mixes of every kind in
place of the cells' own, and returns ``path``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = {
    "source": "a tiny model with the Llama equations, for tests",
    "reduced": [], "compute_dtype": "bfloat16", "param_dtype": "float32",
    "hidden_act": "silu", "hidden_size": 128, "intermediate_size": 256,
    "num_attention_heads": 4, "num_hidden_layers": 8,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "vocab_size": 4096,
}

def _limits(mix: str) -> dict:
    """The limits of one of the cells' own mixes."""
    return json.loads((REPO / "portbench" / "traffic" / f"{mix}.json")
                      .read_text())["limits"]


# Tiny mixes of each kind, held to the limits of the cells' own mixes.
TINY_MIXES = {
    "tiny_prefill": {"kind": "prefill", "batch": 1,
                     "classes": [[64, 2], [128, 1]],
                     "check": {"requests": 3, "positions": 64, "rounds": 2},
                     "trace_seconds": 1, "limits": _limits("prefill_short")},
    "tiny_train": {"kind": "train", "batch": 2, "seq": 64, "lr": 1e-3,
                   "betas": [0.9, 0.999], "eps": 1e-8,
                   "weight_decay": 1e-4, "check": {"steps": 3},
                   "trace_seconds": 1, "limits": _limits("train")},
    "tiny_sync": {"kind": "grad_sync", "replicas": 4, "bucket_mb": 0.25,
                  "chunk_buckets": 2, "check": {"buckets": 3},
                  "trace_seconds": 1, "limits": _limits("grad_sync")},
}

# The tiny model has 2,230,400 params: 34.03 buckets of 0.25 MiB, in chunks
# of 2 buckets.
# Each tiny cell reports the metrics of the cell it stands for; the
# gradient sync has no cell yet, so tiny.sync reports set-up alone.
LIKE = {"tiny.prefill": "mistral7b.prefill_short",
        "tiny.train": "deepseek7b.train"}
CELLS = {"tiny.prefill": ("tiny_prefill", 1), "tiny.train": ("tiny_train", 1),
         "tiny.sync": ("tiny_sync", 4)}


def tiny_root(path: Path) -> Path:
    shutil.copytree(REPO / "portbench", path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (path / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(TINY_MODEL))
    for name, mix in TINY_MIXES.items():
        (path / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"] += [{"name": cell, "config": "tiny",
                            "traffic": traffic, "chips": chips, "why": "tests"}
                           for cell, (traffic, chips) in CELLS.items()]
    for spec in bench["end_to_end"] + bench["per_layer"]:
        for cell, like in LIKE.items():
            if like in spec.get("workloads", []):
                spec["workloads"].append(cell)
    (path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return path
