"""A copy of the benchmark's cells at a size the CPU runs in seconds: the
same files and limits, with the model's widths, the corpus, the PTF
populations and the first query box cut, and the model in float32 so
that the port and the reference agree to rounding. The join cell, which
``BENCHMARK.json`` leaves out, comes in with the entries its file
names."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent

MODEL = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "n_routed_experts": 8,
         "num_experts_per_tok": 2, "n_shared_experts": 1,
         "moe_intermediate_size": 32, "vocab_size": 512,
         "num_hidden_layers": 2, "torch_dtype": "float32"}
PORT = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "vocab_size": 512, "moe.n_experts": 8, "moe.top_k": 2,
        "moe.n_shared": 1, "moe.d_expert": 32}
CORPUS = {"batch": 2, "seq": 64, "n_docs": 16, "n_files": 4,
          "host_budget_bytes": 1 << 16, "trace_steps": 2}


def make(root: Path) -> Path:
    """The tiny copy under ``root`` (``configs/``, ``workloads/``,
    ``metrics/`` and ``BENCHMARK.json``); returns ``root``."""
    for d in ("configs", "workloads"):
        (root / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", root / "metrics",
                    dirs_exist_ok=True)
    shutil.copy(CHECKOUT / "BENCHMARK.json", root / "BENCHMARK.json")
    conf = load("configs/deepseek-moe-16b.json")
    conf.update(MODEL)
    conf["program"]["replace"] = PORT
    save(root, "configs/deepseek-moe-16b.json", conf)
    cell = load("workloads/deepseek-moe-16b.train.json")
    cell["params"].update(CORPUS)
    save(root, "workloads/deepseek-moe-16b.train.json", cell)
    conf = load("configs/ptf.json")
    conf["layout"]["pops"] = [max(16, n // 200)
                              for n in conf["layout"]["pops"]]
    save(root, "configs/ptf.json", conf)
    cell = load("workloads/ptf.join.json")
    cell["params"]["boxes"][0] = [conf["domain_lo"], conf["domain_hi"]]
    cell["params"]["trace_queries"] = 2
    save(root, "workloads/ptf.join.json", cell)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += [e for e in cell["entries"][key]
                       if e not in bench[key]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def load(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def save(root: Path, rel: str, obj: dict) -> None:
    (root / rel).write_text(json.dumps(obj, indent=1))
