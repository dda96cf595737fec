"""A copy of the latent-attention training cell at a size the CPU runs in
seconds: the cell's file and limits, the model's widths, its experts and
the corpus cut, and the model in float32 so that the port and the
reference agree to rounding (the tiny heads are 32 + 16 wide against 32
for values, so attention takes its naive path at these lengths)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
CELL = "moonlight-16b-a3b.train"
CONFIG = "moonlight-16b-a3b"

MODEL = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "kv_lora_rank": 32,
         "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
         "v_head_dim": 32, "intermediate_size": 128,
         "moe_intermediate_size": 32, "n_routed_experts": 4,
         "router_experts": 16, "n_shared_experts": 1, "vocab_size": 512,
         "num_hidden_layers": 3, "torch_dtype": "float32"}
PORT = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "d_ff": 128, "vocab_size": 512, "head_dim": 48,
        "mla.kv_rank": 32, "mla.nope_dim": 32, "mla.rope_dim": 16,
        "mla.v_dim": 32, "moe.n_experts": 16, "moe.n_held": 4,
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
    conf = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    conf.update(MODEL)
    conf["program"]["replace"] = PORT
    (root / "configs" / f"{CONFIG}.json").write_text(json.dumps(conf))
    cell = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    cell["params"].update(CORPUS)
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    return root
