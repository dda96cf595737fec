"""Serving launcher: batched requests through the engine with the
paper's cost-based prefix cache, on a ``reduced`` config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 12 --policy cost [--device cpu]

The port of ``repro/launch/serve.py``, plus ``--device`` (default
``cuda``: the card; ``cpu`` runs the plain versions).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get, list_archs, reduced
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Request, ServingEngine


def synth_requests(n: int, vocab: int, seed: int = 0, sys_len: int = 48,
                   user_len: int = 16):
    """Multi-turn-style workload: a shared system prompt + per-user tail —
    the prefix-sharing pattern the cost-based page cache exploits."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, sys_len).tolist()
    reqs = []
    for i in range(n):
        user = rng.integers(1, vocab, user_len).tolist()
        reqs.append(Request(request_id=i, prompt=system + user,
                            max_new_tokens=8))
    return reqs


def main(argv=None):
    """Parse the CLI, serve the synthetic requests, print the summary and
    return the engine."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", choices=["cost", "lru"], default="cost")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced(get(args.arch))
    params = init_params(cfg, seed=args.seed, device=args.device)
    engine = ServingEngine(cfg, params, slots=args.slots,
                           policy=args.policy, device=args.device)
    reqs = synth_requests(args.requests, cfg.vocab_size, args.seed)
    done = engine.run(reqs)
    st = engine.stats
    print(f"served {len(done)} requests; prompt tokens {st.prompt_tokens}, "
          f"prefill executed {st.prefill_executed}, "
          f"saved by prefix cache {st.prefill_saved} "
          f"({st.prefill_saved / max(st.prompt_tokens,1):.0%})")
    return engine


if __name__ == "__main__":
    main()
