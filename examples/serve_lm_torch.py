"""Serving through the PyTorch/CUDA port: batched requests with the
cost-based KV prefix cache.

``examples/serve_lm.py`` through ``repro_torch``: runs two traffic mixes
through the ``ServingEngine`` — with and without a shared system prompt
— and shows the prefill tokens the paper-adapted page cache saves. The
model is qwen1.5-0.5b reduced to d_model 64 (4 heads of 16), its weights
drawn from a seeded ``torch.Generator`` on ``--device``. Every decode
step attends through the port's hand-written CUDA paged-attention
kernel (``paged_split_kernel``) at head dim 16; prompts this short
prefill on the naive attention path, as the reference's ``"auto"`` does
up to 2048 tokens (the flash kernel, ``flash_fwd_bf16_kernel``, takes
longer ones). ``--device cpu`` runs the kernels' plain PyTorch versions.
The closing line counts both kernels' launches.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402

MIXES = ("shared system prompt", "cold unrelated prompts")


def config():
    """The example's model: qwen1.5-0.5b at d_model 64, 2 periods, a
    vocabulary of 512."""
    return reduced(get("qwen1.5-0.5b"), d_model=64, n_periods=2, vocab=512)


def traffic(cfg):
    """The two traffic mixes (seed 1): six requests sharing a 32-token
    system prompt, and six of 40 unrelated tokens."""
    rng = np.random.default_rng(1)
    system = rng.integers(1, cfg.vocab_size, 32).tolist()
    shared = [Request(i, system + rng.integers(1, cfg.vocab_size, 8).tolist(),
                      max_new_tokens=4) for i in range(6)]
    cold = [Request(100 + i,
                    rng.integers(1, cfg.vocab_size, 40).tolist(),
                    max_new_tokens=4) for i in range(6)]
    return dict(zip(MIXES, (shared, cold)))


def serve(cfg, params, device):
    """Each mix through a fresh engine (3 slots, 8-token pages, a cache
    budget of 32 pages, cost policy); returns (mix -> EngineStats, mix ->
    finished requests)."""
    stats, done = {}, {}
    for name, reqs in traffic(cfg).items():
        engine = ServingEngine(cfg, params, slots=3, max_len=96,
                               page_size=8, cache_budget_pages=32,
                               policy="cost", device=device)
        done[name] = engine.run(list(reqs))
        stats[name] = engine.stats
    return stats, done


def main(argv=None):
    """Serve both mixes and print what the prefix cache saved; returns
    the EngineStats by mix."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    cfg = config()
    before = launches()
    params = init_params(cfg, seed=0, device=args.device)
    stats, done = serve(cfg, params, args.device)
    for name in MIXES:
        st = stats[name]
        print(f"{name}: served {len(done[name])}; prompt tokens "
              f"{st.prompt_tokens}, prefill saved by cache "
              f"{st.prefill_saved} ({st.prefill_saved/st.prompt_tokens:.0%})")
        print("  sample generation:", done[name][0].generated)
    ran = {k: v - before[k] for k, v in launches().items()}
    print(f"every decode step through the paged-attention kernel "
          f"(paged_split_kernel, CUDA), head dim {cfg.resolved_head_dim}, "
          f"on {args.device}: launches {ran}")
    return stats


def launches():
    """The attention kernels' launch counts so far."""
    return {**flash_attention.LAUNCHES, **paged_attention.LAUNCHES}


if __name__ == "__main__":
    main()
