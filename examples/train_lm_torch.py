"""End-to-end training through the PyTorch/CUDA port: a ~100M-parameter
llama3.2-style model with the raw-array cached data pipeline, parameters
placed on the host mesh, AdamW and async checkpoints.

``examples/train_lm.py`` through ``repro_torch``: calls
``repro_torch.launch.train.main`` with the reference example's flags
(d_model 512, 14 periods of the llama pattern, vocab 32000, batch 8 x
128 tokens, lr 3e-4, a checkpoint every 50 steps) plus ``--device``.
At 128 tokens attention takes the naive path, as the reference's
``"auto"`` does up to 2048 tokens: the port's hand-written CUDA
flash-attention kernels (``flash_fwd_bf16_kernel``,
``flash_bwd_dkdv_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``, head dim
128 here) take longer sequences, so the closing line, which counts
their launches, shows none at this length. ``--device cpu`` runs the
plain PyTorch versions.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    """Train, print the loss drop and return the launcher's result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import main as train_main
    before = dict(flash_attention.LAUNCHES)
    # ~100M params: d_model=512, 14 periods of the llama pattern, vocab 32k
    # (vocab dominates: 2 x 32000 x 512 = 33M; blocks ~ 55M).
    with tempfile.TemporaryDirectory(prefix="ckpt_") as ckpt:
        out = train_main([
            "--arch", args.arch,
            "--scale", "reduced",
            "--d-model", "512",
            "--periods", "14",
            "--steps", str(args.steps),
            "--batch", "8",
            "--seq", "128",
            "--vocab", "32000",
            "--lr", "3e-4",
            "--ckpt-dir", ckpt,
            "--ckpt-every", "50",
            "--log-every", "10",
            "--device", args.device,
        ])
    losses = out["losses"]
    n = min(10, len(losses))
    print(f"\nfirst-{n} mean loss {sum(losses[:n])/n:.3f} -> "
          f"last-{n} mean loss {sum(losses[-n:])/n:.3f}")
    assert losses[-1] < losses[0], "training should reduce the loss"
    ran = {k: v - before[k] for k, v in flash_attention.LAUNCHES.items()}
    print(f"flash-attention kernels (flash_fwd_bf16_kernel, "
          f"flash_bwd_*_wgmma_kernel, CUDA) at seq 128 on {args.device}: "
          f"launches {ran}")
    return out


if __name__ == "__main__":
    main()
