"""End-to-end training example (port of ``examples/train_lm.py``): train a
llama-style model with the port's runtime around the steps — the
deterministic pipeline, async checkpoints, restart safety, the straggler
monitor — on the card, or on the CPU with ``--device cpu``.

The default is a ~25M-parameter model (``--big`` selects ~110M), built
from llama3.2-1b's config with its widths and depth replaced and handed to
``repro_torch.launch.train.train`` as a config.  Checkpoints go to
``--ckpt-dir``, or to a temporary directory that is removed at the end.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          [--steps 150] [--big] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.models import model_struct, param_count, uniform_plan


def lm_config(big: bool):
    base = get_config("llama3.2-1b")
    if big:     # ~110M params
        return base.replace(
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
            vocab_size=32000, layer_plan=uniform_plan("global", 12),
        ).validate()
    return base.replace(  # ~25M params
        n_layers=6, d_model=384, n_heads=6, n_kv_heads=2, d_ff=1536,
        vocab_size=8192, layer_plan=uniform_plan("global", 6),
    ).validate()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    cfg = lm_config(args.big)
    n = param_count(model_struct(cfg))
    print(f"[example] model: {n/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model})")

    with tempfile.TemporaryDirectory() as tmp:
        res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                    ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50, lr=3e-3,
                    log_every=10, device=args.device)
    first, last = res["losses"][0], res["losses"][-1]
    print(f"[example] loss {first:.3f} -> {last:.3f} over {args.steps} steps")
    if not last < first:
        raise SystemExit("training must make progress")


if __name__ == "__main__":
    main()
