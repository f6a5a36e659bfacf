"""Serving driver (port of ``repro.launch.serve``, LM mode): greedy decoding
of a batch of prompts through ``decode_step``, with the prompt teacher-forced
position by position.

Usage:
  python -m repro_torch.launch.serve --arch llama3.2-1b --batch 4 \\
      --prompt-len 16 --gen-len 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import (Transformer, cache_struct, decode_step,
                                init_params, model_struct)


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 16, gen_len: int = 32, max_len: int = 256,
          seed: int = 0, greedy: bool = True,
          params: Transformer | None = None, device=None) -> dict:
    """Greedy-decode ``batch`` prompts drawn from ``seed``.

    ``params`` defaults to random f32 weights drawn from ``seed`` on
    ``device``; pass the JAX package's weights (``models.convert``) to
    reproduce its tokens.  ``greedy`` is kept for the JAX signature: both
    decode greedily."""
    dev = resolve(device)
    cfg = get_config(arch, smoke=smoke)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = Transformer(cfg, init_params(model_struct(cfg), gen,
                                              device=dev))
    caches = init_params(cache_struct(cfg, batch, max_len), None, device=dev)

    rng = np.random.default_rng(seed)
    prompts = rng.integers(2, cfg.vocab_size,
                           size=(batch, prompt_len)).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(dev)
    out_tokens = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        for i in range(prompt_len + gen_len - 1):
            tok = tokens[:, i:i + 1] if i < prompt_len else out_tokens[-1]
            logits, caches = decode_step(params, cfg, caches, tok, i)
            if i >= prompt_len - 1:
                out_tokens.append(
                    torch.argmax(logits[:, -1:], dim=-1).to(torch.int32))
        gen = torch.cat(out_tokens, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
    steps = prompt_len + gen_len - 1
    return {"generated": gen, "steps": steps, "wall_s": dt,
            "tokens_per_s": batch * steps / dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "sim", "replay"], default="lm")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.mode != "lm":
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet (ROADMAP.md, Open items, "
            "item 5)")
    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen_len, device=args.device)
    print(f"[serve] generated {res['generated'].shape} tokens in "
          f"{res['wall_s']:.2f}s ({res['tokens_per_s']:.1f} tok/s)")
    print(res["generated"][:, :10])


if __name__ == "__main__":
    main()
