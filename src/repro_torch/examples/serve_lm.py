"""Batched serving example: prefill + greedy decode with ring KV caches
(windowed layers), recurrent states (RG-LRU / RWKV) — the same decode_step
``serve`` runs.  Port of the repo's ``examples/serve_lm.py`` over
``repro_torch.launch.serve.serve``, on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch rwkv6-3b]
      [--device cpu]
"""
import argparse

from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    help="any token decoder arch (smoke config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    res = serve(args.arch, smoke=True, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                device=args.device)
    print(f"[example] {args.arch}: generated {res['generated'].shape[1]} "
          f"tokens x {args.batch} seqs in {res['wall_s']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s)")
    print("[example] first rows:", res["generated"][:2, :8].tolist())


if __name__ == "__main__":
    main()
