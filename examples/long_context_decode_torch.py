"""Long-context decode with a state-space model on the PyTorch/CUDA port:
rwkv6-family decode cost is O(1) per token regardless of context length;
the counterpart of examples/long_context_decode.py, with --device and
--full. Decodes at several "virtual context lengths" and shows the
constant per-token cost and the fixed-size recurrent state.

    PYTHONPATH=src python examples/long_context_decode_torch.py [--device cpu]
    PYTHONPATH=src python examples/long_context_decode_torch.py --full

Reduced rwkv6-7b by default; --full builds it at its published width and
depth (32 layers, d_model 4096: 14 GB of bf16 parameters). A token's time
is host time to a torch.cuda.synchronize() on the card.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

POSITIONS = (1_000, 100_000, 524_288)
TOKENS = 20          # decoded at each virtual position


def decode_config(full=False):
    cfg = get_config("rwkv6-7b")
    return (cfg if full else cfg.reduced()).replace(remat=False)


def state_bytes(cache):
    return sum(v.numel() * v.element_size() for v in cache.values())


@torch.no_grad()
def decode_positions(bundle, params, cache, tok):
    """One warm-up step at position 0, then TOKENS decode steps from each
    of POSITIONS (the cache updated in place). Returns ({position: ms a
    token}, the last logits)."""
    sync = torch.cuda.synchronize if tok.is_cuda else (lambda: None)
    logits, cache = bundle.decode_step(params, cache, tok, 0)
    ms = {}
    for pos in POSITIONS:
        sync()
        t0 = time.perf_counter()
        for i in range(TOKENS):
            logits, cache = bundle.decode_step(params, cache, tok, pos + i)
        sync()
        ms[pos] = (time.perf_counter() - t0) / TOKENS * 1e3
    return ms, logits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="rwkv6-7b at its published width and depth")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = decode_config(args.full)
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         device=device)
    B = 1
    cache = bundle.init_cache(B, max_len=1, device=device)  # size free of L
    nbytes = state_bytes(cache)
    print(f"recurrent state: {nbytes/1e3:.1f} KB "
          f"(vs a 512k-token KV cache of a same-size transformer: "
          f"{cfg.num_layers*524288*cfg.num_kv_heads*16*2*2/1e9:.1f} GB)")
    tok = torch.zeros((B, 1), dtype=torch.long, device=device)
    ms, _ = decode_positions(bundle, params, cache, tok)
    for pos, dt in ms.items():
        print(f"context {pos:>8,}: {dt:6.2f} ms/token  (flat = O(1)/token)")
    return nbytes, ms


if __name__ == "__main__":
    main()
