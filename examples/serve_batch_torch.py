"""Continuous-batching serving on the PyTorch/CUDA port: a reduced
qwen2-7b-family model answering more requests than it has cache slots —
fused prefill straight into slots, one batched decode per tick at per-slot
positions, admission mid-decode — then the same batch served SPARSELY from a
SPION-style plan (decode gathers only the pattern-listed KV-cache blocks),
then a SHARED SYSTEM PROMPT prefilled once and copy-on-write-mapped into
every later request. The counterpart of examples/serve_batch.py.

    PYTHONPATH=src python examples/serve_batch_torch.py [--device cpu]
        [--arch qwen2-7b | zamba2-1.2b | rwkv6-7b]

Without --device the engine runs on the first CUDA card (the sparse
prefill through the Hopper kernel); --device cpu runs the kernel's plain
version. The recurrent families (--arch zamba2-1.2b, rwkv6-7b) have no
fused prefill: every prompt is prefilled stepwise, one token at a time
from a fresh recurrent state; zamba2's plan has one table per application
of its shared attention block, rwkv6-7b serves densely and contiguously
only, and neither shares prefixes.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.launch.steps import causal_band_tables  # noqa: E402
from repro_torch.models.hybrid import n_attn_apps  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402


def make_requests(cfg, rng, n):
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=int(rng.integers(4, 12)))
                    .astype(np.int32),
                    max_new=12) for i in range(n)]


def serve(eng, reqs, label):
    t0 = time.time()
    eng.run(reqs)
    dt = time.time() - t0
    total = sum(len(r.out) for r in reqs)
    for r in reqs:
        print(f"  req {r.rid}: P={len(r.prompt)} -> {r.out}")
    print(f"  [{label}] {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s batched on {eng.device}; "
          f"{eng.prefill_fused} fused prefills, "
          f"{eng.prefill_stepwise_tokens} prompt tokens stepwise)\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--arch", default="qwen2-7b",
                    choices=["qwen2-7b", "zamba2-1.2b", "rwkv6-7b"],
                    help="the reduced model to serve")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced().replace(remat=False)
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)
    max_len, slots = 64, 4
    kw = dict(slots=slots, max_len=max_len, device=dev)

    print(f"{slots} slots, 6 requests (mixed lengths; slots are reused):")
    serve(ServeEngine(cfg, params, **kw), make_requests(cfg, rng, 6),
          "dense decode")

    if not bundle.supports_sparse_decode:
        print(f"{args.arch}: no KV cache, so no sparse decode and no prefix "
              f"sharing")
        return
    # a fully covering stand-in plan (a trained run would pass its
    # SparsityPlan: SpionController.attention_exec(state, phase="decode")),
    # one table per layer, or per application of zamba2's shared block
    tables = n_attn_apps(cfg) if cfg.family == "hybrid" else cfg.num_layers
    tabs = dict(causal_band_tables(tables, max_len // 8), block=8)
    print("same engine, sparse decode from a covering plan (logits match the\n"
          "dense path to kernel tolerance; greedy tokens can still diverge on\n"
          "random bf16 weights once one near-tie flips):")
    serve(ServeEngine(cfg, params, spion=tabs, **kw),
          make_requests(cfg, np.random.default_rng(0), 6), "sparse decode")

    if bundle.prefill_kv is None:
        return          # stepwise prefill: recurrent state needs the prefix
    # paged cache + COW prefix sharing: every request carries the same
    # 32-token system prompt; its pages are written ONCE, later requests
    # incref the same physical pages and their fused prefills write only
    # their private suffix's pages (an exact repeat reuses the cached first
    # token outright)
    print("shared system prompt across 5 requests (paged cache, COW):")
    sys_prompt = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    reqs = [Request(rid=i,
                    prompt=np.concatenate(
                        [sys_prompt,
                         rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(2, 6))).astype(np.int32)]),
                    max_new=12) for i in range(5)]
    eng = ServeEngine(cfg, params, page_size=8, **kw)  # 4 shared pages
    serve(eng, reqs, "paged + shared prefix")
    st = eng.prefix_stats
    print(f"  prefix hit rate {st['prefix_hit_rate']:.2f} "
          f"({st['hits']}/{st['lookups']} page lookups), "
          f"{st['prefill_fused']} fused prefill(s) for 5 requests, "
          f"{st['prefill_stepwise_tokens']} suffix tokens prefilled "
          f"stepwise, {st['prefix_tokens_reused']} prompt tokens reused, "
          f"{st['forks']} COW fork(s)")


if __name__ == "__main__":
    main()
