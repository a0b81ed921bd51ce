"""End-to-end driver of the PyTorch/CUDA port: train a ~100M-parameter
encoder on generated ListOps (the paper's §5 task, real grammar) for a few
hundred steps through all three SPION phases, with checkpointing and
crash-restart enabled; the counterpart of examples/train_listops_spion.py,
with the same flags and defaults and --device.

    PYTHONPATH=src python examples/train_listops_spion_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_listops_spion_torch.py \\
        --steps 30 --seq-len 128 --batch 2 --dim 128 --layers 2 --device cpu

BERT-base geometry by default (d_model 768, 12 layers, heads of 64, SPION
block 32). The sparse phase runs the Hopper kernels on the card (on the
CPU, their plain versions). When --ckpt already holds a step, the run
resumes there, plan and all.
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import SpionConfig, get_config  # noqa: E402
from repro_torch.data.listops import (VOCAB_SIZE,  # noqa: E402
                                      make_listops_batch)
from repro_torch.launch.train import Trainer  # noqa: E402


def listops_iter(rng, batch, seq_len):
    while True:
        xs, _ = make_listops_batch(rng, batch, seq_len + 1, depth=5)
        yield {"tokens": xs[:, :-1], "labels": xs[:, 1:]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "spion_listops_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args()

    cfg = get_config("spion-lra").replace(
        num_layers=args.layers, d_model=args.dim, num_heads=args.dim // 64,
        num_kv_heads=args.dim // 64, d_ff=4 * args.dim, vocab_size=VOCAB_SIZE,
        head_dim=64,
        spion=SpionConfig(enabled=True, variant="cf", conv_filter_size=15,
                          block_size=32, alpha_quantile=0.9,
                          transition_tol=0.05, min_dense_epochs=1,
                          max_dense_epochs=4))
    print(f"params: {cfg.param_count()/1e6:.1f}M")
    rng = np.random.default_rng(0)
    tr = Trainer(cfg, seq_len=args.seq_len, batch=args.batch, lr=3e-4,
                 steps_per_epoch=25, ckpt_dir=args.ckpt,
                 data_iter=listops_iter(rng, args.batch, args.seq_len),
                 device=args.device)
    if tr.maybe_resume():
        print(f"resumed from step {tr.step} (phase {tr.spion_state.phase})")
    losses = tr.train(args.steps, ckpt_every=100, log_every=10)
    print(f"\nphase={tr.spion_state.phase} density={tr.spion_state.density}")
    print(f"loss {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f}")


if __name__ == "__main__":
    main()
