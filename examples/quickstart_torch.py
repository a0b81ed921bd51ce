"""Quickstart on the PyTorch/CUDA port: SPION end to end in about a minute;
the counterpart of examples/quickstart.py, with the same model, schedule
and data, and --device.

Builds the paper's encoder model at reduced scale, trains dense for a few
epochs, watches the Frobenius criterion trigger the transition, generates the
layer-wise conv-flood-fill patterns, and finishes training sparse.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the card (the default) the sparse phase runs the Hopper kernels; on the
CPU, the plain PyTorch gather.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import SpionConfig, get_config  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402


def quickstart_config():
    return get_config("spion-lra").replace(
        num_layers=2, d_ff=128, vocab_size=64,
        spion=SpionConfig(enabled=True, variant="cf", conv_filter_size=7,
                          block_size=16, alpha_quantile=0.85,
                          transition_tol=0.5, min_dense_epochs=1,
                          max_dense_epochs=4))


def main(argv=None, params=None):
    """Train 80 steps and return the Trainer; `params`: masters to start
    from (default: the Trainer's own, from its seed)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    cfg = quickstart_config()
    tr = Trainer(cfg, seq_len=128, batch=8, lr=1e-3, steps_per_epoch=10,
                 device=args.device, params=params)
    losses = tr.train(80, ckpt_every=0, log_every=10)
    print(f"\nfinal phase: {tr.spion_state.phase}")
    print(f"pattern density: {tr.spion_state.density:.3f} "
          f"(attention sparsity {1 - tr.spion_state.density:.1%})")
    print(f"loss: {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f}")
    assert tr.spion_state.phase == "sparse"
    return tr


if __name__ == "__main__":
    main()
