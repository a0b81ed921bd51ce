"""The step's model FLOPs (metrics/yardstick.step_flops: no recompute)
times the steps of the measured window, over its host seconds times the
H100's published dense bf16 peak, in %."""
from bench.metrics.yardstick import PEAK_FLOPS_BF16, step_flops


def read(run):
    flops = step_flops(run.model, run.traffic, run.tables,
                       run.loss_positions)
    return 100.0 * flops * run.steps / (run.window_s * PEAK_FLOPS_BF16)
