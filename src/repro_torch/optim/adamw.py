"""AdamW over a ParamTree, with the JAX package's hyper-parameters and
arithmetic: b1 .9, b2 .95, eps 1e-8, decoupled weight decay .1 on tensors
with ndim >= 2 only (not on norms and biases).

Optimizer state mirrors the parameters by name (the ParamTree's dotted tree
paths): {"mu": {name: fp32}, "nu": {name: fp32}, "count": int32}. The
parameters are the fp32 masters; callers cast to cfg.dtype for the forward.
Where the JAX package returns new arrays, the port updates the parameters
in place and replaces the state's moment tensors.
"""
from __future__ import annotations

import torch


def adamw_init(params):
    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in params.named_parameters()}
    first = next(params.parameters())
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step: `grads` maps each parameter name to its gradient;
    `lr` is a float or a 0-d fp32 tensor. Returns (params, state)."""
    count = state["count"] + 1
    cf = count.float()
    c1 = 1.0 - b1 ** cf
    c2 = 1.0 - b2 ** cf
    for name, p in params.named_parameters():
        g = grads[name].float()
        mu = b1 * state["mu"][name] + (1 - b1) * g
        nu = b2 * state["nu"][name] + (1 - b2) * g * g
        step = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        decay = weight_decay if p.ndim >= 2 else 0.0  # no decay on norms/bias
        pf = p.float()
        p.copy_((pf - lr * (step + decay * pf)).to(p.dtype))
        state["mu"][name] = mu
        state["nu"][name] = nu
    state["count"] = count
    return params, state
