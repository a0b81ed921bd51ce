"""The transformer family (the encoder and the vlm decoder) in plain
PyTorch, for the check: forward, the token loss, its gradients, the
SPION capture, global-norm clipping, the cosine schedule and AdamW.

Precision "fp32": every product in float32 with TF32 off. Precision "fp8"
(the control): both operands of every product (projections, head,
attention scores and values) rounded to float8 e4m3 with a per-tensor scale
on the way in, the product accumulated in float32; the rounding passes the
gradient straight through.

The sparse attention is the paper's (Alg. 5, 6): the scores of the listed
blocks under the causal mask, each pruned position of the row counted as a
score of 0 in the softmax's denominator, the probabilities times the
listed V blocks.

Rows are processed in chunks of `chunk` sequences, each layer recomputed
in the backward, so that the float32 reference fits beside its optimizer
state at the cell's own sizes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def set_precision():
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(x):
    """x rounded to e4m3 under a per-tensor scale, gradient straight
    through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    y = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (y - x.detach())


class Model:
    """One configuration file's model section at one precision."""

    def __init__(self, model, spion, precision="fp32"):
        self.L, self.d = model["num_layers"], model["d_model"]
        self.H, self.KV = model["num_heads"], model["num_kv_heads"]
        self.hd = model.get("head_dim") or self.d // self.H
        self.G = self.H // self.KV
        self.causal = model.get("causal", True)
        self.eps = model.get("norm_eps", 1e-5)
        self.theta = model.get("rope_theta") or 0.0
        self.block = spion["block_size"]
        self.prec = precision

    # -- products ------------------------------------------------------------

    def q(self, x):
        return to_fp8(x) if self.prec == "fp8" else x

    def mm(self, x, w):
        return self.q(x) @ self.q(w)

    def ein(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))

    # -- pieces --------------------------------------------------------------

    def norm(self, P, name, x, layer=None):
        scale = P[f"{name}.scale"]
        bias = P.get(f"{name}.bias")
        if layer is not None:
            scale = scale[layer]
            bias = None if bias is None else bias[layer]
        if bias is not None:
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            return (x - mu) * torch.rsqrt(var + self.eps) * scale + bias
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * scale

    def rope(self, x, pos):
        half = self.hd // 2
        freqs = 1.0 / (self.theta ** (torch.arange(
            half, dtype=torch.float32, device=x.device) / half))
        ang = pos[:, None].float() * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def qkv(self, P, layer, x, pos):
        b, S, _ = x.shape
        q = self.mm(x, P["layers.attn.wq"][layer]).view(b, S, self.H, self.hd)
        k = self.mm(x, P["layers.attn.wk"][layer]).view(b, S, self.KV,
                                                        self.hd)
        v = self.mm(x, P["layers.attn.wv"][layer]).view(b, S, self.KV,
                                                        self.hd)
        if self.theta:
            q, k = self.rope(q, pos), self.rope(k, pos)
        return q, k, v

    def dense_attention(self, q, k, v):
        """q (b,S,H,hd), k/v (b,S,KV,hd) -> (b,S,H,hd)."""
        S = q.shape[1]
        k = k.repeat_interleave(self.G, dim=2)
        v = v.repeat_interleave(self.G, dim=2)
        s = self.ein("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.hd)
        if self.causal:
            pos = torch.arange(S, device=q.device)
            s = s.masked_fill(pos[None, :] > pos[:, None], -math.inf)
        p = torch.softmax(s, dim=-1)
        return self.ein("bhqk,bkhd->bqhd", p, v)

    def sparse_rows(self, q, k, v, col, nv, r0):
        """The Alg. 6 attention of the row blocks r0.. of q (b, n*blk, H, hd)
        over the listed blocks of k, v (b, S, KV, hd); col (n, K), nv (n,)."""
        b, Sq, H, hd = q.shape
        S, blk = k.shape[1], self.block
        n, K = col.shape
        dev = q.device
        colc = col.clamp(min=0).long()
        kb = k.view(b, S // blk, blk, self.KV, hd)[:, colc]  # b n K blk KV hd
        vb = v.view(b, S // blk, blk, self.KV, hd)[:, colc]
        qb = q.view(b, n, blk, self.KV, self.G, hd)
        s = self.ein("brpkgh,brcqkh->bkgrpcq", qb, kb) / math.sqrt(hd)
        ar = torch.arange(blk, device=dev)
        qpos = (torch.arange(n, device=dev)[:, None] + r0) * blk + ar  # n blk
        kpos = colc[:, :, None] * blk + ar                             # n K blk
        ok = (torch.arange(K, device=dev) < nv[:, None])[:, None, :, None]
        ok = ok.expand(n, blk, K, blk)
        if self.causal:
            ok = ok & (qpos[:, :, None, None] >= kpos[:, None, :, :])
        s = s.masked_fill(~ok, -math.inf)
        mx = s.detach().amax(dim=(-2, -1), keepdim=True).clamp(min=-1e30)
        ex = torch.exp(s - mx)
        stored = ok.sum(dim=(-2, -1)).float()[..., None, None]        # n blk
        total = (qpos + 1).float() if self.causal else \
            torch.full_like(qpos, S, dtype=torch.float32)
        pruned = (total[..., None, None] - stored).clamp(min=0)
        denom = ex.sum(dim=(-2, -1), keepdim=True) + pruned * torch.exp(-mx)
        p = ex / denom
        o = self.ein("bkgrpcq,brcqkh->brpkgh", p, vb)
        return o.reshape(b, n * blk, H, hd)

    def sparse_attention(self, q, k, v, tables, rows_per_chunk):
        col, nv = tables
        nrb = col.shape[0]
        out = []
        for r0 in range(0, nrb, rows_per_chunk):
            r1 = min(r0 + rows_per_chunk, nrb)
            qr = q[:, r0 * self.block:r1 * self.block]
            fn = lambda qr, k, v, r0=r0, r1=r1: self.sparse_rows(  # noqa: E731
                qr, k, v, col[r0:r1], nv[r0:r1], r0)
            out.append(checkpoint(fn, qr, k, v, use_reentrant=False)
                       if torch.is_grad_enabled() else fn(qr, k, v))
        return torch.cat(out, dim=1)

    def layer(self, P, layer, h, pos, tables, rows_per_chunk):
        x = self.norm(P, "layers.attn_norm", h, layer)
        q, k, v = self.qkv(P, layer, x, pos)
        if tables is None:
            ctx = self.dense_attention(q, k, v)
        else:
            ctx = self.sparse_attention(q, k, v, tables, rows_per_chunk)
        b, S = h.shape[:2]
        h = h + self.mm(ctx.reshape(b, S, self.H * self.hd),
                        P["layers.attn.wo"][layer])
        x = self.norm(P, "layers.mlp_norm", h, layer)
        up = self.mm(x, P["layers.mlp.w_in"][layer])
        if "layers.mlp.w_gate" in P:
            up = F.silu(self.mm(x, P["layers.mlp.w_gate"][layer])) * up
        else:
            up = F.relu(up)
        return h + self.mm(up, P["layers.mlp.w_out"][layer])

    def embed(self, P, batch):
        h = P["tok_embed.w"][batch["tokens"].long()]
        if "patch_embeds" in batch:
            h = torch.cat([batch["patch_embeds"].float(), h], dim=1)
        if "pos_embed.w" in P:
            h = h + P["pos_embed.w"][:h.shape[1]]
        return h

    def nll(self, P, batch, tables=None, rows_per_chunk=8):
        """The sum of the text's token nll over a chunk of rows (over the
        batch's `loss_mask` where it has one); `tables`
        None for dense attention, else per layer (col, nv) device
        tensors."""
        h = self.embed(P, batch)
        pos = torch.arange(h.shape[1], device=h.device)
        for layer in range(self.L):
            lt = None if tables is None else tables[layer]
            fn = lambda h, layer=layer, lt=lt: self.layer(  # noqa: E731
                P, layer, h, pos, lt, rows_per_chunk)
            h = checkpoint(fn, h, use_reentrant=False) \
                if torch.is_grad_enabled() else fn(h)
        n_text = batch["labels"].shape[1]
        h = self.norm(P, "final_norm", h[:, h.shape[1] - n_text:])
        head = P.get("lm_head.w", P["tok_embed.w"])
        logits = self.mm(h, head.T)
        gold = torch.gather(logits, -1, batch["labels"].long()[..., None])
        nll = torch.logsumexp(logits, dim=-1) - gold[..., 0]
        if "loss_mask" in batch:
            nll = nll * batch["loss_mask"].float()
        return nll.sum()

    @torch.no_grad()
    def capture(self, P, batch, filt_size, chunk):
        """(Ly, S/blk, S/blk) pooled maps of one batch: per layer the
        batch-and-head mean of the dense attention probabilities A, the
        diagonal convolution sum_f A(i+f, j+f) / F with zero padding, and
        the blk x blk block means (the paper's Eq. 3, 4)."""
        h = self.embed(P, batch)
        b, S, _ = h.shape
        pos = torch.arange(S, device=h.device)
        blk = self.block
        pooled = []
        for layer in range(self.L):
            x = self.norm(P, "layers.attn_norm", h, layer)
            q, k, _ = self.qkv(P, layer, x, pos)
            k = k.repeat_interleave(self.G, dim=2)
            a = torch.zeros((S, S), device=h.device)
            for i in range(b):
                for hh in range(self.H):
                    s = self.mm(q[i, :, hh], k[i, :, hh].T) / math.sqrt(self.hd)
                    if self.causal:
                        s = s.masked_fill(pos[None, :] > pos[:, None],
                                          -math.inf)
                    a += torch.softmax(s, dim=-1)
            a /= b * self.H
            conv = torch.zeros_like(a)
            for f in range(filt_size):
                conv[:S - f, :S - f] += a[f:, f:] / filt_size
            nb = S // blk
            pooled.append(conv.view(nb, blk, nb, blk).mean(dim=(1, 3)))
            h = torch.cat([self.layer(P, layer, h[i:i + chunk], pos, None, 0)
                           for i in range(0, b, chunk)])
        return torch.stack(pooled)


def cosine_lr(step, peak, total, warmup=200, floor=0.1):
    """The schedule's value at `step` (warmup, then cosine to floor*peak)."""
    if step < warmup:
        return peak * min((step + 1) / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


@torch.no_grad()
def clip_and_adamw(P, grads, opt, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """Global-norm clip at 1.0, then AdamW (decay on leaves of two or more
    dimensions). Clips `grads` in place and returns them."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(1.0 / (norm + 1e-6), max=1.0)
    clipped = {n: g.mul_(scale) for n, g in grads.items()}
    opt["count"] += 1
    c1, c2 = 1 - b1 ** opt["count"], 1 - b2 ** opt["count"]
    for n, p in P.items():
        g = clipped[n]
        opt["mu"][n].mul_(b1).add_(g, alpha=1 - b1)
        opt["nu"][n].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (opt["mu"][n] / c1) / (torch.sqrt(opt["nu"][n] / c2) + eps)
        decay = wd if p.ndim >= 2 else 0.0
        p.sub_(lr * (upd + decay * p))
    return clipped
