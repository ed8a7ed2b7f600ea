"""The plain reference: masked MaxSim search and score distillation in
plain PyTorch, written from their definitions.

It imports nothing of the program and takes nothing the program made. From
the float pages and queries the benchmark made it works out again what the
program derives from them: per-token symmetric integer codes and scales
(``amax / levels``, round half to even, clipped to +-levels) of pages and
queries, their scores and top-k; the f32 rerank scores of dequantized
pages; and, for training, the teacher table, the student's scores, the
liscore loss, its gradient and AdamW's update.

Scores, by definition:
- quantized search: a similarity is (query codes . page codes) times the
  page token's scale; an invalid page token never wins the max, a page with
  no valid token scores 0; each query token's max is weighted by its mask
  times its scale, and the weighted maxes are summed;
- f32 rerank: (f32 query . dequantized page token), invalid page tokens
  filled with -1e4 before the max, masked query tokens weighted 0, a page
  with no valid token at -inf;
- training: as the rerank on float tokens, a page with no valid token 0.

Every product runs in float32 with TF32 off unless ``tf32=True`` (the
control of a float32 configuration). Integer codes of at most 8 bits make
exact float32 products at D = 128.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Tuple

import torch

NEG_TOKEN = -1e30
RERANK_FILL = -1e4
# elements of one similarity block the reference materializes
BLOCK_ELEMS = 1 << 28


@contextlib.contextmanager
def precision(tf32: bool = False):
    """f32 matmuls at full precision (or in TF32) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def quantize(x: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric quantization: (codes as f32, scales). A zero
    token gets scale 0 and zero codes."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, float(levels))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.round(x / safe[..., None]).clamp_(-levels, levels)
    return codes * (scale > 0)[..., None], scale


def _pages_a_block(n_rows: int, lp: int) -> int:
    """Pages whose (rows, pages x Lp) similarities fit one block."""
    return max(1, BLOCK_ELEMS // max(1, n_rows * lp))


def quantized_scores(Q, qmask, P, pmask, levels: int) -> torch.Tensor:
    """(nq, n) scores of quantized queries against quantized pages."""
    nq, lq, d = Q.shape
    n, lp, _ = P.shape
    qc, qs = quantize(Q, levels)
    qw = qmask.float() * qs
    rows = qc.reshape(nq * lq, d)
    out = torch.empty((nq, n), dtype=torch.float32, device=Q.device)
    step = _pages_a_block(nq * lq, lp)
    for s in range(0, n, step):
        pc, ps = quantize(P[s:s + step], levels)
        c = pc.shape[0]
        sim = (rows @ pc.reshape(c * lp, d).T).view(nq * lq, c, lp)
        sim = torch.where(pmask[s:s + step][None], sim * ps[None],
                          NEG_TOKEN)
        mx = sim.amax(dim=-1)
        mx = torch.where(mx > NEG_TOKEN / 10, mx, 0.0)
        out[:, s:s + c] = (mx.view(nq, lq, c) * qw[..., None]).sum(dim=1)
    return out


def rerank_scores(Q, qmask, P, pmask, levels: int) -> torch.Tensor:
    """(nq, n) f32 scores of float queries against dequantized pages
    (``levels`` None: the float pages themselves)."""
    nq, lq, d = Q.shape
    n, lp, _ = P.shape
    rows = Q.float().reshape(nq * lq, d)
    out = torch.empty((nq, n), dtype=torch.float32, device=Q.device)
    step = _pages_a_block(nq * lq, lp)
    for s in range(0, n, step):
        Pb = P[s:s + step].float()
        if levels is not None:
            pc, ps = quantize(Pb, levels)
            Pb = pc * ps[..., None]
        c = Pb.shape[0]
        mb = pmask[s:s + step]
        sim = (rows @ Pb.reshape(c * lp, d).T).view(nq * lq, c, lp)
        sim = sim.masked_fill(~mb[None], RERANK_FILL)
        mx = sim.amax(dim=-1).view(nq, lq, c)
        sc = (mx * qmask.float()[..., None]).sum(dim=1)
        out[:, s:s + c] = torch.where(mb.any(dim=-1)[None], sc, -torch.inf)
    return out


def corpus_scores(blocks: Callable[[], Iterator], Q, qmask, kind: str,
                  levels, tf32: bool = False) -> torch.Tensor:
    """(nq, N) scores over a corpus given as an iterator of (pages, mask)
    blocks, made again block by block. ``kind``: 'quantized' or
    'rerank'."""
    score = {"quantized": quantized_scores, "rerank": rerank_scores}[kind]
    parts = []
    with precision(tf32), torch.no_grad():
        for Pb, mb in blocks():
            parts.append(score(Q, qmask, Pb, mb, levels))
            del Pb, mb
    return torch.cat(parts, dim=1)


# ------------------------------------------------------------- training


def maxsim_f32(Q, qmask, P, pmask, chunk: int = 64) -> torch.Tensor:
    """Differentiable masked MaxSim of float tokens: (nq, n)."""
    out = []
    for s in range(0, P.shape[0], chunk):
        Pb, mb = P[s:s + chunk], pmask[s:s + chunk]
        sim = torch.einsum("qnd,cmd->qcnm", Q, Pb)
        sim = sim.masked_fill(~mb[None, :, None, :], RERANK_FILL)
        mx = sim.amax(dim=-1) * mb.any(dim=-1)[None, :, None].float()
        out.append((mx * qmask.float()[:, None, :]).sum(dim=-1))
    return torch.cat(out, dim=1)


def l2_unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def liscore(sc_s, sc_t, k: int, temp: float, lambda_list: float,
            lambda_score: float) -> torch.Tensor:
    """Listwise distillation over the teacher's top-k (softened by
    ``temp``, scaled by temp^2) plus the mean squared score gap."""
    k = min(int(k), sc_s.shape[-1])
    logp_s = torch.log_softmax(sc_s / temp, dim=-1)
    p_t = torch.softmax(sc_t / temp, dim=-1)
    top_p, top_i = torch.sort(p_t, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    listwise = -(top_p * torch.gather(logp_s, -1, top_i)).sum(-1).mean()
    score = ((sc_s - sc_t) ** 2).mean()
    return lambda_list * listwise * temp ** 2 + lambda_score * score


def train_reference(P_t, pm_t, Q, qmask, batches, p0, pm_s, hp: dict,
                    tf32: bool = False) -> dict:
    """The first steps of score distillation from student ``p0``: each
    batch's teacher rows, the student's scores of its normalized masked
    tokens, liscore, its gradient and a decoupled-weight-decay Adam step.
    Returns each step's loss, the first gradient and the change of the
    student after the last step."""
    b1, b2 = hp["betas"]
    lr, wd, eps = hp["lr"], hp["weight_decay"], hp["eps"]
    pm_f = pm_s[..., None].float()
    p = p0.detach().clone().float()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    losses, grad1 = [], None
    with precision(tf32):
        for t, idx in enumerate(batches, start=1):
            idx = torch.as_tensor(idx, dtype=torch.long, device=p.device)
            Qb, qmb = Q[idx], qmask[idx]
            with torch.no_grad():
                sc_t = maxsim_f32(Qb, qmb, P_t, pm_t)
            leaf = p.clone().requires_grad_(True)
            sc_s = maxsim_f32(Qb, qmb, l2_unit(leaf * pm_f), pm_s)
            loss = liscore(sc_s, sc_t, hp["k"], hp["temp"],
                           hp["lambda_list"], hp["lambda_score"])
            (g,) = torch.autograd.grad(loss, leaf)
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = g.detach().clone()
            with torch.no_grad():
                p.mul_(1.0 - lr * wd)
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v.sqrt() / (1.0 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))
    return {"losses": losses, "grad1": grad1, "delta": p - p0.float()}
