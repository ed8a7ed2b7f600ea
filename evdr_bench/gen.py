"""Inputs made on the device from the seed: clustered pages, queries drawn
from them, and a student index pooled from the pages.

A rewrite, for the device and in blocks, of the program's generator
(``evdr_tpu_torch/data/synthetic.py``: ``make_synthetic_corpus`` and
``pooled_init_index``) with the same model of a page: tokens drawn around
per-page cluster centres (``tokens_per_center`` tokens a centre, jitter
``intra_noise`` per component), unit-normalized; a query token is a page
token plus relative noise ``query_noise``, unit-normalized. Masked tokens
are zero vectors, as padding is.

Pages are made in blocks of ``BLOCK_PAGES``, each from a generator of its
own seeded by (seed, block), so any block can be made again on its own
(the reference does so after the window) and gives the same bytes.
"""

from __future__ import annotations

import hashlib

import torch

BLOCK_PAGES = 1024


def seed_for(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and a stream name."""
    text = ":".join(str(p) for p in (int(seed),) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(seed: int, *parts, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_for(seed, *parts))


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def n_blocks(cfg: dict) -> int:
    return -(-int(cfg["n_pages"]) // BLOCK_PAGES)


def page_block(cfg: dict, seed: int, b: int, device):
    """Pages ``[b * BLOCK_PAGES, ...)`` of the corpus: (n, Lp, D) f32 unit
    tokens (masked ones zero) and the (n, Lp) bool mask."""
    a = cfg["assumed"]
    lp, d = int(cfg["page_tokens"]), int(cfg["dim"])
    n = min(BLOCK_PAGES, int(cfg["n_pages"]) - b * BLOCK_PAGES)
    g = generator(seed, "pages", b, device=device)
    nc = max(1, lp // int(a["tokens_per_center"]))
    centres = unit(torch.randn((n, nc, d), generator=g, device=device))
    assign = torch.randint(0, nc, (n, lp), generator=g, device=device)
    rows = torch.arange(n, device=device)[:, None]
    toks = centres[rows, assign]
    toks.add_(torch.randn((n, lp, d), generator=g, device=device),
              alpha=float(a["intra_noise"]))
    pmask = (torch.rand((n, lp), generator=g, device=device)
             >= float(a["page_mask_share"]))
    return unit(toks).mul_(pmask[..., None]), pmask


def make_pages(cfg: dict, seed: int, device):
    """The whole corpus, block by block, into one (N, Lp, D) f32 tensor."""
    n, lp, d = int(cfg["n_pages"]), int(cfg["page_tokens"]), int(cfg["dim"])
    P = torch.empty((n, lp, d), dtype=torch.float32, device=device)
    pmask = torch.empty((n, lp), dtype=torch.bool, device=device)
    for b in range(n_blocks(cfg)):
        s = b * BLOCK_PAGES
        Pb, mb = page_block(cfg, seed, b, device)
        P[s:s + Pb.shape[0]] = Pb
        pmask[s:s + Pb.shape[0]] = mb
        del Pb, mb
    return P, pmask


def make_queries(cfg: dict, P, pmask, targets: torch.Tensor, g):
    """One query a target page: ``query_tokens`` tokens drawn (with
    replacement) from the page's valid tokens, each plus relative noise,
    unit-normalized; ``query_mask_share`` of the tokens masked (zeroed),
    never the first. Returns (nq, Lq, D) f32 and (nq, Lq) bool."""
    a = cfg["assumed"]
    lq, d = int(a["query_tokens"]), int(cfg["dim"])
    nq = int(targets.shape[0])
    dev = P.device
    w = pmask[targets].float() + 1e-6
    pos = torch.multinomial(w, lq, replacement=True, generator=g)
    toks = P[targets[:, None], pos]
    noise = torch.randn((nq, lq, d), generator=g, device=dev)
    toks.add_(noise, alpha=float(a["query_noise"]) / d ** 0.5)
    qmask = torch.rand((nq, lq), generator=g, device=dev) \
        >= float(a["query_mask_share"])
    qmask[:, 0] = True
    return unit(toks).mul_(qmask[..., None]), qmask


def pooled_init(P, pmask, mf: int):
    """The student's initial index: each page's valid tokens, in order,
    split into ``max(1, n_valid // mf)`` runs as ``numpy.array_split``
    splits them, each run mean-pooled (``pooled_init_index``). Returns
    (N, Ls, D) f32 (zero past a page's runs) and its (N, Ls) mask."""
    n, lp, d = P.shape
    dev = P.device
    nv = pmask.sum(dim=1)
    li = torch.clamp(nv // mf, min=1)
    q, r = nv // li, nv % li
    ls = int(li.max())
    order = torch.sort((~pmask).to(torch.uint8), dim=1, stable=True).indices
    grp = torch.arange(ls, device=dev)[None, :]
    start = grp * q[:, None] + torch.minimum(grp, r[:, None])
    size = q[:, None] + (grp < r[:, None]).long()
    live = grp < li[:, None]
    size = torch.where(live, size, 0)
    width = int(size.max())
    offs = torch.arange(width, device=dev)
    pos = (start[..., None] + offs).clamp_(max=lp - 1)
    take = (offs < size[..., None])
    tok = torch.gather(order, 1, pos.view(n, -1)).view(n, ls, width)
    rows = torch.arange(n, device=dev)[:, None, None]
    sums = (P[rows, tok] * take[..., None]).sum(dim=2)
    mean = sums / size.clamp(min=1)[..., None].float()
    return mean * live[..., None], live
