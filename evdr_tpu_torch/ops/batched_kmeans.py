"""Batched per-page k-means on the device: (N, Lp, D) -> (N, K, D) centres.

Counterpart of ``evdr_tpu/ops/batched_kmeans.py``, the summary build of
pruned two-stage search (``ops/pruned.py``). The per-page problems are tiny
(Lp tokens, K centres) but there are N of them, so a chunk of pages is
solved at once as batched tensor algebra on the pages' device:

- init: farthest-point seeding, batched over pages: the first centre a
  random valid token (a Gumbel-argmax), each next one the valid token
  farthest from the centres so far;
- Lloyd iterations: assignment by one argmin over K, centre update as a
  one-hot (N, Lp, K)^T x (N, Lp, D) product; masked tokens are never
  sampled and weigh 0 in the update; an empty cluster keeps its centre;
- the final occupancy mask (centres that own a valid token; none on a page
  with no valid token, whose centres are zero).

``torch.argmax`` / ``argmin`` return the first extremum, as ``jnp``'s do.
The page axis is chunked (``chunk_pages``), the tail chunk zero-padded to
the chunk's shape and chunk ``s`` seeded with ``seed + s``, as the JAX
build does, so the first-centre draws have the reference's shapes and
seeds. Those draws come from :func:`gumbel_draws`, which tests replace to
hand the port ``jax.random.gumbel``'s.
"""

from __future__ import annotations

import torch


def gumbel_draws(seed: int, shape, device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` (f32 on ``device``) for the first
    centre of each page, from a ``torch.Generator`` seeded with ``seed``.
    Tests replace this function to hand the port the JAX build's draws
    (``jax.random.gumbel(PRNGKey(seed), shape)``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(shape, generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _sq_dists(P, pn2, centers):
    """(n, lp, k) squared distances of every token to every centre, in the
    reference's form |p|^2 - 2 p.c + |c|^2."""
    dots = torch.einsum("nld,nkd->nlk", P, centers)
    cn2 = (centers * centers).sum(dim=-1)
    return pn2[:, :, None] - 2.0 * dots + cn2[:, None, :]


def _take_tokens(P, idx):
    """P[i, idx[i]] for each page i: (n, d)."""
    return P[torch.arange(P.shape[0], device=P.device), idx]


def _kmeans_chunk(P, pmask, k: int, iters: int, seed: int):
    """One chunk of pages: P (n, lp, d), pmask (n, lp) bool, on one device.
    Returns (centres (n, k, d) f32, occupancy (n, k) bool)."""
    n, lp, d = P.shape
    P = P.float()
    valid = pmask.float()
    pn2 = (P * P).sum(dim=-1)
    neg_inf = torch.tensor(-torch.inf, device=P.device)

    g = gumbel_draws(seed, (n, lp), P.device).to(torch.float32)
    centers = torch.zeros((n, k, d), dtype=torch.float32, device=P.device)
    centers[:, 0] = _take_tokens(P, torch.argmax(
        torch.where(pmask, g, neg_inf), dim=1))
    if k > 1:
        d2min = torch.full((n, lp), torch.inf, device=P.device)
        for j in range(1, k):
            cj = centers[:, j - 1]
            d2 = (pn2 - 2.0 * torch.einsum("nld,nd->nl", P, cj)
                  + (cj * cj).sum(dim=-1)[:, None])
            d2min = torch.minimum(d2min, d2)
            # the farthest VALID token becomes the next centre
            centers[:, j] = _take_tokens(P, torch.argmax(
                torch.where(pmask, d2min, neg_inf), dim=1))

    def assign_weights(centers):
        assign = torch.argmin(_sq_dists(P, pn2, centers), dim=-1)
        return (torch.nn.functional.one_hot(assign, k).float()
                * valid[:, :, None])

    for _ in range(iters):
        w = assign_weights(centers)
        counts = w.sum(dim=1)
        sums = torch.einsum("nlk,nld->nkd", w, P)
        centers = torch.where(counts[..., None] > 0,
                              sums / counts[..., None].clamp_min(1.0),
                              centers)

    cmask = (assign_weights(centers).sum(dim=1) > 0) \
        & pmask.any(dim=1)[:, None]
    return centers * cmask[..., None].float(), cmask


def batched_kmeans(P, pmask, k: int, iters: int = 5, seed: int = 0,
                   chunk_pages: int = 16384, device=None):
    """Per-page k-means over the whole corpus, chunked along the page axis.

    ``P`` (N, Lp, D) of any float dtype (computed in f32) and ``pmask``
    (N, Lp) bool, numpy arrays or tensors; ``device`` (default: ``P``'s,
    the CPU for a numpy array) is where the chunks are solved. Returns f32
    ``(N, k, D)`` centres and ``(N, k)`` bool occupancy, tensors on that
    device."""
    if device is None:
        device = P.device if isinstance(P, torch.Tensor) else "cpu"
    device = torch.device(device)
    n = int(P.shape[0])
    chunk_pages = min(chunk_pages, n)
    outs, masks = [], []
    for s in range(0, n, chunk_pages):
        e = min(s + chunk_pages, n)
        Pc = torch.as_tensor(P[s:e], device=device)
        mc = torch.as_tensor(pmask[s:e], device=device).bool()
        pad = chunk_pages - (e - s)
        if pad:  # the tail chunk at the chunk's shape, as the reference
            Pc = torch.nn.functional.pad(Pc, (0, 0, 0, 0, 0, pad))
            mc = torch.nn.functional.pad(mc, (0, 0, 0, pad))
        c, m = _kmeans_chunk(Pc, mc, k, iters, seed + s)
        outs.append(c[:e - s])
        masks.append(m[:e - s])
    return torch.cat(outs), torch.cat(masks)
