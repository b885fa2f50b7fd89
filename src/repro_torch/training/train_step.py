"""Training step: chunked cross-entropy + grad accumulation + AdamW.

Copy of ``repro.training.train_step`` in PyTorch.  The unembed and
log-sum-exp run chunk by chunk of the sequence, each chunk under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` scan
body), so the ``(B, S, V)`` logits are never kept for the backward
(gemma3's 262 k vocabulary would dominate activation memory).  Gradient
accumulation runs the microbatches in turn with f32 accumulators.

Parameters are the model's own tensors made autograd leaves
(``requires_grad``); the stacked groups stay stacked, so each group's
gradient lands in its stacked leaf.  The step updates the parameters
and the optimizer's moments in place (``optimizer.adamw_update``) and
returns them, where the reference's jitted step donates the old trees.
The reference's ``cost_mode`` (one chunk for the dry-run's cost
analysis) has no counterpart: the port's dry-run (``launch.dryrun``)
runs this step on the ``meta`` device and counts every chunk.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import registry as R
from repro_torch.models.layers import unembed
from repro_torch.models.param import leaves, tree_map, unflatten
from repro_torch.training.optimizer import OptConfig, adamw_update

F32 = torch.float32


def _vocab_sharded_ce(logits, tc: torch.Tensor):
    """(log-sum-exp, gold logit, argmax == target) of DTensor ``logits``
    ``(B, c, V)`` whose vocabulary is sharded, without gathering it: the
    row max is a max across the shards (taken off the gradient: the
    shift does not change the value's derivative), the sum of
    ``exp(logit - max)`` and the gold logit (the one non-zero term of a
    masked row) sums across them, and the argmax is the least vocabulary
    index that holds the max, a min across them (the first of equal
    maxima, as ``argmax``)."""
    v = logits.shape[-1]
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    vocab = torch.arange(v, device=tc.device)
    gold = torch.where(vocab == tc[..., None], logits, 0.0).sum(dim=-1)
    first = torch.where(logits == m, vocab, v).amin(dim=-1)
    return lse, gold, first == tc


def chunked_ce_loss(cfg: ArchConfig, params: dict, hidden: torch.Tensor,
                    targets: torch.Tensor, chunk: int = 512):
    """hidden: (B, S, D); targets: (B, S) with -1 = masked. -> (loss,
    metrics).  A DTensor unembedding sharded over its vocabulary takes
    the log-sum-exp, the gold logit and the argmax across the shards
    (``_vocab_sharded_ce``)."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")

    def body(h, t):
        logits = unembed(cfg, params, h).to(F32)             # (B, chunk, V)
        mask = (t >= 0).to(F32)
        tc = torch.clamp(t, min=0).long()
        if is_dtensor(logits) and any(
                p.is_shard() and p.dim == logits.ndim - 1
                for p in logits.placements):
            lse, gold, hit = _vocab_sharded_ce(logits, tc)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, tc[..., None])[..., 0]
            hit = torch.argmax(logits, dim=-1) == tc
        ce = (lse - gold) * mask
        correct = hit.to(F32) * mask
        return ce.sum(), mask.sum(), correct.sum()

    zero = torch.zeros((), dtype=F32, device=hidden.device)
    loss_sum, mask_sum, acc_sum = zero, zero, zero
    for i in range(0, s, chunk):
        ce, m, c = torch.utils.checkpoint.checkpoint(
            body, hidden[:, i:i + chunk], targets[:, i:i + chunk],
            use_reentrant=False, preserve_rng_state=False)
        loss_sum, mask_sum, acc_sum = (loss_sum + ce, mask_sum + m,
                                       acc_sum + c)
    denom = torch.clamp(mask_sum, min=1.0)
    return loss_sum / denom, {"acc": acc_sum / denom, "tokens": mask_sum}


def make_loss_fn(cfg: ArchConfig, *, moe_impl: str = "dispatch",
                 remat: bool = True):
    def loss_fn(params, batch):
        hidden = R.lm_hidden(cfg, params, batch, moe_impl=moe_impl,
                             remat=remat)
        return chunked_ce_loss(cfg, params, hidden, batch["targets"])
    return loss_fn


def _like_param(g, p):
    """A DTensor gradient in its parameter's placements (a partial sum
    reduced, a replicated one sliced): the gradient all-reduce of a
    sharded step."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _map2(fn, a, b):
    """``fn`` over the leaves of two trees of the same keys."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                    moe_impl: str = "dispatch", remat: bool = True,
                    microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; ``params`` and ``opt_state`` are updated in place.

    The batch's leading dim is the global batch; with ``microbatches >
    1`` it is split and the gradients are accumulated in f32 (each
    divided by the count), then cast to the parameters' dtype."""
    loss_fn = make_loss_fn(cfg, moe_impl=moe_impl, remat=remat)

    def single(params, batch):
        paths, flat = zip(*((path, t.requires_grad_(True))
                            for path, t in leaves(params)))
        loss, metrics = loss_fn(params, batch)
        grads = [_like_param(g, p)
                 for g, p in zip(torch.autograd.grad(loss, flat), flat)]
        return loss.detach(), metrics, unflatten(zip(paths, grads))

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = single(params, batch)
        else:
            k = microbatches
            loss = torch.zeros((), dtype=F32,
                               device=next(leaves(params))[1].device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32),
                             params)
            for i in range(k):
                mb = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                      for n, x in batch.items()}
                loss_i, metrics, grads_i = single(params, mb)
                _map2(lambda a, g: a.add_(g.to(F32) / k), grads, grads_i)
                loss = loss + loss_i / k
            grads = _map2(lambda a, p: a.to(p.dtype), grads, params)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step
