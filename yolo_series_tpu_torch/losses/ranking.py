"""The ranking losses RankSort, AP and aLRP (counterpart of
`yolo_series_tpu/losses/ranking.py`; reference utils/loss.py:176-419).

Each takes logits (N,), targets (N,) in [0, 1] (above 0: a foreground
with that IoU quality) and a validity mask. The pairwise relations are
(N, N) matrices over all positives at once, as in the JAX package.
`rank_sort_loss` has the reference's "identity update" gradient, which is
not the derivative of its value: a `torch.autograd.Function` whose
backward returns g x that gradient, as the JAX package's custom VJP does.
`ap_loss` and `alrp_loss` differentiate as plain functions.
"""

from __future__ import annotations

import torch


def _relations(a, b, delta):
    """The smoothed step H((a_j - b_i) / 2 delta + 1/2), rows = anchors i."""
    d = a[None, :] - b[:, None]
    if delta > 0:
        return torch.clamp(d / (2 * delta) + 0.5, 0.0, 1.0)
    return (d >= 0).float()


def _fg_bg(logits, targets, valid, delta):
    """(fg, bg, fg_num): the foregrounds, the backgrounds scored at least
    the lowest foreground less delta, and max(#fg, 1)."""
    fg = (targets > 0) & valid
    fg_num = torch.clamp(fg.sum(), min=1)
    inf = torch.full((), float("inf"), dtype=logits.dtype, device=logits.device)
    min_fg_logit = torch.where(fg, logits, inf).min()
    bg = (targets == 0) & valid & (logits >= min_fg_logit - delta)
    return fg, bg, fg_num


def _rank_sort_core(logits, targets, valid, delta):
    """(ranking loss, sorting loss, the identity-update gradient)."""
    fg, bg, fg_num = _fg_bg(logits, targets, valid, delta)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    rel = _relations(logits, logits, delta)
    fg_rel = rel * fg[None, :]                                   # (N, N): j fg
    bg_rel = rel * bg[None, :]                                   # (N, N): j bg

    rank_pos = fg_rel.sum(1)
    fp_num = bg_rel.sum(1)
    rank = rank_pos + fp_num
    ranking_error = torch.where(fg, fp_num / torch.clamp(rank, min=1e-10), zero)

    cur_sort = (fg_rel * (1.0 - targets)[None, :]).sum(1) / torch.clamp(rank_pos, min=1e-10)
    iou_rel = (targets[None, :] >= targets[:, None]) & fg[None, :]
    tso = iou_rel * fg_rel
    rank_pos_t = tso.sum(1)
    tgt_sort = (tso * (1.0 - targets)[None, :]).sum(1) / torch.clamp(rank_pos_t, min=1e-10)
    sorting_error = torch.where(fg, cur_sort - tgt_sort, zero)

    eps = 1e-10
    has_fp = fp_num > eps
    fg_grad = -torch.where(fg & has_fp, ranking_error, zero)
    bg_grad = torch.where((fg & has_fp)[:, None],
                          bg_rel * (ranking_error / torch.clamp(fp_num, min=eps))[:, None],
                          zero).sum(0)

    missorted = (~iou_rel) & (fg_rel > 0) & fg[:, None] & fg[None, :]
    miss_rel = torch.where(missorted, fg_rel, zero)
    pmf_denom = miss_rel.sum(1)
    has_ms = pmf_denom > eps
    fg_grad = fg_grad - torch.where(fg & has_ms, sorting_error, zero)
    fg_grad = fg_grad + torch.where(
        (fg & has_ms)[:, None],
        miss_rel * (sorting_error / torch.clamp(pmf_denom, min=eps))[:, None], zero).sum(0)

    grads = (torch.where(fg, fg_grad, zero) + torch.where(bg, bg_grad, zero)) / fg_num
    rank_loss = torch.where(fg, ranking_error, zero).sum() / fg_num
    sort_loss = torch.where(fg, sorting_error, zero).sum() / fg_num
    return rank_loss, sort_loss, grads


class _RankSort(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, valid, delta):
        rank_loss, sort_loss, grads = _rank_sort_core(logits.detach(), targets, valid, delta)
        ctx.save_for_backward(grads)
        return rank_loss + sort_loss

    @staticmethod
    def backward(ctx, g):
        (grads,) = ctx.saved_tensors
        return g * grads, None, None, None


def rank_sort_loss(logits, targets, valid, delta=0.5):
    """The RankSort loss (reference RankSort, loss.py:176-261): ranking
    error plus sorting error over the foregrounds, with the identity-update
    gradient."""
    return _RankSort.apply(logits, targets, valid, delta)


def ap_loss(logits, targets, valid, delta=1.0):
    """The average-precision ranking loss (reference APLoss,
    loss.py:344-419): a foreground's precision error."""
    fg, bg, fg_num = _fg_bg(logits, targets, valid, delta)
    rel = _relations(logits, logits, delta)
    fg_rel = rel * fg[None, :]
    bg_rel = rel * bg[None, :]
    eye = torch.eye(logits.shape[0], dtype=logits.dtype, device=logits.device)
    rank_pos = 1.0 + (fg_rel * (1.0 - eye)).sum(1)
    fp_num = bg_rel.sum(1)
    prec = rank_pos / torch.clamp(rank_pos + fp_num, min=1e-10)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return torch.where(fg, 1.0 - prec, zero).sum() / fg_num


def alrp_loss(cls_logits, targets, reg_quality, valid, delta=1.0):
    """The average Localisation-Recall-Precision loss (reference aLRPLoss,
    loss.py:263-341): (the ranking term, the localisation term weighted by
    the same ranking)."""
    fg, bg, fg_num = _fg_bg(cls_logits, targets, valid, delta)
    rel = _relations(cls_logits, cls_logits, delta)
    fg_rel = rel * fg[None, :]
    bg_rel = rel * bg[None, :]
    rank_pos = torch.clamp(fg_rel.sum(1), min=1e-10)
    rank = rank_pos + bg_rel.sum(1)
    loc = (fg_rel * (1.0 - reg_quality)[None, :]).sum(1)
    loc_err = loc / rank_pos
    lrp = (bg_rel.sum(1) + loc) / torch.clamp(rank, min=1e-10)
    zero = torch.zeros((), dtype=cls_logits.dtype, device=cls_logits.device)
    cls_term = torch.where(fg, lrp, zero).sum() / fg_num
    loc_term = torch.where(fg, loc_err, zero).sum() / fg_num
    return cls_term, loc_term
