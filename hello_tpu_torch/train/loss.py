"""Training losses for the MoE model over padded batches (torch).

The port of hello_tpu's train/loss.py, function for function and with the
same arithmetic: ``moe_loss`` is the EM-style posterior-weighted mixture
likelihood (per-allele expert Bernoulli probabilities weighted by a
no-gradient posterior over experts, entropy regularisation, label smoothing,
an optional per-expert auxiliary loss and class weights); ``binary_loss`` is
the masked BCE of the no-ensemble and single-expert models.  Every reduction
is masked, so padded allele slots contribute exactly zero to the loss and to
the gradients.

Where the gradient of an element-wise min/max is taken at a tie, JAX gives
each side half; ``torch.maximum`` / ``torch.minimum`` do the same, where
``torch.clamp`` would pass the whole gradient.  So clips are written with
them.
"""

from __future__ import annotations

import torch


def capped_log(x):
    """log with a 1e-10 cushion that is not applied near 1, keeping logs
    <= 0.  The gradient flows through the selected argument only, and the
    one not selected is finite, so it adds no NaN."""
    cushioned = x + 1e-10
    return torch.log(torch.where(cushioned > 1.0 - 1e-10, x, cushioned))


def posterior_probs(expert_probs, meta, labels):
    """EM posterior over experts given targets; inputs allele-level [A, E]."""
    joint = expert_probs * meta + 1e-10
    return joint / torch.sum(joint, dim=1, keepdim=True)


def _clip(x, lo, hi):
    """``jnp.clip``: max then min, each splitting its gradient at a tie."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def moe_loss(expert_logits, meta, labels, site_ids, allele_mask,
             regularizer: float = 0.0,
             smoothing: float = 0.0,
             aux_weight: float = 0.0,
             class_weights=(1.0, 1.0),
             train: bool = True):
    """EM mixture-of-experts loss over one padded batch.

    expert_logits: [A, E]; meta: [S, E] softmaxed weights; labels: [A] in
    {0,1}; site_ids: [A]; allele_mask: [A].  ``regularizer`` is the current
    entropy coefficient (the caller owns its per-step decay).

    Returns (total_loss, per_expert_loss [E], posterior [A, E])."""
    labels = labels.float()[:, None]                      # [A, 1]
    mask = allele_mask.float()[:, None]                   # [A, 1]
    # weights[label] without a host-to-device copy of the weights
    target_weights = torch.where(labels.long() == 1, float(class_weights[1]),
                                 float(class_weights[0]))

    site_ids = site_ids.long()
    meta_allele = meta[site_ids]                          # [A, E]
    # clamp away from {0, 1}: keeps the backward of the log terms finite at
    # saturated logits
    expert_preds = _clip(torch.sigmoid(expert_logits), 1e-7, 1.0 - 1e-7)

    # entropy regularisation over site-level meta predictions
    site_mask = torch.zeros(meta.shape[0], dtype=torch.float32,
                            device=meta.device).scatter_reduce(
        0, site_ids, allele_mask.float(), "amax")
    meta_entropy = -torch.sum(
        meta * capped_log(meta) * site_mask[:, None]) * regularizer

    if train and smoothing > 0:
        labels = labels + labels * (-smoothing) + (1 - labels) * smoothing

    expert_probs = labels * expert_preds + (1 - labels) * (1 - expert_preds)
    posterior = posterior_probs(expert_probs, meta_allele, labels).detach()

    total = torch.sum(
        posterior * (capped_log(expert_probs) + capped_log(meta_allele))
        * target_weights * mask)
    if train:
        total = total + meta_entropy

    per_expert = torch.sum(capped_log(expert_probs) * mask, dim=0)
    if train and aux_weight > 0:
        total = total + aux_weight * torch.sum(per_expert) / expert_logits.shape[1]

    return -total, -per_expert, posterior


def binary_loss(expert_logits, labels, allele_mask):
    """Masked BCE in logit space, max(x, 0) - x y + log1p(exp(-|x|)), the
    form that stays finite at saturated logits."""
    labels = labels.float()
    mask = allele_mask.float()
    logits = expert_logits[:, 0]
    # |x| as a select, whose gradient at 0 is 1 as jnp.abs's is (torch.abs
    # gives 0 there)
    abs_logits = torch.where(logits >= 0, logits, -logits)
    bce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
           + torch.log1p(torch.exp(-abs_logits)))
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(bce * mask) / denom


def prediction_loss(expert_logits, meta, labels, site_ids, allele_mask):
    """Validation-style system likelihood."""
    labels = labels.float()[:, None]
    mask = allele_mask.float()[:, None]
    meta_allele = meta[site_ids.long()]
    preds = torch.sigmoid(expert_logits)
    expert_probs = labels * preds + (1 - labels) * (1 - preds)
    system = torch.sum(expert_probs * meta_allele, dim=1, keepdim=True)
    return -torch.sum(capped_log(system) * mask)


def accuracy(expert_logits, meta, labels, site_ids, allele_mask):
    """Fraction of real allele slots classified correctly."""
    labels = labels.float()
    mask = allele_mask.float()
    meta_allele = meta[site_ids.long()]
    preds = torch.sigmoid(expert_logits)
    mean_pred = torch.sum(preds * meta_allele, dim=1)
    correct = ((mean_pred > 0.5) == (labels > 0.5)).float()
    return torch.sum(correct * mask) / torch.clamp(torch.sum(mask), min=1.0)
