"""The plain reference of the benchmark's two loops: the MoE network's
forward, the genotype pair probabilities, the training loss and the
optimizer, in plain PyTorch at float32 (TF32 off in cuBLAS and cuDNN).

Written from the reference model's equations (HELLO's MixtureOfExperts
forward, its EM mixture loss, optax's clip-by-global-norm and AdamW), not
from the port's code; it imports nothing of the port.  Inputs are what the
benchmark's generator made (``h100_bench/generator.py``): each platform's
real reads as ``[N, L, C]`` floats with the allele each belongs to, the
real alleles' sites and the sites' one-hot reference windows.  No padding
exists here, so no mask does either.
"""

from __future__ import annotations

import contextlib

import torch

from . import archs
from .net import identity, run_network
from .net import param_shapes as net_param_shapes

#: the port's attribute name of each network (its state-dict prefix)
PREFIX = {"read_conv0": "read_convolver0", "read_conv1": "read_convolver1",
          "compressor0": "compressor0", "compressor1": "compressor1",
          "xattn0": "xattn0", "xattn1": "xattn1", "xattn2": "xattn2",
          "combiner0": "combiner0", "combiner1": "combiner1", "meta": "meta"}

#: rows of reads per block of the read convolvers (keeps the fp32
#: activations of a block near 2 GB)
READ_BLOCK = 16384


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuBLAS's and cuDNN's TF32 switches for the block, and cuDNN's
    deterministic algorithms (the same sums on every run), restored
    after."""
    flags = torch.backends.cudnn
    old = (torch.backends.cuda.matmul.allow_tf32, flags.allow_tf32,
           flags.deterministic, flags.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    flags.allow_tf32 = enabled
    flags.deterministic, flags.benchmark = True, False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, flags.allow_tf32,
         flags.deterministic, flags.benchmark) = old


def config(name: str) -> dict:
    return archs.NAMED_CONFIGS[name]()


def param_shapes(cfg) -> dict:
    """{state-dict key: shape} of every network of the configuration."""
    out = {}
    for name, specs in cfg.items():
        net_param_shapes(specs, PREFIX[name], out)
    return out


def _net(cfg, params, name, x, quant):
    return run_network(cfg[name], params, PREFIX[name], x, quant)


def _site_sum(feats, allele_site, num_sites):
    """Per-site sum of allele features, accumulated in float64."""
    out = feats.new_zeros((num_sites,) + tuple(feats.shape[1:]),
                          dtype=torch.float64)
    return out.index_add(0, allele_site, feats.double()).float()


def read_reduce(cfg, params, k, reads, read_allele, num_alleles, quant):
    """Platform k's reads through its read convolver, summed per allele
    (float64 accumulation) -> [A, 36, 64]."""
    out = None
    for lo in range(0, reads.shape[0], READ_BLOCK):
        frames = _net(cfg, params, f"read_conv{k}",
                      reads[lo:lo + READ_BLOCK], quant)
        if out is None:
            out = frames.new_zeros((num_alleles,) + tuple(frames.shape[1:]),
                                   dtype=torch.float64)
        out = out.index_add(0, read_allele[lo:lo + READ_BLOCK],
                            frames.double())
    return out.float()


def forward(cfg, params, inputs, quant=identity):
    """{"experts": [A, E] logits, "meta": [S, 3] weights or None}.

    ``inputs``: ``reads{k}`` [N_k, L, C] float, ``read_allele{k}`` [N_k]
    long, ``allele_site`` [A] long, ``ref_segments`` [S, L, 5] float."""
    site = inputs["allele_site"]
    S = inputs["ref_segments"].shape[0]
    A = site.shape[0]

    def expert(idx, reduced):
        ca = _net(cfg, params, f"compressor{idx}", reduced, quant)
        cs0 = _net(cfg, params, f"compressor{idx}",
                   _site_sum(reduced, site, S), quant)
        cs1 = _site_sum(ca, site, S)
        logits = _net(cfg, params, f"xattn{idx}", (ca, (cs0[site], cs1[site])),
                      quant)
        return logits, cs1, ca

    r0 = read_reduce(cfg, params, 0, inputs["reads0"], inputs["read_allele0"],
                     A, quant)
    e0, cs1_0, ca0 = expert(0, r0)
    if cfg.get("read_conv1") is None:
        return {"experts": e0, "meta": None}
    if cfg.get("combiner0") is None or cfg.get("meta") is None:
        raise ValueError("the plain reference knows the single-platform "
                         "model and the full hybrid (combiners, xattn2, "
                         "meta); add another model's equations here")
    r1 = read_reduce(cfg, params, 1, inputs["reads1"], inputs["read_allele1"],
                     A, quant)
    e1, cs1_1, ca1 = expert(1, r1)
    ca2 = _net(cfg, params, "combiner0", (ca0, ca1), quant)
    cs2 = _net(cfg, params, "combiner1", (cs1_0, cs1_1), quant)
    e2 = _net(cfg, params, "xattn2", (ca2, (None, cs2[site])), quant)
    meta = torch.softmax(_net(cfg, params, "meta",
                              (cs2, inputs["ref_segments"]), quant), dim=-1)
    return {"experts": torch.cat([e0, e1, e2], dim=-1), "meta": meta}


# -- genotypes -------------------------------------------------------------

def pair_log_terms(experts, allele_site, num_sites):
    """(site_l0 [S, E], d [A, E]) in float64: a pair (i, j) of one site has
    log-probability ``site_l0 + d_i + d_j`` under each expert (``d_i`` once
    when i == j), with the allele sigmoids cushioned by 1e-10 inside the
    logs as the reference's decode does."""
    sig = torch.sigmoid(experts.double())
    l1 = torch.log(sig + 1e-10)
    l0 = torch.log((1.0 - sig) + 1e-10)
    site_l0 = l0.new_zeros((num_sites, l0.shape[1])).index_add(
        0, allele_site, l0)
    return site_l0, l1 - l0


def pair_prob(site_l0, d, meta, site, i, j):
    """Mixed probability of slot pairs (i, j) of sites ``site`` (1-D
    tensors of one length)."""
    logp = site_l0[site] + d[i] + torch.where((i != j)[:, None], d[j], 0.0)
    p = torch.exp(logp)
    if meta is None:
        return p[:, 0]
    return (p * meta.double()[site][:, :p.shape[1]]).sum(dim=1)


def best_pairs(experts, meta, allele_site, num_sites):
    """Per site: the highest pair probability and every pair's
    (site, i, j, probability), i <= j over the site's alleles."""
    site_l0, d = pair_log_terms(experts, allele_site, num_sites)
    A = allele_site.shape[0]
    idx = torch.arange(A, device=allele_site.device)
    ii, jj = torch.meshgrid(idx, idx, indexing="ij")
    keep = (allele_site[ii] == allele_site[jj]) & (ii <= jj)
    i, j = ii[keep], jj[keep]
    s = allele_site[i]
    p = pair_prob(site_l0, d, meta, s, i, j)
    best = torch.full((num_sites,), -1.0, dtype=torch.float64,
                      device=p.device).scatter_reduce(0, s, p, "amax")
    return best, (site_l0, d)


# -- training --------------------------------------------------------------

def capped_log(x):
    cushioned = x + 1e-10
    return torch.log(torch.where(cushioned > 1.0 - 1e-10, x, cushioned))


def clip(x, lo, hi):
    """``jnp.clip`` (the loss of hello_tpu, the system the port follows):
    a max, then a min, each of which splits its gradient evenly at a tie.
    ``torch.clamp`` passes the whole gradient at a bound; the two differ
    where a sigmoid rounds to the bound itself, which fp32 does for every
    logit from about 15.9 to 16.6 (1 - 2**-23)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def moe_loss(experts, meta, labels, allele_site, regularizer):
    """The EM mixture loss of one batch's real alleles: posterior-weighted
    (no gradient through the posterior) log-likelihood of each expert's
    Bernoulli and of the meta weight, plus the meta entropy times
    ``regularizer``; negated."""
    labels = labels.float()[:, None]
    meta_allele = meta[allele_site]
    preds = clip(torch.sigmoid(experts), 1e-7, 1.0 - 1e-7)
    entropy = -torch.sum(meta * capped_log(meta)) * regularizer
    probs = labels * preds + (1 - labels) * (1 - preds)
    joint = probs * meta_allele + 1e-10
    posterior = (joint / joint.sum(dim=1, keepdim=True)).detach()
    total = torch.sum(posterior * (capped_log(probs) + capped_log(meta_allele)))
    return -(total + entropy)


class AdamW:
    """clip_by_global_norm(max_norm), then Adam with decoupled weight decay
    on every parameter (optax's ``adamw`` chain), learning rate constant."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr, weight_decay, max_norm):
        self.params, self.lr, self.wd, self.max_norm = (params, lr,
                                                        weight_decay, max_norm)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def clip(self, grads):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if self.max_norm and float(norm) >= self.max_norm:
            return [g / norm * self.max_norm for g in grads]
        return list(grads)

    @torch.no_grad()
    def update(self, grads):
        self.count += 1
        bc1 = 1 - self.B1 ** self.count
        bc2 = 1 - self.B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.B1).add_((1 - self.B1) * g)
            v.mul_(self.B2).add_((1 - self.B2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.EPS) + self.wd * p
            p.sub_(self.lr * upd)


def train_steps(cfg, params, batches, train, quant=identity, half=False):
    """The first ``len(batches)`` training steps from ``params`` (a dict of
    fp32 tensors, copied here).  ``train``: the traffic's training settings
    (lr, weight_decay, grad_clip_norm, entropy_regularizer, entropy_decay).
    ``half`` plants the fault of a step that leaves half of each batch out
    and takes the mean over the rest (twice the remaining alleles' loss).

    Returns {"losses": [float], "grads": {name: the first step's clipped
    gradient}, "params": {name: parameters after the steps}}."""
    names = sorted(params)
    leaves = [params[n].detach().clone().requires_grad_(True) for n in names]
    view = dict(zip(names, leaves))
    opt = AdamW(leaves, train["lr"], train["weight_decay"],
                train["grad_clip_norm"])
    losses, first = [], None
    for step, batch in enumerate(batches):
        reg = train["entropy_regularizer"] * train["entropy_decay"] ** step
        out = forward(cfg, view, batch, quant)
        if out["meta"] is None:
            raise ValueError("the plain reference trains the models with a "
                             "meta-expert; add the binary loss for others")
        experts, labels, site = out["experts"], batch["labels"], \
            batch["allele_site"]
        if half:
            keep = torch.arange(site.shape[0], device=site.device) % 2 == 0
            loss = 2 * moe_loss(experts[keep], out["meta"], labels[keep],
                                site[keep], reg)
        else:
            loss = moe_loss(experts, out["meta"], labels, site, reg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        grads = opt.clip(grads)
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        opt.update(grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first,
            "params": {n: p.detach() for n, p in zip(names, leaves)}}
