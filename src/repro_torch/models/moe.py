"""Top-k Mixture-of-Experts: the port's ``repro.models.moe`` (``_act``,
``router_probs``, ``aux_losses``, ``moe_block`` and its capacity path
``_capacity``, ``_dispatch_local``, ``_expert_ffn``, ``_combine_local``).

Two semantics, as in the reference:

- ``impl="dense"`` (and ``"auto"`` without a mesh): the reference's
  ``mesh=None`` mode, which its serving engine runs.  The reference computes
  every expert for every token and weights them by a top-k-sparse gate; the
  port computes the same function as a dropless dispatch: the T*k (token,
  expert) pairs sorted by expert, one product per non-empty expert over its
  contiguous rows, and the gate-weighted rows put back in token order and
  summed over each token's k in fp32.  No capacity limit.  The two sum the
  same k nonzero terms in another order.
- ``impl="capacity"`` (and ``"auto"`` under a mesh): the reference's
  shard_map path.  Each expert takes at most ``C`` rows (``_capacity``); a
  (token, slot) pair's rank within its expert is its place in the
  token-major order of the top-k ids, and pairs ranked at or past ``C``
  are dropped.

Under a mesh ``x`` is this rank's data shard of the batch, and the
capacity path runs on its tokens alone (``C = _capacity(T_local, ...)``),
as the reference's shard_map does.  Where the experts divide the model
axis the weights hold this rank's ``E / model`` experts (expert parallel:
the rank takes its experts' slice of the dispatch tables); else the
experts' hidden dim is split (``we_in`` / ``we_gate`` columns, ``we_out``
rows).  Either way the partial outputs are all-reduced over "model".  The
aux loss is data shard 0's on every rank, as the reference's
``out_specs=P()`` returns it; its gradient, as the reference's, is the
mean over the data shards of each shard's own (``sharding.TensorParallel.
shard0``).  The dense mode under a mesh gathers the experts and takes the
aux loss over the whole batch, as the reference's GSPMD dense mode does.

The dropless dispatch reads each expert's row count on the host: one
``tolist()`` a call (``HOST_SYNCS_PER_CALL``), so that each expert's
product runs over exactly its rows.  The capacity path needs none.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import LOCAL, ShardingRules, TensorParallel

# host syncs of one dropless ``moe_block`` call (the experts' row counts)
HOST_SYNCS_PER_CALL = 1


def _act(cfg: ModelConfig, gate, up):
    """The MLP activation.  GELU is the tanh form, ``jax.nn.gelu``'s
    default, not PyTorch's erf default."""
    if cfg.mlp_act == "silu_glu":
        return F.silu(gate) * up
    if cfg.mlp_act == "gelu_glu":
        return F.gelu(gate, approximate="tanh") * up
    if cfg.mlp_act == "relu2":
        return torch.square(F.relu(up))
    return F.gelu(up, approximate="tanh")


def mlp(blk, x, cfg: ModelConfig, tp: TensorParallel = LOCAL,
        prefix: str = ""):
    """The MLP ``act(x w_gate, x w_in) w_out`` of ``blk[prefix + ...]``;
    column-parallel ``w_in`` / ``w_gate`` and row-parallel ``w_out``, the
    partial products all-reduced, where ``tp`` keeps their hidden dim
    split."""
    split = tp.kept(prefix + "w_in")
    xi = tp.enter(x) if split else x
    up = xi @ blk[prefix + "w_in"].to(x.dtype)
    gate = xi @ blk[prefix + "w_gate"].to(x.dtype) \
        if prefix + "w_gate" in blk else None
    y = _act(cfg, gate, up) @ blk[prefix + "w_out"].to(x.dtype)
    return tp.reduce(y) if split else y


def router_probs(x, router_w):
    """Router softmax and logits, in fp32 whatever the activations' type."""
    logits = x.float() @ router_w.float()
    return torch.softmax(logits, dim=-1), logits


def _top_k(gates, k: int, norm_topk: bool):
    """The k largest gates of each token (descending) and their experts;
    with ``norm_topk`` the k weights renormalised to sum to 1."""
    w, ids = torch.topk(gates, k, dim=-1, sorted=True)
    if norm_topk:
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return w, ids


def _expert_counts(e_flat, E: int):
    """Pairs routed to each expert, int64, without a host sync
    (``bincount`` on a card reads the largest id first)."""
    return torch.zeros(E, dtype=torch.int64, device=e_flat.device
                       ).scatter_add_(0, e_flat, torch.ones_like(e_flat))


def aux_losses(gates, ids, E: int):
    """Switch load-balance loss: E * sum_e (share of the T*k slots routed to
    e) * (mean gate of e)."""
    frac_tokens = _expert_counts(ids.reshape(-1), E).float() / ids.numel()
    return E * torch.sum(frac_tokens * gates.mean(0))


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(T * k / E * cf) + 1
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


def _dispatch_local(x, gates, k: int, C: int, norm_topk: bool):
    """x (T, d), gates (T, E) fp32 -> (xe (E, C, d), table (E, C) token ids
    with the sentinel T where a slot is empty, wtable (E, C) combine
    weights).  Pairs ranked at or past ``C`` within their expert land in a
    discarded column (the reference's ``mode="drop"``)."""
    T, d = x.shape
    E = gates.shape[1]
    w, ids = _top_k(gates, k, norm_topk)
    e_flat = ids.reshape(-1)
    onehot = F.one_hot(e_flat, E)
    p_flat = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    p_flat = torch.clamp(p_flat, max=C)           # column C: dropped
    t_flat = torch.arange(T * k, device=x.device) // k
    table = torch.full((E, C + 1), T, dtype=torch.int64, device=x.device)
    table[e_flat, p_flat] = t_flat
    wtable = torch.zeros((E, C + 1), dtype=w.dtype, device=x.device)
    wtable[e_flat, p_flat] = w.reshape(-1)
    table, wtable = table[:, :C].contiguous(), wtable[:, :C].contiguous()
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    return x_pad[table], table, wtable


def _expert_ffn(cfg: ModelConfig, blk, xe):
    """xe (E, C, d) -> (E, C, d) through each expert's MLP."""
    up = torch.bmm(xe, blk["we_in"].to(xe.dtype))
    gate = torch.bmm(xe, blk["we_gate"].to(xe.dtype)) \
        if "we_gate" in blk else None
    return torch.bmm(_act(cfg, gate, up), blk["we_out"].to(xe.dtype))


def _combine_local(ye, table, wtable, T: int, d: int):
    """Each slot's gate-weighted row added into its token; the sentinel
    rows (token T) are discarded."""
    out = ye.new_zeros((T + 1, d))
    contrib = ye * wtable[..., None].to(ye.dtype)
    out.index_add_(0, table.reshape(-1), contrib.reshape(-1, d))
    return out[:T]


def _dropless(cfg: ModelConfig, blk, x, w, ids):
    """x (T, d), w / ids (T, k) -> sum over each token's k experts of w *
    expert(x): the pairs sorted by expert (stable, so each expert's rows
    keep token order), one product per non-empty expert, the weighted rows
    put back in token order and summed over the k in fp32 (a fixed order:
    the same inputs give the same bits, which atomic adds would not)."""
    T, d = x.shape
    k = ids.shape[1]
    E = cfg.n_experts
    e_flat = ids.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    tok = order // k
    counts = _expert_counts(e_flat, E).tolist()            # the host sync
    xs = x[tok]
    ys = torch.empty_like(xs)
    has_gate = "we_gate" in blk
    start = 0
    for e, n in enumerate(counts):
        if n:
            seg = xs[start:start + n]
            up = seg @ blk["we_in"][e].to(x.dtype)
            gate = seg @ blk["we_gate"][e].to(x.dtype) if has_gate else None
            ys[start:start + n] = _act(cfg, gate, up) @ \
                blk["we_out"][e].to(x.dtype)
            start += n
    yw = ys.float() * w.reshape(-1)[order, None].float()
    yt = torch.empty_like(yw).index_copy_(0, order, yw)   # token-major
    return yt.view(T, k, d).sum(1).to(x.dtype)


def _global_aux(gates, ids, E: int, tp: TensorParallel):
    """``aux_losses`` over every data shard's tokens (the dense mode under
    a mesh)."""
    counts = tp.reduce_data(_expert_counts(ids.reshape(-1), E).float())
    probs = tp.reduce_data(gates.sum(0))
    n = tp.n_data
    return E * torch.sum(counts / (ids.numel() * n) *
                         (probs / (gates.shape[0] * n)))


def moe_block(blk, x, cfg: ModelConfig, mesh=None,
              data_axes: Tuple[str, ...] = ("data",), norm_topk: bool = True,
              impl: str = "auto", tp: Optional[TensorParallel] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss, an fp32 scalar).  ``impl``
    "dense", or "auto" with no mesh: the dropless dispatch (the reference's
    dense mode); "capacity", or "auto" under a mesh: the capacity path.
    Under ``mesh`` (its batch over ``data_axes``) ``x`` and ``out`` are
    this rank's data shard and ``blk`` holds its shards of the weights;
    ``tp``, the forward's plan where the layer passes it.  The shared
    experts, where the configuration has them, are one MLP of width
    ``n_shared_experts * d_expert`` added to every token."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    if tp is None:
        tp = LOCAL if mesh is None else TensorParallel(
            cfg, mesh, ShardingRules(data_axes=tuple(data_axes)))
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    gates, _ = router_probs(xf, blk["router"])
    if impl == "dense" or (impl == "auto" and not tp.on):
        w, ids = _top_k(gates, k, norm_topk)
        full = dict(blk)
        for name, dim in (("we_in", 2), ("we_gate", 2), ("we_out", 1)):
            if name in blk:
                w_e = tp.gather(blk[name], 0, "model") \
                    if blk[name].shape[0] < E else blk[name]
                full[name] = tp.gather(w_e, dim, "model") \
                    if w_e.shape[dim] < cfg.d_expert else w_e
        out = _dropless(cfg, full, xf, w, ids)
        aux = _global_aux(gates, ids, E, tp) if tp.on else \
            aux_losses(gates, ids, E)
    elif impl in ("auto", "capacity"):
        C = _capacity(T, k, E, cfg.capacity_factor)
        ep = blk["we_in"].shape[0] < E
        split = ep or blk["we_in"].shape[-1] < cfg.d_expert
        xm, gm = (tp.enter(xf), tp.enter(gates)) if split else (xf, gates)
        xe, table, wtable = _dispatch_local(xm, gm, k, C, norm_topk)
        if ep:    # this rank's experts' slice of the dispatch tables
            n = blk["we_in"].shape[0]
            own = slice(tp.r * n, (tp.r + 1) * n)
            xe, table, wtable = xe[own], table[own], wtable[own]
        out = _combine_local(_expert_ffn(cfg, blk, xe), table, wtable, T, d)
        if split:
            out = tp.reduce(out)
        ids = torch.topk(gates, k, dim=-1, sorted=True)[1]
        aux = tp.shard0(aux_losses(gates, ids, E))
    else:
        raise ValueError(f"moe_block: impl {impl!r} is not auto, dense or "
                         "capacity")
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp(blk, x, cfg, tp, prefix="shared_")
    return out, aux
