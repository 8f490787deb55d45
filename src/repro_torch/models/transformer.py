"""The decoder's forward pass: the port's ``repro.models.transformer``
(``Runtime``, ``mlp``, ``layer_windows``, ``_std_layer`` with GQA or MLA
attention, hymba's SSD branch beside it (``_ssm_branch``), an MLP or the
MoE block and whisper's cross block, ``_rwkv_layer``, ``init_cache`` for
the k/v cache, MLA's latent cache, RWKV6's recurrent state and hymba's SSM
state, and ``forward`` with pixtral's stub patch prefix, whisper's encoder
and deepseek's leading dense layers) for the architectures
``configs.ARCHS`` lists.

Modes: "train" (causal, no cache, logits for every position), "prefill"
(fills the cache from position 0 and keeps only the last position's
logits), "decode" (one token per row against the cache, ``cache_pos`` a
scalar or a (B,) vector of per-row depths).  The layers are stacked along
a leading axis as in the reference; a Python loop over them takes the
place of ``lax.scan``.  The cache is written in place and returned.  A
training forward (mode "train", grad on) with ``cfg.remat`` runs each
layer under ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
of its scan body: a layer's activations and compute-type weights are
recomputed in the backward, its kernels launched again.

The reference's dtype sequence is kept: embeddings and each layer's
matrices in ``cfg.dtype``, the norms and ``rope`` in fp32 and cast back.

Under a mesh (``Runtime(mesh=, rules=)``, ``models.sharding``) each rank
holds its shards of the parameters and of the cache and runs its data
shard of the batch: a vocab-parallel embedding and head, column- and
row-parallel MLPs and attention on the rank's heads (whisper's encoder and
cross-attention too), RWKV6's time mix and hymba's SSD heads on the rank's
heads with their recurrent states, the MoE block on its experts, FSDP
weights gathered a layer at a time, and under sequence parallelism the
residual stream split along the sequence between blocks.

One difference from the reference, on RWKV6 and on hymba's SSD heads: a
prefill from position 0 starts from a zero recurrent state (and RWKV6 from
zero token shifts), whatever the cache holds.  The reference starts it from
the state in the cache, so a request prefilled into a reused engine slot
continues its previous occupant's state (ROADMAP Queue 3).  More tokens
than one at a nonzero position (a chunked prefill) carry the cache's state
on RWKV6 and on hymba's SSD heads, as the reference does, RWKV6's token
shifts restarting from zeros as the reference's do; the attention layers
attend from that position over the cache (``models.attention``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .attention import (_is_prefill, _proj, _rms, attention_block,
                        kv_heads_for, mla_attention_block)
from .config import ModelConfig
from .linear_scan import chunked_linear_attention, linear_attention_step
from .moe import _act, mlp, moe_block  # noqa: F401  (_act: read from here)
from .params import _dtype
from .sharding import LOCAL, ShardingRules, TensorParallel


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through the forward pass, the
    reference's.  ``mesh``: None (one rank), or a ``DeviceMesh`` of
    ("data", "model") or ("pod", "data", "model") axes over which
    ``forward`` runs on local shards (``models.sharding``), laid out by
    ``rules``.  ``mla_absorb``: MLA's attention in the latent space
    (``mla_attention_block(absorb=True)``, in every mode: train, prefill,
    chunked prefill and decode), as the reference's flag runs it.
    ``moe_impl``: "auto" (the capacity path under a mesh, the dropless
    dispatch without) or "dense" (dropless)."""

    mesh: Optional[object] = None
    rules: ShardingRules = dataclasses.field(default_factory=ShardingRules)
    mla_absorb: bool = False
    moe_impl: str = "auto"

    @property
    def data_axes(self):
        return self.rules.data_axes


def tensor_parallel(cfg: ModelConfig, rt: Runtime,
                    seq: int = 0) -> TensorParallel:
    """The plan of a call of ``seq`` positions under ``rt``'s mesh
    (``LOCAL`` without one)."""
    if rt.mesh is None:
        return LOCAL
    return TensorParallel(cfg, rt.mesh, rt.rules, seq=seq)


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full attention)."""
    return np.array([0 if cfg.layer_is_global(i) else cfg.window
                     for i in range(cfg.n_layers)], np.int32)


def _ssm_branch(blk, xn, cfg, *, cache, cache_pos,
                tp: TensorParallel = LOCAL):
    """Hymba's SSD heads on the layer's normed input: the softplus step
    ``dt``, the decay ``A dt`` (``A = -exp(A_log)``, one a head, broadcast
    over the state's N channels), ``k = B dt``, the post-update chunked
    recurrence read by C (the kernel's SSD variant), the ``D`` skip, the
    branch's norm and ``ws_out``.  With a cache: a prefill (``cache_pos``
    0) starts from a zero state, one token elsewhere takes the decode step
    against the cache's state (as does a one-token prompt, from zeros), and
    the cache's ``"ssm"`` is overwritten in place.

    Under a model axis whose size divides the heads (``tp``) the branch
    runs on the rank's heads (the shards of its head leaves; the cache's
    ``"ssm"`` holds those heads), the norm's RMS over all ``H * P``
    channels from the ranks' sums of squares all-reduced, and ``ws_out``
    row-parallel, its partial products all-reduced.  Where the heads do
    not divide it the leaves reach the branch whole and every rank runs all
    heads."""
    B, S, _ = xn.shape
    N, P = cfg.ssm_state, cfg.head_dim
    H = blk["ws_dt"].shape[-1]                 # this rank's heads
    split = H < cfg.n_heads
    f32 = torch.float32
    xi = tp.enter(xn) if split else xn
    xp = _proj(xi, blk["ws_in"]).reshape(B, S, H, P)
    dt = F.softplus(_proj(xi, blk["ws_dt"]).to(f32) +
                    blk["dt_bias"].to(f32))                      # (B, S, H)
    Bm = _proj(xi, blk["ws_B"]).reshape(B, S, H, N)
    Cm = _proj(xi, blk["ws_C"]).reshape(B, S, H, N)
    A = -torch.exp(blk["A_log"].to(f32))                         # (H,)
    logw = (dt * A)[..., None].expand(B, S, H, N).contiguous()
    k = Bm.to(f32) * dt[..., None]
    fresh = cache is None or _is_prefill(cache_pos)
    if cache is not None and S == 1:
        state0 = torch.zeros_like(cache["ssm"]) if fresh else cache["ssm"]
        y, state = linear_attention_step(Cm[:, 0], k[:, 0], xp[:, 0],
                                         logw[:, 0], state0,
                                         post_update=True)
        y = y[:, None]
    else:
        y, state = chunked_linear_attention(
            Cm, k, xp, logw, post_update=True, chunk=cfg.scan_chunk,
            initial_state=None if fresh else cache["ssm"])
    y = y + blk["ssm_D"].to(f32)[:, None] * xp.to(f32)
    y = y.reshape(B, S, H * P).to(xn.dtype)
    if cache is not None:
        cache["ssm"].copy_(state)
    # the norm's mean square over all H * P channels: split, from every
    # rank's sum; each rank uses the sum on its own channels, so its
    # gradient sums over "model" too
    y32 = y.to(f32)
    ss = (y32 * y32).sum(-1, keepdim=True)
    scale = blk["ssm_norm"]
    if split:
        ss = tp.enter(tp.reduce(ss))
        scale = tp.enter(scale).narrow(0, tp.r * H * P, H * P)
    y = (y32 * torch.rsqrt(ss / (cfg.n_heads * P) + cfg.norm_eps)
         * scale.to(f32)).to(xn.dtype)
    out = _proj(y, blk["ws_out"])
    return tp.reduce(out) if split else out


def _std_layer(blk, x, cfg, rt: Runtime, *, positions, window, cache,
               cache_pos, cross_kv=None, tp: TensorParallel = LOCAL):
    """Attention (GQA, or MLA where ``cfg.mla``), mean-combined with the
    SSD branch where ``cfg.ssm`` (hymba's parallel heads), and an MLP, or
    the MoE block where the layer has a router; with ``cross_kv`` (the
    encoder's output) a cross-attention block between them.  Returns (x,
    the cache, the layer's aux loss: 0 without MoE).  Under sequence
    parallelism (``tp.sp``) ``x`` is this rank's slice of the sequence:
    each block reads it gathered and its output is split again."""
    xn = _rms(tp.seq_gather(x), blk["ln1"], cfg.norm_eps)
    if cfg.mla:
        attn, new_cache = mla_attention_block(
            blk, xn, cfg, positions=positions, cache=cache,
            cache_pos=cache_pos, absorb=rt.mla_absorb, tp=tp)
    else:
        attn, new_cache = attention_block(blk, xn, cfg, positions=positions,
                                          window=window, cache=cache,
                                          cache_pos=cache_pos, tp=tp)
    if cfg.ssm:
        attn = (attn + _ssm_branch(blk, xn, cfg, cache=cache,
                                   cache_pos=cache_pos, tp=tp)) * 0.5
    x = x + tp.seq_split(attn)
    if cross_kv is not None:
        xx = _rms(tp.seq_gather(x), blk["ln_x"], cfg.norm_eps)
        xo, _ = attention_block(blk, xx, cfg, positions=positions, window=0,
                                cross_states=cross_kv, prefix="x_", tp=tp)
        x = x + tp.seq_split(xo)
    xn2 = _rms(tp.seq_gather(x), blk["ln2"], cfg.norm_eps)
    if "router" in blk:
        # the reference keys the unnormalised top-k on the full model's name
        out, aux = moe_block(blk, xn2, cfg, mesh=rt.mesh,
                             data_axes=rt.data_axes,
                             norm_topk=cfg.name != "deepseek-v2-lite-16b",
                             impl=rt.moe_impl, tp=tp)
    else:
        out, aux = mlp(blk, xn2, cfg, tp), None
    return x + tp.seq_split(out), new_cache, aux


def _enc_layer(blk, h, cfg, tp: TensorParallel = LOCAL):
    """Whisper's encoder layer: bidirectional self-attention, written as
    cross-attention onto the layer's own normed input (the reference's
    form; the positional signal comes from the stub frontend), then the
    MLP; under a model axis each on the rank's heads and hidden columns,
    the whole frame sequence on every rank."""
    hn = _rms(h, blk["ln1"], cfg.norm_eps)
    a, _ = attention_block(blk, hn, cfg, positions=None, window=0,
                           cross_states=hn, tp=tp)
    h = h + a
    return h + mlp(blk, _rms(h, blk["ln2"], cfg.norm_eps), cfg, tp)


def _layer(stack, i, cdt, tp: TensorParallel = LOCAL, name="layers"):
    """Layer ``i`` of the stacked dict ``stack`` (the parameters'
    ``name``), its matrices in the compute type, as the reference's scan
    body casts its layer slice; each leaf then as its block computes on
    it (``TensorParallel.weight``: FSDP shards gathered after the cast)."""
    return {k: tp.weight(w[i].to(cdt) if w.dim() >= 3 and
                         w.is_floating_point() else w[i], name, k, drop=1)
            for k, w in stack.items()}


def _shifted(x):
    """x moved one position later along S, zeros first: each position's
    previous token (the token shift from a fresh start)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _rwkv_layer(blk, x, cfg, *, cache, cache_pos,
                tp: TensorParallel = LOCAL):
    """RWKV6 time mix (the chunked kernel over the sequence, or one decode
    step against the cached state) and relu^2 channel mix, each with its
    token shift.  With a cache: ``cache_pos`` 0 (a prefill) starts from a
    zero state and zero shifts, through the kernel for any S; one token at
    a nonzero position (scalar or per row) takes the decode step; more
    tokens there (a chunked prefill) run the kernel from the cache's state,
    their shifts restarting from zeros as the reference's do; the cache's
    state and shifts are overwritten in place.

    Under a model axis whose size divides the heads (``tp``) the time mix
    runs on the rank's heads: ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` and
    ``decay_b`` column-parallel, ``decay_base``, ``bonus_u`` and
    ``gn_scale`` the rank's slices, the cache's state those heads', and
    ``wo`` row-parallel, its partial products all-reduced; the channel mix
    is the MLP's split.  The token shifts, ``decay_a`` and its ``tanh``
    stay whole on every rank.  Under sequence parallelism each mix reads
    the sequence gathered (a shift sees the previous rank's last token)
    and its output is split again."""
    B = x.shape[0]
    K = cfg.head_dim
    H = blk["w_r"].shape[-1] // K              # this rank's heads
    split = H < cfg.n_heads
    xn = _rms(tp.seq_gather(x), blk["ln1"], cfg.norm_eps)
    S = xn.shape[1]
    carried = cache is not None and not _is_prefill(cache_pos)
    step = carried and S == 1
    prev = cache["shift_a"][:, None, :].to(xn.dtype) if step else \
        _shifted(xn)

    def lerp(m):
        return xn + (prev - xn) * blk[m].to(xn.dtype)

    def cols(t):
        """``t`` as the input of a product on the rank's columns."""
        return tp.enter(t) if split else t

    r = _proj(cols(lerp("mix_r")), blk["w_r"]).reshape(B, S, H, K)
    k = _proj(cols(lerp("mix_k")), blk["w_k"]).reshape(B, S, H, K)
    v = _proj(cols(lerp("mix_v")), blk["w_v"]).reshape(B, S, H, K)
    g = F.silu(_proj(cols(lerp("mix_g")), blk["w_g"]))
    dec = cols(torch.tanh(_proj(lerp("mix_w"), blk["decay_a"]))) @ \
        blk["decay_b"].to(xn.dtype) + blk["decay_base"].to(xn.dtype)
    logw = -torch.exp(dec.float()).reshape(B, S, H, K)
    u = blk["bonus_u"].reshape(H, K)
    if step:
        y, state = linear_attention_step(r[:, 0], k[:, 0], v[:, 0],
                                         logw[:, 0], cache["state"], u=u)
        y = y[:, None]
    else:
        y, state = chunked_linear_attention(
            r, k, v, logw, u=u, chunk=cfg.scan_chunk,
            initial_state=cache["state"] if carried else None)
    # per-head group norm in fp32
    y32 = y.reshape(B, S, H, K).float()
    y = (y32 * torch.rsqrt((y32 * y32).mean(-1, keepdim=True)
                           + cfg.norm_eps)).reshape(B, S, H * K)
    y = y * blk["gn_scale"].float()
    out = _proj(y.to(x.dtype) * g, blk["wo"])
    x = x + tp.seq_split(tp.reduce(out) if split else out)

    # channel mix with token shift: relu^2, no gate (``mlp``'s split)
    xn2 = _rms(tp.seq_gather(x), blk["ln2"], cfg.norm_eps)
    prev2 = cache["shift_f"][:, None, :].to(xn2.dtype) if step else \
        _shifted(xn2)
    xf = xn2 + (prev2 - xn2) * blk["mix_f"].to(xn2.dtype)
    x = x + tp.seq_split(mlp(blk, xf, cfg, tp))
    if cache is not None:
        cache["state"].copy_(state)
        cache["shift_a"].copy_(xn[:, -1])
        cache["shift_f"].copy_(xn2[:, -1])
    return x


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda", mesh=None,
               rules: Optional[ShardingRules] = None) -> Dict:
    """Stacked (leading layer axis) decode cache, zeros, on ``device``:
    k/v of (batch, max_len) positions, or with ``cfg.kv_cache_int8`` their
    int8 ``k_q`` / ``v_q`` and fp32 scales ``k_s`` / ``v_s`` of one a
    (position, kv head), filled with ones as the reference's are (with SSM
    heads also their fp32 (H, N, hd) state ``"ssm"`` a row); MLA's latent
    ``lat`` of ``lora + r`` a position, in the compute type whatever
    ``kv_cache_int8`` says (the reference's MLA branch comes first); or
    RWKV6's fp32 (H, K, K) state and its two token shifts a row.  With
    leading dense layers (deepseek) the cache's first ``first_k_dense``
    rows are theirs.

    Under ``mesh`` (laid out by ``rules``): this rank's cache, the rows of
    its data shard of ``batch`` and the kv heads its query heads read
    (``attention.kv_heads_for``; all of them where its weights hold every
    head), and RWKV6's and the SSD's recurrent states of its heads where
    the model axis divides ``n_heads`` (whole where it does not).  The
    latent and the token shifts stay whole a row
    (``launch.specs.cache_placements``)."""
    from ..kernels.ops import resolve_device
    dev = resolve_device(device)
    dt = _dtype(cfg, dtype)
    L = cfg.n_layers
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if mesh is not None:
        tp = TensorParallel(cfg, mesh, rules or ShardingRules())
        if batch % tp.n_data:
            raise ValueError(f"a batch of {batch} does not split over "
                             f"{tp.n_data} data shards")
        batch //= tp.n_data
        if tp.m > 1 and cfg.n_heads % tp.m == 0:
            H //= tp.m
            KV = len(kv_heads_for(cfg.n_heads, KV, H, tp.r))
    if cfg.rwkv:
        hd = cfg.head_dim
        return {"state": torch.zeros((L, batch, H, hd, hd),
                                     dtype=torch.float32, device=dev),
                "shift_a": torch.zeros((L, batch, cfg.d_model), dtype=dt,
                                       device=dev),
                "shift_f": torch.zeros((L, batch, cfg.d_model), dtype=dt,
                                       device=dev)}
    if cfg.mla:
        lat = cfg.kv_lora_rank + cfg.rope_head_dim
        return {"lat": torch.zeros((L, batch, max_len, lat), dtype=dt,
                                   device=dev)}
    shape = (L, batch, max_len, KV, cfg.head_dim)
    if cfg.kv_cache_int8:
        i8, f32 = torch.int8, torch.float32
        cache = {"k_q": torch.zeros(shape, dtype=i8, device=dev),
                 "v_q": torch.zeros(shape, dtype=i8, device=dev),
                 "k_s": torch.ones(shape[:-1] + (1,), dtype=f32, device=dev),
                 "v_s": torch.ones(shape[:-1] + (1,), dtype=f32, device=dev)}
    else:
        cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.ssm:
        cache["ssm"] = torch.zeros((L, batch, H, cfg.ssm_state,
                                    cfg.head_dim), dtype=torch.float32,
                                   device=dev)
    return cache


def _embed(table, tokens, cfg: ModelConfig, tp: TensorParallel):
    """The rows of ``tokens``; from a vocab shard (this rank's
    ``table.shape[0]`` rows), the rows it holds, zeros elsewhere, summed
    over the model axis."""
    V = table.shape[0]
    if V == cfg.vocab:
        return table[tokens]
    idx = tokens.long() - tp.r * V
    own = ((idx >= 0) & (idx < V)).to(table.dtype)
    return tp.reduce(table[idx.clamp(0, V - 1)] * own[..., None])


def forward(params, cfg: ModelConfig, rt: Runtime, tokens: torch.Tensor, *,
            mode: str = "train", cache: Optional[Dict] = None,
            cache_pos=None, frontend_embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None):
    """tokens: (B, S) integer.  Returns (logits, cache or None, aux loss),
    as the reference does (the aux loss is the sum of the MoE layers',
    fp32; 0 without MoE).  Deepseek's ``dense_layers`` run before
    ``layers``, layer ``i`` of the whole stack reading cache row ``i``.

    ``frontend_embeds`` (B, n_front, d): pixtral's stub patch embeddings,
    prepended to the tokens' (positions run over ``n_front + S``, a prefill
    writes the cache from 0).  ``enc_embeds`` (B, Se, d): whisper's stub
    frame embeddings; the encoder stack runs over them, then ``enc_norm``,
    and every decoder layer cross-attends to the result.  With a cache the
    encoder's output is kept in it as ``"enc_out"``: a decode step without
    ``enc_embeds`` takes it from there (recomputing each layer's cross K/V
    from it, as the reference does) and puts it back.

    Under ``rt.mesh`` ``params`` and ``cache`` are this rank's shards
    (``sharding.shard_tree``, ``init_cache(mesh=)``) and the inputs the
    whole batch (``cache_pos`` a scalar or (B,)): each rank runs its data
    shard's rows, and the logits come back whole, vocab and batch gathered,
    on every rank."""
    S = tokens.shape[1] + (0 if frontend_embeds is None
                           else frontend_embeds.shape[1])
    tp = tensor_parallel(cfg, rt, S)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
        cache_pos = tp.split_batch(cache_pos)
    logits, cache, aux = forward_local(
        params, cfg, rt, tp.split_batch(tokens), mode=mode, cache=cache,
        cache_pos=cache_pos, frontend_embeds=tp.split_batch(frontend_embeds),
        enc_embeds=tp.split_batch(enc_embeds), tp=tp)
    if logits.shape[-1] < cfg.vocab:
        logits = tp.gather(logits, logits.dim() - 1, "model")
    return tp.gather(logits, 0, tp.data), cache, aux


def forward_local(params, cfg: ModelConfig, rt: Runtime,
                  tokens: torch.Tensor, *, mode: str = "train",
                  cache: Optional[Dict] = None, cache_pos=None,
                  frontend_embeds: Optional[torch.Tensor] = None,
                  enc_embeds: Optional[torch.Tensor] = None,
                  tp: TensorParallel = LOCAL):
    """``forward`` on this rank's data shard of the inputs: (logits of the
    shard, the cache, aux loss), the logits this rank's vocab shard where
    the head is vocab-parallel (``train_step.loss_fn`` takes the cross
    entropy across the shards)."""
    dev = tokens.device
    cdt = _dtype(cfg, None)
    x = _embed(tp.weight(params["embed"].to(cdt), "embed"), tokens, cfg, tp)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    x = tp.seq_split(x)
    if cache_pos is None:
        cache_pos = 0
    if isinstance(cache_pos, torch.Tensor):
        pos0 = cache_pos.to(device=dev, dtype=torch.int32)
        if pos0.dim() == 1:
            pos0 = pos0[:, None]   # per-slot depths (continuous batching)
    else:
        pos0 = int(cache_pos)   # a scalar: no copy to the card, no sync
    positions = pos0 + torch.arange(S, dtype=torch.int32, device=dev)[None, :] \
        + torch.zeros((B, 1), dtype=torch.int32, device=dev)
    cross_kv = cache.pop("enc_out", None) if cache is not None else None
    remat = cfg.remat and mode == "train" and cache is None and \
        torch.is_grad_enabled()

    def run(fn, *args):
        """One layer, under activation checkpointing where ``remat``."""
        if remat:
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    if cfg.arch_kind == "encdec" and enc_embeds is not None:
        e = enc_embeds.to(x.dtype)
        for i in range(cfg.n_enc_layers):
            e = run(lambda h, i=i: _enc_layer(
                _layer(params["enc_layers"], i, cdt, tp, "enc_layers"), h,
                cfg, tp), e)
        cross_kv = _rms(e, tp.weight(params["enc_norm"], "enc_norm"),
                        cfg.norm_eps)
    windows = layer_windows(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    fkd = cfg.first_k_dense

    def layer(h, i, ckv):
        blk = _layer(params["dense_layers"], i, cdt, tp, "dense_layers") \
            if i < fkd else _layer(params["layers"], i - fkd, cdt, tp)
        csl = None if cache is None else {k: c[i] for k, c in cache.items()}
        if cfg.rwkv:
            return _rwkv_layer(blk, h, cfg, cache=csl,
                               cache_pos=cache_pos, tp=tp), None
        h, _, aux = _std_layer(blk, h, cfg, rt, positions=positions,
                               window=int(windows[i]), cache=csl,
                               cache_pos=cache_pos, cross_kv=ckv, tp=tp)
        return h, aux

    for i in range(cfg.n_layers):
        x, aux = run(layer, x, i, cross_kv)
        if aux is not None:
            aux_total = aux_total + aux
    x = tp.seq_gather(x)
    if mode == "prefill":
        x = x[:, -1:]   # serving needs only the next token's logits
    x = _rms(x, tp.weight(params["final_norm"], "final_norm"), cfg.norm_eps)
    head = tp.weight(params["embed"], "embed").T if cfg.tie_embeddings \
        else tp.weight(params["lm_head"], "lm_head")
    if head.shape[-1] < cfg.vocab:     # vocab-parallel: this rank's columns
        x = tp.enter(x)
    logits = x @ head.to(x.dtype)
    if cache is not None and cross_kv is not None:
        cache["enc_out"] = cross_kv
    return logits, cache, aux_total
