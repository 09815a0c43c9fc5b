"""Top-level model API for the ported families (the dense decoder, moe,
ssm, hybrid and the encoder): the port of ``repro.models.model.Model`` on
the serving and training paths.

    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    logits = model.forward(params, {"tokens": toks})           # [B, T, V]
    logits, aux = model.forward_with_aux(params, {"tokens": toks})
    loss, metrics = model.loss(params, {"tokens": toks, "labels": labels})
    pools = model.init_paged_caches(num_pages, page_size)
    logits = model.prefill_chunk(params, {"tokens": chunk}, pools, start,
                                 new_len, page_table=row)      # [B, V]
    logits = model.prefill_chunk(params, {"tokens": chunk}, staging,
                                 start, new_len)  # dense, exact length
    logits = model.decode_paged(params, tokens, pools, table, cache_len)
    logits = model.verify_paged(params, block, pools, table, cache_len)
    caches = model.init_caches(batch, max_seq)                 # dense
    logits, cache_len = model.prefill(params, {"tokens": toks}, caches,
                                      last_index)
    logits = model.decode(params, tokens, caches, cache_len)

Inputs per frontend, as in JAX: ``none`` and ``vq_tokens`` (chameleon's
VQ image tokens, already ids in the shared vocabulary: JAX
``model.py:12``) take ``batch["tokens"]`` (and ``labels``);
``audio_frames`` (the encoders) takes ``batch["features"]``
[B, T, F], ``targets`` [B, T] and an optional ``mask`` [B, T] (HuBERT's
masked prediction: masked frames read ``mask_embed``).

Params are nested dicts of tensors with the JAX leaf names and stacked
``[L, ...]`` block leaves.  Pools, caches and SSM states update in place.
Paged pools and speculative verify are the dense family's only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.layers import (F32_LEAVES, MetaGenerator,
                                       apply_embedding, apply_lm_head,
                                       dense_init, init_embedding,
                                       init_lm_head)

Params = Dict[str, Any]


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every floating leaf in ``dtype``, but the SSM leaves and the MoE
    router kept in f32 (``layers.F32_LEAVES``).  Every use of any other
    weight casts it to the compute dtype first (``w.to(cdtype)``), so
    casting the tree once gives the same numbers without a cast per
    call."""
    if isinstance(params, dict):
        return {k: v if k in F32_LEAVES else cast_params(v, dtype)
                for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> Params:
        """Random parameters with ``dense_init``/``embed_init``'s
        distributions, drawn on the generator's device and moved to the
        model's.  The numbers differ from JAX's for the same seed."""
        return to_device(self._init(gen), self.device)

    def init_abstract(self) -> Params:
        """The parameter tree as ``meta`` tensors (shapes and dtypes, no
        storage), as the JAX ``init_abstract`` gives it."""
        return self._init(MetaGenerator())

    def _init(self, gen) -> Params:
        cfg = self.cfg
        p: Params = {"embed": init_embedding(gen, cfg),
                     "stack": transformer.init_stack(gen, cfg)}
        head = init_lm_head(gen, cfg)
        if head is not None:
            p["head"] = head
        if cfg.frontend == "audio_frames":
            p["frontend"] = {
                "w_frontend": dense_init(gen, (cfg.frontend_dim,
                                               cfg.d_model), cfg.pdtype),
                "mask_embed": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                          device=gen.device)}
        return p

    def unread_leaves(self) -> tuple:
        """The paths (``tree.flatten_with_path`` form) of the leaves that
        ``init`` makes and no forward reads: an ``audio_frames`` encoder's
        token embedding, kept because the JAX ``Model.init`` makes it too
        (``src/repro/models/model.py:41-44``).  Their gradient is zero,
        as ``jax.grad`` gives it, and AdamW still decays them."""
        if self.cfg.frontend == "audio_frames":
            return ("['embed']['embedding']",)
        return ()

    def _positions(self, B: int, T: int, start=None):
        pos = torch.arange(T, device=self.device, dtype=torch.int32)[None]
        return pos.expand(B, T) if start is None else start[:, None] + pos

    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor]):
        """[B, T, d] in the compute dtype: the features' projection for
        ``audio_frames`` (``mask_embed`` in the frames ``batch["mask"]``
        sets), else the token embedding."""
        cfg = self.cfg
        if cfg.frontend == "audio_frames":
            dt = cfg.cdtype
            x = batch["features"].to(dt) @ \
                params["frontend"]["w_frontend"].to(dt)
            if "mask" in batch:
                me = params["frontend"]["mask_embed"].to(dt)
                x = torch.where(batch["mask"].bool()[..., None], me, x)
            return x
        return apply_embedding(params["embed"], batch["tokens"], cfg)

    # ------------------------------------------------------------------ fwd
    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                positions: Optional[torch.Tensor] = None):
        """Full-sequence logits [B, T, V] (the train-mode forward; an
        encoder's is its serving forward too, non-causal)."""
        return self._forward(params, batch, positions)[0]

    def forward_with_aux(self, params: Params,
                         batch: Dict[str, torch.Tensor],
                         positions: Optional[torch.Tensor] = None):
        """(logits [B, T, V], aux): the JAX ``Model.forward``'s pair, with
        ``aux`` the moe layers' weighted load-balancing losses summed (an
        f32 scalar; zero for the other families)."""
        logits, aux = self._forward(params, batch, positions)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, aux

    def _forward(self, params, batch, positions):
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        B, T = x.shape[:2]
        if positions is None:
            positions = self._positions(B, T)
        x, aux = transformer.forward_stack(params["stack"], x, cfg,
                                           positions=positions, mode="train")
        return apply_lm_head(params["embed"], params.get("head"), x,
                             cfg), aux

    # ----------------------------------------------------------------- loss
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """The train objective: mean next-token cross-entropy over labels
        ``>= 0`` (a label below 0 has weight 0 and is read as 0), or for an
        encoder the cross-entropy of ``targets`` weighted by ``mask`` (all
        frames without one), with the log-sum-exp of the logits in f32 and
        the gold logit taken in the logits' dtype (a gather, the same
        number as JAX's one-hot contraction), over ``max(Σ weights, 1)``,
        plus the moe layers' auxiliary loss.  Returns ``(loss, metrics)``
        with metrics ``loss``, ``ce``, ``aux`` and ``tokens``.

        Under a mesh's rules the batch is this rank's rows and the logits
        its vocabulary columns: the log-sum-exp and the gold logit are
        reduced over ``model``, the token count over the batch axes, and
        ``loss`` is this rank's share of the global loss (the shares over
        the batch axes sum to it; the metrics are the global values)."""
        logits, aux = self.forward_with_aux(params, batch)
        if self.cfg.encoder_only:
            targets = batch["targets"].long()
            mask = batch.get("mask")
            weights = torch.ones_like(targets, dtype=torch.float32) \
                if mask is None else mask.float()
        else:
            labels = batch["labels"].long()
            weights = (labels >= 0).float()
            targets = torch.clamp(labels, min=0)
        lse, gold = _lse_and_gold(logits, targets, self.cfg)
        nll = (lse - gold) * weights
        tokens = weights.sum()
        dpg = spmd.dp_group()
        if dpg is None:
            ce = nll.sum() / torch.clamp(tokens, min=1.0)
            loss = ce + aux
            return loss, {"loss": loss, "ce": ce, "aux": aux,
                          "tokens": tokens}
        tokens = spmd.all_reduce(tokens, dpg)
        ce = nll.sum() / torch.clamp(tokens, min=1.0)
        loss = ce + aux
        metrics = {k: spmd.all_reduce(v, dpg)
                   for k, v in (("loss", loss), ("ce", ce), ("aux", aux))}
        return loss, {**metrics, "tokens": tokens}

    # -------------------------------------------------------------- serving
    def init_paged_caches(self, num_pages: int, page_size: int,
                          dtype=torch.bfloat16) -> Params:
        return transformer.init_paged_cache_tree(self.cfg, num_pages,
                                                 page_size, dtype,
                                                 self.device)

    def prefill_chunk(self, params: Params, batch: Dict[str, torch.Tensor],
                      caches: Params, start: torch.Tensor,
                      new_len: torch.Tensor,
                      page_table: Optional[torch.Tensor] = None):
        """Prefill ONE chunk ``batch["tokens"]`` [B, C] whose first token
        sits at ``start`` [B]; ``new_len`` [B] is the valid prompt length
        after it.  With ``page_table`` the chunk (right-padded to a bucket)
        lands in the table's pages; without it the chunk is exact-length
        and resumes a dense staging cache (attention over the cached
        prefix; SSM layers resume their conv and SSM state).  Returns
        last-valid-token logits [B, V]."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        B, T = x.shape[:2]
        positions = self._positions(B, T, start)
        x, _ = transformer.forward_stack(
            params["stack"], x, cfg, positions=positions, mode="prefill",
            caches=caches, cache_len=new_len, page_table=page_table,
            chunked=True)
        local_last = torch.clamp(new_len - start - 1, min=0).long()
        last = x[torch.arange(B, device=x.device), local_last]
        logits = apply_lm_head(params["embed"], params.get("head"),
                               last[:, None], cfg)
        return logits[:, 0]

    def decode_paged(self, params: Params, tokens: torch.Tensor,
                     caches: Params, page_table: torch.Tensor,
                     cache_len: torch.Tensor):
        """One decode step: tokens [B] → logits [B, V]; the new token's KV
        is appended at ``cache_len`` through the page table."""
        cfg = self.cfg
        x = apply_embedding(params["embed"], tokens[:, None], cfg)
        x, _ = transformer.forward_stack(
            params["stack"], x, cfg, positions=None, mode="decode",
            caches=caches, cache_len=cache_len, page_table=page_table)
        logits = apply_lm_head(params["embed"], params.get("head"), x, cfg)
        return logits[:, 0]

    def verify_paged(self, params: Params, tokens: torch.Tensor,
                     caches: Params, page_table: torch.Tensor,
                     cache_len: torch.Tensor):
        """Speculative verify step: tokens [B, K1] (the last committed
        token and the draft's proposals) → logits [B, K1, V].  All K1
        tokens' KV is appended at ``cache_len .. cache_len+K1-1``; the
        caller winds ``cache_len`` back past a rejected suffix."""
        cfg = self.cfg
        x = apply_embedding(params["embed"], tokens, cfg)
        x, _ = transformer.forward_stack(
            params["stack"], x, cfg, positions=None, mode="verify",
            caches=caches, cache_len=cache_len, page_table=page_table)
        return apply_lm_head(params["embed"], params.get("head"), x, cfg)

    def init_caches(self, batch: int, max_seq: int,
                    dtype=torch.bfloat16) -> Params:
        """Dense caches (``transformer.init_cache_tree``): the draft's and
        the dense slot plane's slot tree, and the staging cache."""
        return transformer.init_cache_tree(self.cfg, batch, max_seq, dtype,
                                           self.device)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                caches: Params, last_index: Optional[torch.Tensor] = None):
        """Fill dense caches with a prompt [B, T] from position 0.  With
        ``last_index`` [B] (the position of each row's last real token)
        the prompt is right-padded to a bucket, which only full attention
        may be; without it every row is exact-length.  Returns (the last
        token's logits [B, V], cache_len [B])."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        B, T = x.shape[:2]
        x, _ = transformer.forward_stack(params["stack"], x, cfg,
                                         positions=self._positions(B, T),
                                         mode="prefill", caches=caches)
        if last_index is None:
            last_index = torch.full((B,), T - 1, dtype=torch.int32,
                                    device=x.device)
        last = x[torch.arange(B, device=x.device), last_index.long()]
        logits = apply_lm_head(params["embed"], params.get("head"),
                               last[:, None], cfg)
        return logits[:, 0], last_index + 1

    def decode(self, params: Params, tokens: torch.Tensor, caches: Params,
               cache_len: torch.Tensor):
        """One decode step over dense caches: tokens [B] → logits [B, V];
        the new token's KV is written at ``cache_len``."""
        cfg = self.cfg
        x = apply_embedding(params["embed"], tokens[:, None], cfg)
        x, _ = transformer.forward_stack(
            params["stack"], x, cfg, positions=None, mode="decode",
            caches=caches, cache_len=cache_len)
        logits = apply_lm_head(params["embed"], params.get("head"), x, cfg)
        return logits[:, 0]


def _lse_and_gold(logits, targets, cfg: ModelConfig):
    """The f32 log-sum-exp of the logits over the vocabulary and each
    target's logit (gathered in the logits' dtype).  Over a vocabulary
    sharded on ``model``: the max and the sum of exponentials reduced
    across the axis, and the gold logit from the rank that holds it."""
    group, _, r = spmd.model_split("vocab", cfg.vocab_size)
    if group is None:
        lse = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return lse, gold.float()
    lf = logits.float()
    m = spmd.all_reduce(lf.amax(dim=-1, keepdim=True), group,
                        torch.distributed.ReduceOp.MAX)
    lse = m[..., 0] + torch.log(spmd.reduce_from(
        torch.exp(lf - m).sum(dim=-1), group))
    v_loc = logits.shape[-1]
    t = targets - r * v_loc
    ok = (t >= 0) & (t < v_loc)
    g = torch.gather(logits, -1, torch.clamp(t, 0, v_loc - 1)[..., None])
    gold = spmd.reduce_from(torch.where(ok, g[..., 0],
                                        torch.zeros_like(g[..., 0])), group)
    return lse, gold.float()


def to_device(tree, device):
    """A params tree with every leaf on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
