"""Top-level model API for the ported families (the dense decoder, ssm
and hybrid): the port of ``repro.models.model.Model`` on the serving and
training paths.

    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    logits = model.forward(params, {"tokens": toks})           # [B, T, V]
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

Params are nested dicts of tensors with the JAX leaf names and stacked
``[L, ...]`` block leaves.  Pools, caches and SSM states update in place.
Paged pools and speculative verify are the dense family's only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.mamba2 import F32_LEAVES
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.layers import (apply_embedding, apply_lm_head,
                                       init_embedding, init_lm_head)

Params = Dict[str, Any]


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every floating leaf in ``dtype``, but the SSM leaves kept in f32
    (``mamba2.F32_LEAVES``).  Every use of any other weight casts it to
    the compute dtype first (``w.to(cdtype)``), so casting the tree once
    gives the same numbers without a cast per call."""
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
        cfg = self.cfg
        p: Params = {"embed": init_embedding(gen, cfg),
                     "stack": transformer.init_stack(gen, cfg)}
        head = init_lm_head(gen, cfg)
        if head is not None:
            p["head"] = head
        return to_device(p, self.device)

    def _positions(self, B: int, T: int, start=None):
        pos = torch.arange(T, device=self.device, dtype=torch.int32)[None]
        return pos.expand(B, T) if start is None else start[:, None] + pos

    # ------------------------------------------------------------------ fwd
    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                positions: Optional[torch.Tensor] = None):
        """Full-sequence logits [B, T, V] (the train-mode forward)."""
        cfg = self.cfg
        x = apply_embedding(params["embed"], batch["tokens"], cfg)
        B, T = x.shape[:2]
        if positions is None:
            positions = self._positions(B, T)
        x = transformer.forward_stack(params["stack"], x, cfg,
                                      positions=positions, mode="train")
        return apply_lm_head(params["embed"], params.get("head"), x, cfg)

    # ----------------------------------------------------------------- loss
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """The train objective: mean next-token cross-entropy over labels
        ``>= 0`` (a label below 0 has weight 0 and is read as 0), with
        the log-sum-exp of the logits in f32 and the gold logit taken in
        the logits' dtype (a gather, the same number as JAX's one-hot
        contraction).  The dense family has no auxiliary loss.  Returns
        ``(loss, metrics)`` with metrics ``loss``, ``ce``, ``aux`` and
        ``tokens``."""
        logits = self.forward(params, batch)
        labels = batch["labels"].long()
        weights = (labels >= 0).float()
        targets = torch.clamp(labels, min=0)
        lse = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0].float()
        nll = (lse - gold) * weights
        tokens = weights.sum()
        ce = nll.sum() / torch.clamp(tokens, min=1.0)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": tokens}

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
        x = apply_embedding(params["embed"], batch["tokens"], cfg)
        B, T = x.shape[:2]
        positions = self._positions(B, T, start)
        x = transformer.forward_stack(
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
        x = transformer.forward_stack(
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
        x = transformer.forward_stack(
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
        x = apply_embedding(params["embed"], batch["tokens"], cfg)
        B, T = x.shape[:2]
        x = transformer.forward_stack(params["stack"], x, cfg,
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
        x = transformer.forward_stack(
            params["stack"], x, cfg, positions=None, mode="decode",
            caches=caches, cache_len=cache_len)
        logits = apply_lm_head(params["embed"], params.get("head"), x, cfg)
        return logits[:, 0]


def to_device(tree, device):
    """A params tree with every leaf on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
