"""Continuous-time attention (port of ``easydgl_tpu.nn.temporal``):
``TiMultiHeadAttention`` (TiSASREC, reference src/module/temporal.py:15-105),
the Bochner time attentions ``TfMultiHeadAttention`` (TGAT, :108-184) and
``TgMultiHeadAttention`` (TGREC, :187-264), and the self-modulating
``MAU``, ``BiMAU`` and ``MGAU`` (reference temporal.py:267-508).

``TiMultiHeadAttention``: the logits get two additive relative terms,
``q . k_pos`` and ``q . k_int`` (the interval codes), before the
1/sqrt(dh) scale; the values get the matching ``v_pos`` and ``v_int``
terms. The key mask is ``sign(sum_c |keys|)`` (temporal.py:65), not
MultiHeadAttention's ``sign(|sum_c keys|)``; after the softmax a query
mask ``sign(sum_c |queries|)`` zeroes the padded query rows
(temporal.py:84-88), before the dropout. Two exact forms of the interval
terms: DENSE, the reference layout, takes the (B, Tq, Tk, C) codes;
FACTORED takes the (B, Tq, Tk) buckets and the extended (S+1, C) tables:
``q . T[bucket]`` is a gather from the per-query bucket projections
``q @ T^T`` (B, H, Tq, S+1), and ``sum_k p_k T_v[bucket_k]`` a bucket
segment-sum of the probabilities (``scatter_add``) times the table, so no
(Tq, Tk, C) tensor exists (the long-context form). Plain PyTorch: the JAX
module has no Pallas kernel.

The MAU family: a fourth projection T feeds a Hawkes-style intensity
head; the attention probabilities are modulated elementwise by the
per-(q, k) mark intensity.
``MAU`` (CTSMA's) projects its queries with ``q`` and its keys with ``k``,
``v`` and ``t``, causal by default; ``BiMAU`` (EasyDGL's) is bidirectional
with one fused Q|K|V|T projection and the intensity diagonal reset to 1;
``MGAU`` is the fused projection without the reset (no model uses it).

Two engines, chosen by ``intensity_impl`` (the models pick it with
``models.base.mau_impl``):

* ``"fused"``: ``kernels.mau_attention.mau_attention``, the whole chain in
  one kernel on the card, forward and backward (its plain version on the
  CPU); keys up to 128;
* ``"streamed"``: ``kernels.mau_streamed.mau_streamed``, the long-context
  two-sweep schedule and its two-pass backward, O(T * block) memory (JAX
  temporal.py:601-650): three forward and four backward kernels on the
  card, the blocked plain version with its custom backward
  (``kernels.mau_blocked``, blocks of ``block_k`` keys) on the CPU.

Gathered-query calls (``query_positions``, EasyDGL's ``gather_queries``)
are routed as JAX routes them: under ``"fused"`` to the fused kernel
(JAX temporal.py:652-685); under ``"streamed"`` to ``mau_dense``, a port
of JAX's materialised XLA chain (temporal.py:687-711), where JAX's
streamed and blocked engines let them fall through. That chain is no
Pallas kernel, so it is plain PyTorch here too; its (B, H, M, Tk) probs
are small, as M (the gathered rows) is, and it takes any number of keys,
where the fused kernels take at most 128.

The Bochner time attentions (JAX ``nn/temporal.py:144-435``) take the
learnable features ``cos(w (tq - tk) + phi)`` of the pairwise spans
(``nn.coding.TimeFunctionCoding``) in three forms, by ``impl`` and by what
the model passes:

* DENSE (``impl="xla"``, the reference layout): the (B, Tq, Tk, C) codes.
  TGAT adds ``q . code`` to the logits (beside ``q . k`` and ``q . k_pos``);
  TGREC projects the time-concatenated keys and values ``[keys, code]``
  (B, Tq, Tk, 2C) per query;
* FACTORED (``time_factors`` from ``TimeFunctionCoding.factors``): by angle
  addition each pairwise feature is ``cq ck + sq sk``. TGAT's logits become
  the augmented product ``[q, q, q cq, q sq] . [k, kp, ck, sk]``; TGREC's
  Dense over the concatenated key splits by linearity into the items part
  ``A = Dense([keys, 0])`` and the coding half ``W[C:]``, taken by basis
  application (``Dense(eye2) - Dense(0)``, so bf16 rounds as JAX's does),
  with the band ``k <= q + 1`` where the (tq - tk)+ clamp is inactive and
  ``coding(0)`` beyond it. No (Tq, Tk, C) tensor exists;
* FLASH (``impl="flash"`` with ``time_factors``): the augmented product
  through ``flash_context``, O(T) memory, scale 1/sqrt(dh) of the
  un-augmented head. TGAT passes v at its own width dh (the kernel takes a
  v narrower than q and k; JAX pads it to 4 dh, and the extra columns of
  the context are dropped); TGREC passes ``q~ = [q, u cq, u sq]``,
  ``k~ = v~ = [A, ck, sk]`` in fp32 (dh + 2C wide) and recombines the
  context per query. Rows that see no key take the dense form's uniform
  value: the mean of v (TGAT), the mean of ``v~`` and for TGREC's time part
  the clamped features' mean from prefix sums of ck and sk plus
  ``(Tk - q - 2)+`` copies of coding(0) (``tm_dead``).

Attention dropout (training) takes one seed per call, drawn from the step's
``torch.Generator`` (JAX: one int32 from the ``dropout`` rng,
temporal.py:652-685); both engines draw their mask from it with the same
Philox rule, and the backward redraws it from the same seed.
``mau_dense`` draws its mask from the generator itself (``nn.layers.
dropout``), as JAX's chain takes flax's ``nn.Dropout``.

Context parallelism (``dist/context.py``; a seq axis of cp > 1 or a
``LocalExchange``): ``MAU`` takes the two-sweep ring MAU before either
engine (JAX temporal.py:575-596), except for gathered-query calls, whose
rows are not sequence blocks; ``TfMultiHeadAttention`` in its factored
and flash forms runs the augmented product through ``cp_attention``
(ring or Ulysses by ``cp_impl``, JAX :194-212), the ring carrying the
augmented width 4 dh for q and k and dh for v.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from easydgl_tpu_torch.core.mesh import spmd_mesh
from easydgl_tpu_torch.dist.comm import data_total
from easydgl_tpu_torch.dist.context import (cp_attention, mau_ring_attention,
                                            seq_exchange)
from easydgl_tpu_torch.kernels.mau_attention import mau_attention
from easydgl_tpu_torch.kernels.mau_streamed import mau_streamed
from easydgl_tpu_torch.nn.attention import (NEG_INF_LOGIT, flash_context,
                                            masked_softmax, rows_that_see)
from easydgl_tpu_torch.nn.layers import (Dense, LastAxisLayerNorm, dropout,
                                         dropout_seed, einsum_fp32acc,
                                         merge_heads, mm_fp32acc, split_heads)


def _split_heads_4d(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, Tq, Tk, C) -> (B, H, Tq, Tk, C/H), channel-block head split."""
    b, tq, tk, c = x.shape
    return x.reshape(b, tq, tk, num_heads, c // num_heads).permute(
        0, 3, 1, 2, 4)


class TiMultiHeadAttention(nn.Module):
    """Time-interval-aware attention with the residual (reference
    temporal.py:15-105); parameters ``q``, ``k``, ``v`` (Dense, C to C)."""

    def __init__(self, num_units: int, num_heads: int,
                 dropout_rate: float = 0.0, *,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.q = Dense(num_units, num_units, **kw)
        self.k = Dense(num_units, num_units, **kw)
        self.v = Dense(num_units, num_units, **kw)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                k_pos: torch.Tensor, v_pos: torch.Tensor,
                k_int: Optional[torch.Tensor],
                v_int: Optional[torch.Tensor], *, causality: bool,
                generator: Optional[torch.Generator] = None,
                interval_buckets: Optional[torch.Tensor] = None,
                interval_tables: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                ) -> torch.Tensor:
        """queries, keys (B, T, C); k_pos, v_pos (B, T, C) position codes;
        k_int, v_int (B, Tq, Tk, C) interval codes (the dense form), or
        None with ``interval_buckets`` (B, Tq, Tk) in [0, S] and
        ``interval_tables`` (the extended (S+1, C) k and v tables; the
        factored form). ``generator``: the training step's (dropout); None
        at eval."""
        cdt = self.compute_dtype
        h = self.num_heads
        q = split_heads(self.q(queries), h)
        k = split_heads(self.k(keys), h)
        v = split_heads(self.v(keys), h)
        kp, vp = split_heads(k_pos, h), split_heads(v_pos, h)
        d = q.shape[-1]
        factored = interval_buckets is not None

        logits = (mm_fp32acc(q, k.transpose(-1, -2), cdt)
                  + mm_fp32acc(q, kp.transpose(-1, -2), cdt))
        if factored:
            tab_k, tab_v = interval_tables
            s_ext = tab_k.shape[0]
            q_tab = einsum_fp32acc("bhqd,shd->bhqs", q,
                                   tab_k.reshape(s_ext, h, d), cdt=cdt)
            idx = interval_buckets.long()[:, None].expand(
                *q_tab.shape[:3], interval_buckets.shape[-1])
            logits = logits + torch.gather(q_tab, -1, idx)
        else:
            logits = logits + einsum_fp32acc(
                "bhqkd,bhqd->bhqk", _split_heads_4d(k_int, h), q, cdt=cdt)
        logits = logits / d ** 0.5
        key_mask = torch.sign(keys.detach().abs().sum(-1))
        probs = masked_softmax(logits, key_mask, causality)
        query_mask = torch.sign(queries.detach().abs().sum(-1))
        probs = probs * query_mask[:, None, :, None]
        rate = self.dropout_rate if generator is not None else 0.0
        probs = dropout(probs, rate, generator)

        out = mm_fp32acc(probs, v, cdt) + mm_fp32acc(probs, vp, cdt)
        if factored:
            probsum = probs.new_zeros(*probs.shape[:3], s_ext).scatter_add(
                -1, idx, probs)
            out = out + einsum_fp32acc("bhqs,shd->bhqd", probsum,
                                       tab_v.reshape(s_ext, h, d), cdt=cdt)
        else:
            out = out + einsum_fp32acc(
                "bhqk,bhqkd->bhqd", probs, _split_heads_4d(v_int, h),
                cdt=cdt)
        return merge_heads(out) + queries


def _impl_of(name: str, impl: str) -> str:
    if impl not in ("xla", "factored", "flash"):
        raise ValueError(f"{name}: unknown impl {impl}")
    return impl


class TfMultiHeadAttention(nn.Module):
    """Functional-time-encoding attention with the residual (TGAT,
    reference temporal.py:108-184); parameters ``q``, ``k``, ``v`` (Dense,
    C to C). ``impl``: ``"flash"`` runs the factored form through the flash
    kernels; any other the materialised probs."""

    def __init__(self, num_units: int, num_heads: int,
                 dropout_rate: float = 0.0, *, impl: str = "xla",
                 cp_impl: str = "ring",
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.impl = _impl_of("TfMultiHeadAttention", impl)
        self.cp_impl = cp_impl
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.q = Dense(num_units, num_units, **kw)
        self.k = Dense(num_units, num_units, **kw)
        self.v = Dense(num_units, num_units, **kw)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                k_pos: torch.Tensor, k_int: Optional[torch.Tensor], *,
                causality: bool, generator: Optional[torch.Generator] = None,
                time_factors=None) -> torch.Tensor:
        """queries, keys (B, T, C); k_pos (B, T, C) position codes; k_int
        (B, Tq, Tk, C) time codes (the dense form), or None with
        ``time_factors`` (cq, sq, ck, sk), each (B, T, C). ``generator``:
        the training step's (dropout); None at eval."""
        cdt = self.compute_dtype
        h = self.num_heads
        q = split_heads(self.q(queries), h)
        k = split_heads(self.k(keys), h)
        v = split_heads(self.v(keys), h)
        kp = split_heads(k_pos, h)
        d = q.shape[-1]
        key_mask = torch.sign(keys.detach().abs().sum(-1))
        rate = self.dropout_rate if generator is not None else 0.0

        if time_factors is not None:
            cq, sq, ck, sk = (split_heads(f, h) for f in time_factors)
            qa = torch.cat([q, q, q * cq.to(q.dtype), q * sq.to(q.dtype)], -1)
            ka = torch.cat([k, kp, ck.to(k.dtype), sk.to(k.dtype)], -1)
            ex = seq_exchange()
            if ex is not None:
                ctx = cp_attention(self.cp_impl, qa, ka.to(qa.dtype), v,
                                   key_mask, ex, causal=causality,
                                   scale=d ** -0.5, dropout_rate=rate,
                                   generator=generator, compute_dtype=cdt)
                return merge_heads(ctx) + queries
            if self.impl == "flash":
                # one dtype for the kernels: the dense form rounds kp to
                # the compute dtype in its product too
                ctx = flash_context(qa, ka.to(qa.dtype), v, key_mask,
                                    causal=causality, rate=rate,
                                    generator=generator, scale=d ** -0.5)
                return merge_heads(ctx) + queries
            logits = mm_fp32acc(qa, ka.transpose(-1, -2), cdt)
        else:
            logits = (mm_fp32acc(q, k.transpose(-1, -2), cdt)
                      + mm_fp32acc(q, kp.transpose(-1, -2), cdt)
                      + einsum_fp32acc("bhqkd,bhqd->bhqk",
                                       _split_heads_4d(k_int, h), q, cdt=cdt))
        probs = masked_softmax(logits / d ** 0.5, key_mask, causality)
        probs = dropout(probs, rate, generator)
        return merge_heads(mm_fp32acc(probs, v, cdt)) + queries


class TgMultiHeadAttention(nn.Module):
    """Temporal-graph collaborative attention (TGREC, reference
    temporal.py:187-264): queries ``[x, coding(0)]``, per-(q, k) keys and
    values ``Dense([keys, coding(tq - tk)])``; output 2C wide, Dense
    ``merge`` (C to 2C) plus the 2C-wide query, then ``ln``
    (``LastAxisLayerNorm``). Parameters ``q``, ``k``, ``v`` (Dense, 2C to
    C), ``merge``, ``ln``."""

    def __init__(self, num_units: int, num_heads: int,
                 dropout_rate: float = 0.0, *, impl: str = "xla",
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_units = num_units
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.impl = _impl_of("TgMultiHeadAttention", impl)
        self.compute_dtype = compute_dtype
        c = num_units
        kw = dict(compute_dtype=compute_dtype, device=device)
        self.q = Dense(2 * c, c, **kw)
        self.k = Dense(2 * c, c, **kw)
        self.v = Dense(2 * c, c, **kw)
        self.merge = Dense(c, 2 * c, **kw)
        self.ln = LastAxisLayerNorm(2 * c, device=device)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                key_mask: torch.Tensor, q_time: torch.Tensor,
                k_time: Optional[torch.Tensor], *, causality: bool,
                generator: Optional[torch.Generator] = None,
                time_factors=None) -> torch.Tensor:
        """queries, keys (B, T, C); key_mask (B, Tk), nonzero where the key
        is real; q_time (B, Tq, 1, C) the coding at span 0; k_time (B, Tq,
        Tk, C) the codes of the clamped spans (the dense form), or None with
        ``time_factors`` (cq, sq, ck, sk), each (B, T, C). Returns
        (B, Tq, 2C)."""
        cdt = self.compute_dtype
        h = self.num_heads
        b, tq, c = queries.shape
        tk = keys.shape[1]
        rate = self.dropout_rate if generator is not None else 0.0
        q4 = torch.cat([queries[:, :, None, :], q_time], dim=-1)
        if time_factors is not None:
            out = self._factored(queries, keys, key_mask, q_time, q4,
                                 time_factors, causality, rate, generator)
        else:
            k4 = torch.cat([keys[:, None].expand(b, tq, tk, c), k_time], -1)
            q = _split_heads_4d(self.q(q4), h)         # (B, H, Tq, 1, d)
            k = _split_heads_4d(self.k(k4), h)         # (B, H, Tq, Tk, d)
            v = _split_heads_4d(self.v(k4), h)
            logits = einsum_fp32acc("bhqod,bhqkd->bhqk", q, k, cdt=cdt)
            probs = masked_softmax(logits / q.shape[-1] ** 0.5, key_mask,
                                   causality)
            probs = dropout(probs, rate, generator)
            out = merge_heads(einsum_fp32acc("bhqk,bhqkd->bhqd", probs, v,
                                             cdt=cdt))
        return self.ln(self.merge(out) + q4[:, :, 0, :])

    def _factored(self, queries, keys, key_mask, q_time, q4, factors,
                  causality, rate, generator):
        """The factored and flash forms (JAX temporal.py:300-411): the
        merged heads (B, Tq, C) before ``merge``."""
        cdt = self.compute_dtype
        h = self.num_heads
        b, tq, c = queries.shape
        tk = keys.shape[1]
        dh = c // h
        cq, sq, ck, sk = (f.float() for f in factors)
        q = _split_heads_4d(self.q(q4), h)[:, :, :, 0, :]   # (B, H, Tq, dh)
        zk = torch.cat([keys, torch.zeros_like(keys)], -1)
        ka, va = self.k(zk), self.v(zk)                     # (B, Tk, C)
        # the coding half W[C:] of the k and v kernels, by basis application
        eye2 = torch.cat([torch.zeros(c, c, device=keys.device),
                          torch.eye(c, device=keys.device)], -1).to(keys.dtype)
        zrow = keys.new_zeros(1, 2 * c)
        wk2 = (self.k(eye2) - self.k(zrow)).reshape(c, h, dh)
        wv2 = (self.v(eye2) - self.v(zrow)).reshape(c, h, dh)
        u = einsum_fp32acc("bhqd,chd->bhqc", q, wk2, cdt=cdt)  # (B, H, Tq, C)
        qt0 = q_time[:, :, 0, :].float()                     # coding(0)

        if self.impl == "flash":
            ckh = ck[:, None].expand(b, h, tk, c)
            skh = sk[:, None].expand(b, h, tk, c)
            qa = torch.cat([q.float(), u * cq[:, None], u * sq[:, None]], -1)
            kf = torch.cat([split_heads(ka, h).float(), ckh, skh], -1)
            vf = torch.cat([split_heads(va, h).float(), ckh, skh], -1)
            ctx = flash_context(qa, kf, vf, key_mask.float(),
                                causal=causality, rate=rate,
                                generator=generator, scale=dh ** -0.5,
                                spmd=False)
            out = ctx[..., :dh]
            tm = (cq[:, None] * ctx[..., dh:dh + c]
                  + sq[:, None] * ctx[..., dh + c:])
            # rows that see no key: the dense form's uniform mean of the
            # CLAMPED features, from prefix sums (k <= q + 1) plus
            # (Tk - q - 2)+ copies of coding(0)
            pos = torch.arange(tq, device=keys.device)
            upto = torch.clamp(pos + 1, max=tk - 1)
            pre_c = torch.cumsum(ck, dim=1)[:, upto]
            pre_s = torch.cumsum(sk, dim=1)[:, upto]
            nfut = torch.clamp(tk - 2 - pos, min=0).float()
            tm_dead = (cq * pre_c + sq * pre_s
                       + nfut[None, :, None] * qt0) / tk
            tm = torch.where(rows_that_see(key_mask.float(), causality), tm,
                             tm_dead[:, None])
            out = out + einsum_fp32acc("bhqc,chd->bhqd", tm, wv2, cdt=cdt)
            return merge_heads(out.to(queries.dtype))

        # the clamp (tq - tk)+ is inactive on the band k <= q + 1 (event
        # times are nondecreasing) and makes the feature coding(0) beyond
        band = (torch.arange(tk, device=keys.device)[None, :]
                <= torch.arange(tq, device=keys.device)[:, None] + 1)
        t_fact = (einsum_fp32acc("bhqc,bkc->bhqk", u * cq[:, None], ck,
                                 cdt=cdt)
                  + einsum_fp32acc("bhqc,bkc->bhqk", u * sq[:, None], sk,
                                   cdt=cdt))
        t_fut = einsum_fp32acc("bhqc,bqc->bhq", u, qt0, cdt=cdt)[..., None]
        logits = (einsum_fp32acc("bhqd,bhkd->bhqk", q, split_heads(ka, h),
                                 cdt=cdt)
                  + torch.where(band, t_fact, t_fut))
        probs = masked_softmax(logits / dh ** 0.5, key_mask, causality)
        probs = dropout(probs, rate, generator)
        out = einsum_fp32acc("bhqk,bhkd->bhqd", probs, split_heads(va, h),
                             cdt=cdt)
        pb = probs * band
        pc = einsum_fp32acc("bhqk,bkc->bhqc", pb, ck, cdt=cdt)
        ps = einsum_fp32acc("bhqk,bkc->bhqc", pb, sk, cdt=cdt)
        rest = (probs - pb).sum(-1)                 # the beyond-band mass
        tm = (cq[:, None] * pc + sq[:, None] * ps
              + rest[..., None] * qt0[:, None])
        out = out + einsum_fp32acc("bhqc,chd->bhqd", tm, wv2, cdt=cdt)
        return merge_heads(out)


class MAU(nn.Module):
    """Returns (outputs, mark_intensity (B, H, Tq, E)).

    Parameters (names match the flax module's leaves): with ``fused_qkvt``
    the one Q|K|V|T projection ``qkvt`` (BiMAU, MGAU), else ``q`` (from the
    queries) and ``k``, ``v``, ``t`` (from the keys), queries and keys both
    ``in_units`` wide; the intensity head's
    ``intensity_dense_kernel`` (dh+1, E*dh), ``intensity_dense_bias``,
    ``intensity_weight`` (E, dh) and ``intensity_scaling`` (E,).
    ``intensity_impl``: ``"fused"`` or ``"streamed"`` (module docstring);
    ``block_k``: the streamed engine's key block on the CPU.
    """

    def __init__(self, in_units: int, num_units: int, num_heads: int,
                 num_events: int, dropout_rate: float = 0.0, *,
                 fused_qkvt: bool = False, causal_default: bool = True,
                 diag_reset: bool = False, intensity_impl: str = "fused",
                 block_k: int = 512,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if intensity_impl not in ("fused", "streamed"):
            raise ValueError(f"MAU: unknown intensity_impl {intensity_impl}")
        self.intensity_impl = intensity_impl
        self.block_k = block_k
        self.num_units = num_units
        self.num_heads = num_heads
        self.num_events = num_events
        self.dropout_rate = dropout_rate
        self.fused_qkvt = fused_qkvt
        self.causal_default = causal_default
        self.diag_reset = diag_reset
        self.compute_dtype = compute_dtype
        dh = num_units // num_heads
        kw = dict(compute_dtype=compute_dtype, device=device)
        if fused_qkvt:
            self.qkvt = Dense(in_units, 4 * num_units, **kw)
        else:
            self.q = Dense(in_units, num_units, **kw)
            self.k = Dense(in_units, num_units, **kw)
            self.v = Dense(in_units, num_units, **kw)
            self.t = Dense(in_units, num_units, **kw)

        def empty(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.intensity_dense_kernel = empty(dh + 1, dh * num_events)
        self.intensity_dense_bias = empty(dh * num_events)
        self.intensity_weight = empty(num_events, dh)
        self.intensity_scaling = empty(num_events)

    def intensity(self, h_units: torch.Tensor, intervals: torch.Tensor,
                  mark_onehot: torch.Tensor):
        """The intensity head (JAX ``MAU.intensity``, temporal.py:491-510),
        its three products compute-dtype contractions with fp32 results.

        h_units: (B, H, Tq, dh); intervals: (B, Tq); mark_onehot: (B, Tk, E).
        Returns (intensity_qk (B, H, Tq, Tk), mark_intensity (B, H, Tq, E))."""
        cdt = self.compute_dtype
        b, h, tq, dh = h_units.shape
        e = self.num_events
        iv = intervals[:, None, :, None].expand(b, h, tq, 1).to(h_units.dtype)
        x = torch.cat([h_units, iv], dim=-1)
        z = einsum_fp32acc("bhqc,cd->bhqd", x, self.intensity_dense_kernel,
                           cdt=cdt)
        sig = torch.sigmoid(z + self.intensity_dense_bias)
        raw = einsum_fp32acc("bhqed,ed->bhqe", sig.reshape(b, h, tq, e, dh),
                             self.intensity_weight, cdt=cdt)
        s = torch.exp(self.intensity_scaling)
        mark_intensity = s * torch.logaddexp(raw / s, torch.zeros_like(raw))
        intensity_qk = einsum_fp32acc("bhqe,bke->bhqk", mark_intensity,
                                      mark_onehot.float(), cdt=cdt)
        return intensity_qk, mark_intensity

    @staticmethod
    def biased_likelihood(mark_intensity: torch.Tensor,
                          next_mark_onehot: torch.Tensor,
                          intervals: torch.Tensor) -> torch.Tensor:
        """Biased TPP log-likelihood (reference temporal.py:317-333).

        mark_intensity: (..., Tq, E); next_mark_onehot: same shape;
        intervals: (..., Tq). Under a mesh the event count is the global
        batch's (``dist/comm.py::data_total``): the rank's term is its
        share, and the shares sum over the data axis to the global
        value."""
        has_event = torch.sign(next_mark_onehot.sum(-1, keepdim=True))
        mark_intensity = mark_intensity * has_event
        event_intensity = (mark_intensity * next_mark_onehot).sum(-1)
        event_ll = torch.log(torch.where(event_intensity == 0.0, 1.0,
                                         event_intensity)).sum()
        entire_intensity = mark_intensity.sum(-1)
        non_event_ll = (entire_intensity * intervals * 0.5).sum()
        num_events = data_total(next_mark_onehot.sum())
        return -(event_ll - non_event_ll) / num_events

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                key_mask: torch.Tensor, intervals: torch.Tensor,
                mark_onehot: torch.Tensor, *,
                query_positions: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Attention of queries (B, Tq, Cin) over keys (B, Tk, Cin); key_mask
        (B, Tk) nonzero where the key is real; intervals (B, Tq);
        mark_onehot (B, Tk, E). The residual is ``queries[..., :C]``.
        Self-attention passes one tensor twice (EasyDGL); the fused
        projection then projects it once, and the split ones take Q from
        the queries and K, V, T from the keys (CTSMA: LN(x) and x).

        query_positions: optional (B, M) positions — attention for ONLY
        those query rows (rows are independent, so the result equals the
        full computation's rows there); with the fused projection only in
        self-attention (``queries is keys``), as in JAX. generator: the
        training step's generator; None is the deterministic case (no
        dropout)."""
        if self.fused_qkvt:
            if query_positions is not None and queries is not keys:
                raise ValueError(
                    "query_positions with fused_qkvt requires self-attention"
                    " (queries is keys); got distinct query/key arrays")
            qq, kk, vv, tt = self.qkvt(
                keys if query_positions is not None else queries
            ).chunk(4, dim=-1)
        else:
            qq, kk = self.q(queries), self.k(keys)
            vv, tt = self.v(keys), self.t(keys)
        if query_positions is not None:
            qpos = query_positions.long()
            qq = torch.take_along_dim(qq, qpos[:, :, None], dim=1)
            q_res = torch.take_along_dim(queries, qpos[:, :, None],
                                         dim=1)[:, :, :self.num_units]
            intervals = torch.take_along_dim(intervals, qpos, dim=1)
        else:
            qpos = None
            q_res = queries[:, :, :self.num_units]
        rate = self.dropout_rate if generator is not None else 0.0
        ex = seq_exchange() if qpos is None else None
        if ex is not None:
            return self._ring(qq, kk, vv, tt, key_mask, intervals,
                              mark_onehot, rate, generator, ex, q_res)
        if self.intensity_impl == "streamed" and qpos is not None:
            out, mark_intensity = mau_dense(
                self, qq, kk, vv, tt, key_mask, intervals, mark_onehot, qpos,
                rate, generator)
            return out + q_res, mark_intensity
        seed = dropout_seed(generator) if rate > 0.0 else None
        params = (self.intensity_dense_kernel, self.intensity_dense_bias,
                  self.intensity_weight, self.intensity_scaling)
        if self.intensity_impl == "streamed":
            out, mark_intensity = mau_streamed(
                qq, kk, vv, tt, key_mask, intervals, mark_onehot.float(),
                *params, self.causal_default, self.diag_reset, rate,
                num_heads=self.num_heads, dropout_seed=seed,
                block_k=self.block_k)
        elif spmd_mesh() is not None:
            # under a mesh: heads split over the model axis
            # (kernels/spmd.py), as JAX's fused branch (temporal.py:666-677)
            from easydgl_tpu_torch.kernels.spmd import mau_attention_spmd
            out, mark_intensity = mau_attention_spmd(
                qq, kk, vv, tt, key_mask, intervals, mark_onehot.float(),
                *params, seed, spmd_mesh(), self.causal_default,
                self.diag_reset, rate, self.num_heads, qpos=qpos)
        else:
            out, mark_intensity = mau_attention(
                qq, kk, vv, tt, key_mask, intervals, mark_onehot.float(),
                *params, self.causal_default, self.diag_reset, rate,
                num_heads=self.num_heads, qpos=qpos, dropout_seed=seed)
        return out + q_res, mark_intensity


    def _ring(self, qq, kk, vv, tt, key_mask, intervals, mark_onehot, rate,
              generator, ex, q_res):
        """The ring MAU over ``ex`` (``dist/context.py``), its dropout
        drawn from the step's generator."""
        h = self.num_heads
        out, mark_intensity = mau_ring_attention(
            *(split_heads(x, h) for x in (qq, kk, vv, tt)), key_mask,
            intervals, mark_onehot, self.intensity_dense_kernel,
            self.intensity_dense_bias, self.intensity_weight,
            self.intensity_scaling, ex, causal=self.causal_default,
            diag_reset=self.diag_reset, dropout_rate=rate,
            generator=generator)
        return merge_heads(out) + q_res, mark_intensity


def mau_dense(mau: MAU, qq, kk, vv, tt, key_mask, intervals, mark_onehot,
              qpos, rate: float, generator: Optional[torch.Generator]):
    """JAX's materialised MAU chain (``MAU.__call__``, temporal.py:687-711)
    for gathered query rows: qq (B, M, C) at positions ``qpos`` (B, M);
    kk, vv, tt (B, Tk, C); intervals (B, M). The logits masked by the key
    mask and, causal, by the horizon ``k <= qpos`` (``_mask_logits``,
    :43-57); softmax; the intensity head on probs @ T; the diagonal reset
    at ``k == qpos`` (:701-706); dropout of the modulated probs from the
    step's generator; @ V. Returns ((B, M, C) fp32, mark_intensity)."""
    h, cdt = mau.num_heads, mau.compute_dtype
    q, k, v, t = (split_heads(x, h) for x in (qq, kk, vv, tt))
    logits = einsum_fp32acc("bhqd,bhkd->bhqk", q, k, cdt=cdt) / (
        q.shape[-1] ** 0.5)
    logits = torch.where((key_mask != 0)[:, None, None, :], logits,
                         NEG_INF_LOGIT)
    cols = torch.arange(k.shape[2], device=k.device)[None, None, None, :]
    at = qpos[:, None, :, None]
    if mau.causal_default:
        logits = torch.where(cols <= at, logits, NEG_INF_LOGIT)
    probs = torch.softmax(logits, dim=-1)
    seq_units = einsum_fp32acc("bhqk,bhkd->bhqd", probs, t, cdt=cdt)
    intensity_qk, mark_intensity = mau.intensity(seq_units, intervals,
                                                 mark_onehot)
    if mau.diag_reset:
        intensity_qk = torch.where(cols == at, 1.0, intensity_qk)
    modulated = dropout(intensity_qk * probs, rate, generator)
    out = einsum_fp32acc("bhqk,bhkd->bhqd", modulated, v, cdt=cdt)
    return merge_heads(out), mark_intensity


def BiMAU(in_units: int, num_units: int, num_heads: int, num_events: int,
          dropout_rate: float = 0.0, *, intensity_impl: str = "fused",
          block_k: int = 512,
          compute_dtype: Optional[torch.dtype] = None, device=None) -> MAU:
    """Bidirectional MAU (reference temporal.py:396-452): fused QKVT
    projection, no causal mask, intensity diagonal reset to 1."""
    return MAU(in_units, num_units, num_heads, num_events, dropout_rate,
               fused_qkvt=True, causal_default=False, diag_reset=True,
               intensity_impl=intensity_impl, block_k=block_k,
               compute_dtype=compute_dtype, device=device)


def MGAU(in_units: int, num_units: int, num_heads: int, num_events: int,
         dropout_rate: float = 0.0, *, intensity_impl: str = "fused",
         block_k: int = 512,
         compute_dtype: Optional[torch.dtype] = None, device=None) -> MAU:
    """Gated variant (reference temporal.py:455-508): fused QKVT
    projection, no causal mask, no diagonal reset. No model uses it."""
    return MAU(in_units, num_units, num_heads, num_events, dropout_rate,
               fused_qkvt=True, causal_default=False, diag_reset=False,
               intensity_impl=intensity_impl, block_k=block_k,
               compute_dtype=compute_dtype, device=device)
