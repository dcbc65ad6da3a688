"""Context parallelism over the seq axis (port of
``easydgl_tpu.dist.context``): ring attention, Ulysses, and the two-sweep
ring MAU.

Every seq rank of a (data, model) coordinate runs the dense graph whole
(``train/sharded.py``); inside the attention each takes its block of T/cp
query rows (``Exchange.split``, whose backward all-gathers the blocks'
gradients) and the blocks of the output are put back together
(``Exchange.merge``, whose backward takes the rank's block). In between:

* ``ring_attention`` (JAX ``_ring_local`` :87, ``ring_attention_spmd``
  :126): each rank keeps its query block while the key, value and key-mask
  blocks travel round the ring (``Exchange.shift``, ``lax.ppermute``),
  softmax accumulated online (``_online_update``), so the merge over
  blocks is exact. The finite mask constant ``NEG_INF_LOGIT`` keeps the
  dense path's semantics: a row that sees no key is uniform over every
  key, left-pad rows included (and, causal, a row whose window holds no
  real key: C5 of ROADMAP §C, as the dense and blocked paths);
* ``mau_ring_attention`` (JAX ``_mau_ring_local`` :149,
  ``mau_ring_attention_spmd`` :241): two sweeps, because the intensity
  depends on the whole row's normalised probabilities through
  ``seq_units = probs @ T``. Sweep 1 gives (m, l) and seq_units; the
  intensity head runs on the rank's query rows; sweep 2 recomputes each
  block's probs as ``exp(s - m) / l`` and accumulates
  ``(intensity * probs [* keep]) @ V``;
* ``ulysses_attention`` (JAX ``_ulysses_local`` :268,
  ``ulysses_attention_spmd`` :295): an all-to-all turns the T/cp rows of
  H heads into the T rows of H/cp heads (``Exchange.all_to_all``), the
  dense ``attention_probs`` runs there, and a second all-to-all turns the
  context back. Needs H % cp == 0.

Numerics as JAX's: q, k and v in fp32 inside the ring whatever the compute
dtype (:97), the running max starts at -1e38 and is detached (the
``stop_gradient`` of :61; it cancels analytically), the output in q's
dtype. Products are plain fp32 ``torch.matmul``: the JAX package computes
them with einsums outside Pallas, so there is no TPU kernel to port here.

Two ``Exchange``s move the blocks. ``GroupExchange`` is the process-group
one, a rank a process (``dist/comm.py``: ``ring_shift``, ``all_to_all``,
the seq split and gather; gloo on the CPU, NCCL on the card).
``LocalExchange`` holds every rank's block in one process, stacked on a
leading dim (``torch.roll`` is its ring), so that one device can run
cp = 2 or 4 (``chip_smoke.py`` phase 10d). The ring bodies take their
blocks with that leading dim of R ranks (1 in a process group, cp in one
process) and are the same for both. ``use_seq_exchange`` makes a
``LocalExchange`` the one the models' CP branches take; under a mesh with
a seq axis they take the mesh's ``GroupExchange`` (``seq_exchange``).

Dropout keeps JAX's normalise-then-drop order and draws from the step's
``torch.Generator``, which every seq rank of a data group holds equal and
each data group has its own (``train/steps.py::dropout_generator``; JAX
offsets a shared key by the data coordinate instead, :93-95). Each ring
step draws the blocks of all cp ranks at once and a rank takes its own, so
the ranks' masks differ, the world and a ``LocalExchange`` draw the same
ones, and nothing waits for the host. The streams cannot match JAX's
(C3): parity holds at rate 0. One mask serves the forward and the backward
(autograd keeps it).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from easydgl_tpu_torch.core.mesh import (seq_group, seq_index, seq_size,
                                         spmd_mesh)
from easydgl_tpu_torch.dist.comm import (all_gather_cat, all_to_all,
                                         gather_along, grad_all_reduce,
                                         ring_shift, split_along)
from easydgl_tpu_torch.nn.attention import NEG_INF_LOGIT, attention_probs


class GroupExchange:
    """The blocks of the mesh's seq axis, one rank a process (R = 1)."""

    def __init__(self, mesh):
        self.cp = seq_size(mesh)
        self.group = seq_group(mesh)
        self.ranks = [seq_index(mesh)]

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return split_along(x, dim, self.group)[None]

    def merge(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return gather_along(x[0], dim, self.group)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        return ring_shift(x[0], self.group)[None]

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        return all_to_all(x[0], split_dim - 1, concat_dim - 1,
                          self.group)[None]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather_cat(x[0], dim - 1, self.group)[None]

    def replicated(self, p: torch.Tensor) -> torch.Tensor:
        """A replicated tensor used on this rank's rows only: its gradient
        summed over the seq ranks."""
        return grad_all_reduce(p, self.group)


class LocalExchange:
    """Every rank's block in this process, on a leading dim (R = cp)."""

    def __init__(self, cp: int):
        self.cp = cp
        self.ranks = list(range(cp))

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        dim %= x.dim()
        return x.unflatten(dim, (self.cp, -1)).movedim(dim, 0)

    def merge(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        dim %= x.dim() - 1
        return x.movedim(0, dim).flatten(dim, dim + 1)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        return torch.roll(x, 1, dims=0)

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        return torch.stack([torch.cat(b.unbind(0), dim=concat_dim - 1)
                            for b in x.chunk(self.cp, dim=split_dim)])

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        whole = self.merge(x, dim - 1)
        return whole[None].expand(self.cp, *whole.shape)

    def replicated(self, p: torch.Tensor) -> torch.Tensor:
        return p


_LOCAL: contextvars.ContextVar = contextvars.ContextVar(
    "seq_exchange", default=None)


@contextlib.contextmanager
def use_seq_exchange(exchange):
    """Run the models' CP branches through ``exchange`` (a
    ``LocalExchange``: cp ranks' blocks on this one device)."""
    token = _LOCAL.set(exchange)
    try:
        yield
    finally:
        _LOCAL.reset(token)


def seq_exchange():
    """The exchange the CP branches take: ``use_seq_exchange``'s, else the
    active mesh's seq axis (``core/mesh.py::use_spmd_mesh``) where cp > 1,
    else None (no context parallelism)."""
    ex = _LOCAL.get()
    if ex is not None:
        return ex
    mesh = spmd_mesh()
    return GroupExchange(mesh) if seq_size(mesh) > 1 else None


def check_divides(t: int, cp: int) -> None:
    """The sequence must split into cp equal blocks (JAX's shard_map
    refuses an indivisible dim the same way)."""
    if t % cp:
        raise ValueError(f"sequence length {t} is not divisible by the "
                         f"seq axis size cp={cp}")


# ---------------------------------------------------------------- pieces


def _online_update(carry, s, v, keep):
    """One exact online-softmax step (JAX :57): carry = (acc, m, l); s
    (..., Tq, Tk) masked logits; v (..., Tk, D); keep: the dropout mask
    (scaled) or None."""
    acc, m, l = carry
    m_new = torch.maximum(m, s.detach().amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    pv = p if keep is None else p * keep
    return acc * corr + pv @ v, m_new, l


def _chunk_logits(q, k, km, qpos, kpos, *, scale: float, causal: bool):
    """Masked logits of one (query block x key block), (R, B, H, Tq, Tk):
    the scaled q k^T with the finite mask constant (JAX :75). q (R, B, H,
    Tq, D), k (R, B, H, Tk, D), km (R, B, Tk); qpos / kpos (R, Tq / Tk)
    the blocks' global positions."""
    s = (q @ k.transpose(-1, -2)) * scale
    mask = (km > 0)[:, :, None, None, :]
    if causal:
        mask = mask & (kpos[:, None, None, None, :]
                       <= qpos[:, None, None, :, None])
    return torch.where(mask, s, NEG_INF_LOGIT)


def _positions(ranks, tl: int, device) -> torch.Tensor:
    r = torch.as_tensor(ranks, device=device)
    return r[:, None] * tl + torch.arange(tl, device=device)


def _keep(generator: torch.Generator, rate: float, shape, ex,
          device) -> torch.Tensor:
    """(R, *shape) keep factors, 1/(1-rate) or 0: one draw of every seq
    rank's block of ``shape``, of which the exchange's ranks take theirs."""
    u = torch.rand((ex.cp,) + tuple(shape), generator=generator,
                   device=device)
    u = u[torch.as_tensor(ex.ranks, device=device)]
    return torch.where(u < 1.0 - rate,
                       torch.tensor(1.0 / (1.0 - rate), device=device),
                       torch.zeros((), device=device))


# ---------------------------------------------------------------- ring


def _ring_local(q, k, v, km, ex, *, causal: bool, scale: Optional[float],
                rate: float, generator):
    """The ring body on R ranks' blocks: q, k (R, B, H, Tl, D), v (R, B,
    H, Tl, Dv), km (R, B, Tl) -> (R, B, H, Tl, Dv) in q's dtype."""
    cp = ex.cp
    _, b, h, tl, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = q.device
    qpos = _positions(ex.ranks, tl, dev)
    acc = qf.new_zeros(qf.shape[:-1] + (v.shape[-1],))
    m = qf.new_full(qf.shape[:-1] + (1,), -1.0e38)
    l = qf.new_zeros(qf.shape[:-1] + (1,))
    for step in range(cp):
        kpos = _positions([(my - step) % cp for my in ex.ranks], tl, dev)
        s = _chunk_logits(qf, kf, km, qpos, kpos, scale=scale, causal=causal)
        keep = (_keep(generator, rate, (b, h, tl, tl), ex, dev)
                if rate > 0.0 else None)
        acc, m, l = _online_update((acc, m, l), s, vf, keep)
        if step + 1 < cp:
            kf, vf, km = ex.shift(kf), ex.shift(vf), ex.shift(km)
    return (acc / l).to(q.dtype)


def ring_attention(q, k, v, key_mask, exchange, *, causal: bool,
                   scale: Optional[float] = None, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Context-parallel attention: q, k (B, H, T, D), v (B, H, T, Dv) and
    key_mask (B, T), whole on the rank; the sequence split over
    ``exchange``'s cp ranks. Returns (B, H, T, Dv), whole. Equal (to float
    accumulation order) to the dense ``attention_probs`` path at rate 0.
    ``scale`` multiplies q . k (default 1/sqrt(D))."""
    ex = exchange
    check_divides(q.shape[2], ex.cp)
    out = _ring_local(ex.split(q, 2), ex.split(k, 2), ex.split(v, 2),
                      ex.split(key_mask.float(), 1), ex, causal=causal,
                      scale=scale, rate=float(dropout_rate),
                      generator=generator)
    return ex.merge(out, 2)


# ---------------------------------------------------------------- ring MAU


def _mau_ring_local(q, k, v, t, km, iv, oh, wd, bd, w, scaling, ex, *,
                    causal: bool, diag_reset: bool, rate: float,
                    generator):
    """The two-sweep ring MAU body on R ranks' blocks: q, k, v, t (R, B, H,
    Tl, dh), km / iv (R, B, Tl), oh (R, B, Tl, E); the intensity weights
    replicated. Returns (out (R, B, H, Tl, dh) in q's dtype, lam (R, B, H,
    Tl, E) fp32)."""
    cp = ex.cp
    _, b, h, tl, dh = q.shape
    e = w.shape[0]
    scale = dh ** -0.5
    dev = q.device
    qf = q.float()
    qpos = _positions(ex.ranks, tl, dev)
    kposes = [_positions([(my - step) % cp for my in ex.ranks], tl, dev)
              for step in range(cp)]

    # sweep 1: softmax stats and seq_units
    m = qf.new_full(qf.shape[:-1] + (1,), -1.0e38)
    l = qf.new_zeros(qf.shape[:-1] + (1,))
    su = torch.zeros_like(qf)
    kf, tf, kmf = k.float(), t.float(), km
    for step in range(cp):
        s = _chunk_logits(qf, kf, kmf, qpos, kposes[step], scale=scale,
                          causal=causal)
        su, m, l = _online_update((su, m, l), s, tf, None)
        if step + 1 < cp:
            kf, tf, kmf = ex.shift(kf), ex.shift(tf), ex.shift(kmf)
    seq_units = su / l
    # sweep 2 takes probs as exp(s - m) / l, not exp(s - lse): on a row
    # that sees no key every logit is the mask constant, whose fp32 ulp
    # (512) swallows log(T); exp(s - m) is exactly 1 there, the dense
    # path's uniform row (JAX :191-195)

    # the intensity head on this rank's query rows (JAX :197-208)
    x = torch.cat([seq_units, iv[:, :, None, :, None].expand(
        *seq_units.shape[:-1], 1).float()], dim=-1)
    z = x @ ex.replicated(wd).float()
    sig = torch.sigmoid(z + ex.replicated(bd).float()).unflatten(-1, (e, dh))
    raw = torch.einsum("rbhqed,ed->rbhqe", sig, ex.replicated(w).float())
    s_e = torch.exp(ex.replicated(scaling).float())
    lam = s_e * torch.logaddexp(raw / s_e, torch.zeros_like(raw))

    # sweep 2: the modulated output
    acc = torch.zeros_like(qf)
    kf, vf, ohf, kmf = k.float(), v.float(), oh.float(), km
    for step in range(cp):
        kpos = kposes[step]
        s = _chunk_logits(qf, kf, kmf, qpos, kpos, scale=scale,
                          causal=causal)
        p = torch.exp(s - m) / l
        iqk = torch.einsum("rbhqe,rbke->rbhqk", lam, ohf)
        if diag_reset:      # BiMAU: the intensity diagonal is 1
            diag = kpos[:, None, None, None, :] == qpos[:, None, None, :,
                                                        None]
            iqk = torch.where(diag, 1.0, iqk)
        mod = iqk * p
        if rate > 0.0:
            mod = mod * _keep(generator, rate, (b, h, tl, tl), ex, dev)
        acc = acc + mod @ vf
        if step + 1 < cp:
            kf, vf, ohf, kmf = (ex.shift(kf), ex.shift(vf), ex.shift(ohf),
                                ex.shift(kmf))
    return acc.to(q.dtype), lam


def mau_ring_attention(q, k, v, t, key_mask, intervals, onehot, wd, bd, w,
                       scaling, exchange, *, causal: bool, diag_reset: bool,
                       dropout_rate: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    """Context-parallel MAU / BiMAU: q, k, v, t (B, H, T, dh), key_mask
    and intervals (B, T), onehot (B, T, E), whole on the rank; the
    intensity weights replicated (their gradients summed over the seq
    ranks, each rank's from its own query rows). Returns (out (B, H, T,
    dh), mark_intensity (B, H, T, E)), whole: the MAU module's chain up to
    float accumulation order."""
    ex = exchange
    check_divides(q.shape[2], ex.cp)
    out, lam = _mau_ring_local(
        *(ex.split(x, 2) for x in (q, k, v, t)),
        ex.split(key_mask.float(), 1), ex.split(intervals.float(), 1),
        ex.split(onehot.float(), 1), wd, bd, w, scaling, ex, causal=causal,
        diag_reset=diag_reset, rate=float(dropout_rate),
        generator=generator)
    return ex.merge(out, 2), ex.merge(lam, 2)


# ---------------------------------------------------------------- Ulysses


def _ulysses_local(q, k, v, km, ex, *, causal: bool,
                   scale: Optional[float], rate: float, generator,
                   compute_dtype: Optional[torch.dtype]):
    """The Ulysses body on R ranks' blocks (R, B, H, Tl, D): rows to heads,
    dense attention over the whole sequence, heads back to rows."""
    qh, kh, vh = (ex.all_to_all(x, 2, 3) for x in (q, k, v))
    km_full = ex.gather(km, 2)                       # (R, B, T)
    r, b = qh.shape[:2]
    probs = attention_probs(qh.flatten(0, 1), kh.flatten(0, 1),
                            key_mask=km_full.flatten(0, 1), causal=causal,
                            scale=scale, compute_dtype=compute_dtype
                            ).unflatten(0, (r, b))
    if rate > 0.0:
        probs = probs * _keep(generator, rate, probs.shape[1:], ex,
                              probs.device)
    ctx = (probs @ vh.float()).to(q.dtype)
    return ex.all_to_all(ctx, 3, 2)


def ulysses_attention(q, k, v, key_mask, exchange, *, causal: bool,
                      scale: Optional[float] = None,
                      dropout_rate: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """``ring_attention``'s contract by head re-sharding; the logits a
    ``compute_dtype`` contraction with an fp32 result, as the dense path
    (``attention_probs``). Needs num_heads % cp == 0."""
    ex = exchange
    assert q.shape[1] % ex.cp == 0, \
        f"ulysses needs heads ({q.shape[1]}) divisible by sp ({ex.cp})"
    check_divides(q.shape[2], ex.cp)
    out = _ulysses_local(ex.split(q, 2), ex.split(k, 2), ex.split(v, 2),
                         ex.split(key_mask.float(), 1), ex, causal=causal,
                         scale=scale, rate=float(dropout_rate),
                         generator=generator,
                         compute_dtype=compute_dtype)
    return ex.merge(out, 2)


def cp_attention(impl: str, q, k, v, key_mask, exchange, *, causal: bool,
                 scale: Optional[float] = None, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
    """The attention modules' CP core: ``impl`` ("ring" or "ulysses",
    ``Config.cp_impl``) over ``exchange``; the dropout masks drawn from
    ``generator`` (the step's) when ``dropout_rate`` > 0."""
    if impl == "ulysses":
        return ulysses_attention(q, k, v, key_mask, exchange, causal=causal,
                                 scale=scale, dropout_rate=dropout_rate,
                                 generator=generator,
                                 compute_dtype=compute_dtype)
    if impl != "ring":
        raise ValueError(f"unknown cp_impl {impl}")
    return ring_attention(q, k, v, key_mask, exchange, causal=causal,
                          scale=scale, dropout_rate=dropout_rate,
                          generator=generator)
