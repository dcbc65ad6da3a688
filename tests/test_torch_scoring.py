"""PyTorch port: the streamed catalog NLL (``kernels/scoring.py``).

The plain ``catalog_nll`` (the CPU path: ``catalog_nll_reference`` under
autograd) and the written-out backward ``catalog_nll_bwd_reference``
against the JAX ``catalog_nll`` (Pallas, interpret mode: the fused
backward, and the two-pass backward of the large-N branch) and the JAX
``catalog_nll_reference``: lse and the label logit, and d_hidden, d_table,
d_bias with cotangents on both outputs. N and V are not multiples of the
JAX tile sizes, and the labels include 0 and V-1. Then the backward's row
codes (``catalog_live_rows``) against a direct count, and the backward on a
batch whose padded rows carry dlse = dll = 0 (exact zeros there, and the
same d_table and d_bias as the batch without them).

The CUDA kernels are held against the plain versions in
``test_torch_cuda.py`` (card only). fp32 tolerance: values atol = rtol =
1e-5; gradients 1e-5 of each gradient's largest entry (sums over V or N
terms in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import easydgl_tpu.kernels.scoring as jscoring
from easydgl_tpu_torch.kernels.scoring import (ROW_TILE, catalog_live_rows,
                                               catalog_nll,
                                               catalog_nll_bwd,
                                               catalog_nll_bwd_reference,
                                               catalog_nll_fwd,
                                               catalog_nll_reference,
                                               catalog_nll_written_out)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _data(seed, n=13, c=8, v=37):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    hidden = rng.normal(size=(n, c)).astype(f32)
    table = rng.normal(size=(v, c)).astype(f32)
    bias = rng.normal(size=v).astype(f32)
    bias[0] = -1000.0          # the padding id, as OutputBias makes it
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[0], labels[1] = 0, v - 1
    dlse = rng.normal(size=n).astype(f32)
    dll = rng.normal(size=n).astype(f32)
    return hidden, table, bias, labels, dlse, dll


def _assert_grads(got, want, what):
    for name, a, b in zip(("d_hidden", "d_table", "d_bias"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=1e-5 * float(np.abs(b).max()),
                                   rtol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("n,v", [(13, 37), (16, 64), (5, 300)])
def test_forward_matches_jax_kernel_and_reference(n, v):
    h, t, b, lab, _, _ = _data(1, n=n, v=v)
    with pltpu.force_tpu_interpret_mode():
        klse, kll = jscoring.catalog_nll(*(jnp.asarray(x)
                                           for x in (h, t, b, lab)), 8, 16)
    rlse, rll = jscoring.catalog_nll_reference(*(jnp.asarray(x)
                                                 for x in (h, t, b, lab)))
    targs = [torch.tensor(x) for x in (h, t, b, lab)]
    before = catalog_nll_fwd.launches
    for lse, ll in (catalog_nll(*targs), catalog_nll_fwd(*targs),
                    catalog_nll_reference(*targs)):
        for want_lse, want_ll in ((klse, kll), (rlse, rll)):
            np.testing.assert_allclose(lse.detach().numpy(),
                                       np.asarray(want_lse), **TOL)
            np.testing.assert_allclose(ll.detach().numpy(),
                                       np.asarray(want_ll), **TOL)
    assert catalog_nll_fwd.launches == before  # CPU: no kernel


@pytest.mark.parametrize("n,v,two_pass", [(7, 37, False), (8, 32, False),
                                           (13, 37, True), (8, 32, True)])
def test_grads_match_jax_kernel_and_reference(n, v, two_pass, monkeypatch):
    """Gradients of sum(lse * dlse) + sum(ll * dll): JAX catalog_nll's
    fused backward (and, with ``two_pass``, its large-N two-pass backward,
    forced by a zero VMEM budget) and the JAX reference, against autograd
    of the port's plain catalog_nll and its written-out backward. The fused
    kernel rewrites its d_hidden block on every vocab step, which the
    interpreter accepts only with one row block (N <= 8 here)."""
    h, t, b, lab, dlse, dll = _data(2, n=n, v=v)
    if two_pass:
        monkeypatch.setattr(jscoring, "_FUSED_BWD_VMEM_BYTES", 0)

    def jloss(fn, *blocks):
        def loss(hh, tt, bb):
            lse, ll = fn(hh, tt, bb, jnp.asarray(lab), *blocks)
            return jnp.sum(lse * dlse) + jnp.sum(ll * dll)
        return loss

    ja = tuple(jnp.asarray(x) for x in (h, t, b))
    with pltpu.force_tpu_interpret_mode():
        want_k = jax.grad(jloss(jscoring.catalog_nll, 8, 16),
                          argnums=(0, 1, 2))(*ja)
    want_r = jax.grad(jloss(jscoring.catalog_nll_reference),
                      argnums=(0, 1, 2))(*ja)

    th, tt, tb = (torch.tensor(x, requires_grad=True) for x in (h, t, b))
    lse, ll = catalog_nll(th, tt, tb, torch.tensor(lab))
    loss = (lse * torch.tensor(dlse)).sum() + (ll * torch.tensor(dll)).sum()
    got_auto = [g.numpy() for g in torch.autograd.grad(loss, (th, tt, tb))]
    before = catalog_nll_bwd.launches
    got_expl = catalog_nll_bwd(*(torch.tensor(x) for x in (h, t, b, lab)),
                               lse.detach(), torch.tensor(dlse),
                               torch.tensor(dll))
    assert catalog_nll_bwd.launches == before  # CPU: no kernel
    got_expl = [g.numpy() for g in got_expl]
    for got, name in ((got_auto, "autograd"), (got_expl, "explicit")):
        _assert_grads(got, want_k, f"{name} vs JAX kernel")
        _assert_grads(got, want_r, f"{name} vs JAX reference")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_written_out_is_the_plain_forward_and_backward(dtype):
    """``catalog_nll_written_out``: the plain forward's (lse, ll), and
    autograd through it gives ``catalog_nll_bwd_reference``'s gradients
    exactly; in fp32 (where rounding g is the identity) also autograd's of
    ``catalog_nll_reference`` to 1e-5 of each output's scale."""
    h, t, b, lab, dlse, dll = _data(4, n=11, c=16, v=50)
    th, tt = (torch.tensor(x).to(dtype).requires_grad_() for x in (h, t))
    tb, tlab = torch.tensor(b, requires_grad=True), torch.tensor(lab)
    dl, dm = torch.tensor(dlse), torch.tensor(dll)
    lse, ll = catalog_nll_written_out(th, tt, tb, tlab)
    want = catalog_nll_reference(th, tt, tb, tlab)
    for got_x, want_x in zip((lse, ll), want):
        assert torch.equal(got_x.detach(), want_x.detach())
    got = torch.autograd.grad((lse * dl).sum() + (ll * dm).sum(),
                              (th, tt, tb))
    written = catalog_nll_bwd_reference(th.detach(), tt.detach(),
                                        tb.detach(), tlab, lse.detach(),
                                        dl, dm)
    for g, w in zip(got, written):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if dtype == torch.float32:
        auto = torch.autograd.grad((want[0] * dl).sum()
                                   + (want[1] * dm).sum(), (th, tt, tb))
        _assert_grads([g.numpy() for g in got], [a.numpy() for a in auto],
                      "written out vs autograd")


def test_bf16_backward_rounds_g_and_returns_the_compute_dtype():
    """In bf16, d_hidden and d_table come back in bf16 (the TPU kernel
    returns them in its inputs' dtype) and g is rounded to bf16 before both
    products; d_bias stays fp32 and sums the unrounded g. Held against the
    same arithmetic written with explicit casts to one bf16 ulp (rtol 1e-2):
    softmax here and exp(s - lse) there differ in the last fp32 bits, which
    can flip a bf16 rounding."""
    h, t, b, lab, dlse, dll = _data(3, n=11, c=16, v=50)
    hb = torch.tensor(h).to(torch.bfloat16)
    tb = torch.tensor(t).to(torch.bfloat16)
    lse, _ = catalog_nll_reference(hb, tb, torch.tensor(b), torch.tensor(lab))
    dh, dt, db = catalog_nll_bwd_reference(
        hb, tb, torch.tensor(b), torch.tensor(lab), lse, torch.tensor(dlse),
        torch.tensor(dll))
    assert dh.dtype == dt.dtype == torch.bfloat16 and db.dtype == torch.float32
    logits = hb.float() @ tb.float().t() + torch.tensor(b)
    g = torch.tensor(dlse)[:, None] * torch.softmax(logits, -1)
    g[torch.arange(11), torch.tensor(lab).long()] += torch.tensor(dll)
    gr = g.to(torch.bfloat16).float()
    torch.testing.assert_close(dh.float(), (gr @ tb.float()).to(
        torch.bfloat16).float(), atol=0, rtol=1e-2)
    torch.testing.assert_close(dt.float(), (gr.t() @ hb.float()).to(
        torch.bfloat16).float(), atol=0, rtol=1e-2)
    torch.testing.assert_close(db, g.sum(0), atol=1e-6, rtol=1e-5)


def _padded_rows(n, rng):
    """Labels of left-padded histories, flattened as the train step's
    labels are (0 at a padded position), and the dead rows."""
    rows, width = -(-n // 50), 50
    lengths = rng.integers(1, width + 1, rows)
    lengths[0], lengths[-1] = 0, width   # padding alone; no padding
    pad = np.arange(width)[None] < (width - lengths[:, None])
    return pad.reshape(-1)[:n]


@pytest.mark.parametrize("n,kind", [(333, "padded"), (130, "all_dead"),
                                    (128, "all_live"), (65, "padded"),
                                    (200, "alternating")])
def test_live_rows_count_each_tile(n, kind):
    """One code a 64-row tile (the last one ragged): 0 exactly where every
    row of the tile has dlse == 0 and dll == 0, against a direct count."""
    rng = np.random.default_rng(n)
    dead = {"padded": _padded_rows(n, rng), "all_dead": np.ones(n, bool),
            "all_live": np.zeros(n, bool),
            "alternating": (np.arange(n) // 3) % 2 == 0}[kind]
    if kind == "alternating":
        dead[64:128] = True            # a whole dead tile among mixed ones
    dlse = np.where(dead, 0.0, rng.normal(size=n)).astype(np.float32)
    dll = np.where(dead, 0.0, rng.normal(size=n)).astype(np.float32)
    dll[~dead & (np.arange(n) % 5 == 0)] = 0.0   # one of the two may be 0
    got = catalog_live_rows(torch.tensor(dlse), torch.tensor(dll)).numpy()
    want = [int(np.any((dlse[i:i + ROW_TILE] != 0)
                       | (dll[i:i + ROW_TILE] != 0)))
            for i in range(0, n, ROW_TILE)]
    assert got.dtype == np.int32 and got.tolist() == want
    assert got.shape == (-(-n // ROW_TILE),)
    if kind == "all_dead":
        assert not got.any()
    if kind == "all_live":
        assert got.all()


@pytest.mark.parametrize("n,v", [(150, 37), (77, 130)])
def test_backward_of_padded_rows_is_exactly_zero(n, v):
    """A batch of left-padded histories: the padded rows (label 0) carry
    dlse = dll = 0, as the train step's weighted loss gives them. The plain
    backward equals jax.vjp of the JAX catalog_nll_reference at 1e-5, its
    d_hidden is exactly 0 on the padded rows, and d_table and d_bias equal
    those of the batch with the padded rows removed."""
    h, t, b, lab, dlse, dll = _data(4, n=n, v=v)
    dead = _padded_rows(n, np.random.default_rng(v))
    assert dead.any() and not dead.all()
    lab = np.where(dead, 0, np.maximum(lab, 1)).astype(np.int32)
    dlse = np.where(dead, 0.0, dlse).astype(np.float32)
    dll = np.where(dead, 0.0, dll).astype(np.float32)

    def jloss(hh, tt, bb):
        lse, ll = jscoring.catalog_nll_reference(hh, tt, bb, jnp.asarray(lab))
        return jnp.sum(lse * dlse) + jnp.sum(ll * dll)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (h, t, b)))
    th, tt, tb, tlab = (torch.tensor(x) for x in (h, t, b, lab))
    lse, _ = catalog_nll_reference(th, tt, tb, tlab)
    got = catalog_nll_bwd(th, tt, tb, tlab, lse, torch.tensor(dlse),
                          torch.tensor(dll))
    _assert_grads([g.numpy() for g in got], want, "padded batch vs JAX")
    assert float(got[0][torch.tensor(dead)].abs().max()) == 0.0
    keep = torch.tensor(~dead)
    kept = catalog_nll_bwd(th[keep], tt, tb, tlab[keep], lse[keep],
                           torch.tensor(dlse)[keep], torch.tensor(dll)[keep])
    torch.testing.assert_close(got[0][keep], kept[0], **TOL)
    for a, w in zip(got[1:], kept[1:]):
        torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-5)
