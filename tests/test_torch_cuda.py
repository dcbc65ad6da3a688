"""PyTorch port on a CUDA card: each kernel against its plain version.

Skipped where there is no card. Imports neither JAX nor the JAX package, so
it also runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances (|kernel - plain| <= atol + rtol * scale): fp32 1e-4 with scale
|plain| (sums reassociated); bf16 2e-2 with, for ``out``, scale
sum_j |m_ij v_jd| (the plain version on |v|): both round the same operands
to bf16, and a sum taken in another order can flip one such rounding by a
bf16 ulp (2^-8 of a summand), which that scale bounds even where the sum
cancels. Gradients, the catalog NLL's outputs and the streamed MAU
kernels' outputs are held to a fraction of each output's largest entry,
with no absolute floor (at the flagship's scales a floor of 1e-6 exceeds
1e-2 x max|d_hidden| and would pass a wrong kernel): fp32 1e-4 (sums of up
to B*H*Tq terms, added in another order and by atomics), bf16 1e-2 (a
reordered sum can flip the bf16 rounding of an intermediate such as dz, g
or the probs by one ulp). An output that is exactly zero by construction
is compared for equality. The streamed intensity head is fp32 in both
compute dtypes and is held to 1e-4.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from easydgl_tpu_torch.kernels.mau_attention import (
    mau_attention, mau_attention_bwd, mau_attention_bwd_reference,
    mau_attention_reference)
from easydgl_tpu_torch.kernels.mau_blocked import (
    dkvt_reference, dq_reference, glam_reference, intensity_reference,
    intensity_vjp_reference, mau_blocked, mau_blocked_forward,
    output_reference, row_correction, stats_reference)
from easydgl_tpu_torch.kernels.mau_streamed import (
    STREAMED_KERNELS, mau_dkvt, mau_dq, mau_glam, mau_intensity,
    mau_intensity_bwd, mau_modulated_out, mau_stats, mau_streamed)
from easydgl_tpu_torch.kernels.scoring import (catalog_nll_bwd,
                                               catalog_nll_bwd_reference,
                                               catalog_nll_fwd,
                                               catalog_nll_reference,
                                               catalog_nll_written_out)

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, *, b, t, h, dh, e, tq=None, seed=0):
    """numpy-drawn inputs; left-padded key mask with row 0 fully masked;
    sorted distinct query positions when tq < t."""
    rng = np.random.default_rng(seed)
    tq = t if tq is None else tq
    c = h * dh
    f32 = np.float32
    q = rng.normal(size=(b, tq, c)).astype(f32)
    k, v, tt = (rng.normal(size=(b, t, c)).astype(f32) for _ in range(3))
    lengths = rng.integers(1, t + 1, b)
    km = (np.arange(t)[None] >= t - lengths[:, None]).astype(f32)
    km[0] = 0.0
    iv = rng.exponential(1.0, (b, tq)).astype(f32)
    oh = (rng.random((b, t, e)) < 0.2).astype(f32)
    wd = rng.normal(0, 0.2, (dh + 1, e * dh)).astype(f32)
    bd = rng.normal(0, 0.1, e * dh).astype(f32)
    w = rng.normal(0, 0.2, (e, dh)).astype(f32)
    sc = rng.normal(0, 0.3, e).astype(f32)
    qpos = None
    if tq < t:
        qpos = np.sort(rng.permuted(np.tile(np.arange(t), (b, 1)), axis=1)
                       [:, :tq], axis=1).astype(np.int32)
        qpos = torch.tensor(qpos, device=dev)
    ts = [torch.tensor(x, device=dev) for x in
          (q, k, v, tt, km, iv, oh, wd, bd, w, sc)]
    for i in range(4):
        ts[i] = ts[i].to(dtype)
    return ts, qpos


def _check_close(dtype, got, want, out_scale):
    tol = TOL[dtype]
    for a, b, scale in zip(got, want, (out_scale, want[1])):
        err = (a.float() - b.float()).abs()
        assert torch.isfinite(a.float()).all()
        assert bool((err <= tol + tol * scale.float().abs()).all()), \
            float(err.max())


CASES = [  # (causal, diag_reset, tq)
    (False, True, None), (True, False, None), (False, True, 4),
    (True, False, 4)]
SHAPES = {"small": dict(b=3, t=11, h=2, dh=16, e=4),
          "flagship_width": dict(b=8, t=31, h=8, dh=64, e=64),
          "tk128": dict(b=2, t=128, h=4, dh=32, e=8),
          # PRESETS["CTSMA"]'s heads: the bf16 backward's tensor-core path
          # in two 64-lane halves
          "dh128": dict(b=4, t=31, h=4, dh=128, e=64),
          # the bf16 forward's intensity head over rows of many heads: three
          # events (a ragged column tile) and two 64-event tiles
          "e3": dict(b=5, t=20, h=2, dh=32, e=3),
          "e128": dict(b=4, t=31, h=4, dh=64, e=128)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("causal,diag,tq", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, dtype, causal, diag, tq,
                                      shape):
    ts, qpos = _inputs(cuda_device, dtype, tq=tq, **SHAPES[shape])
    h = SHAPES[shape]["h"]
    before = mau_attention.launches
    got = mau_attention(*ts, causal, diag, num_heads=h, qpos=qpos)
    assert mau_attention.launches == before + 1
    want = mau_attention_reference(*ts, causal=causal, diag_reset=diag,
                                   num_heads=h, qpos=qpos)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    scale = want[0]
    if dtype == torch.bfloat16:
        abs_v = ts[:2] + [ts[2].abs()] + ts[3:]
        scale = mau_attention_reference(*abs_v, causal=causal,
                                        diag_reset=diag, num_heads=h,
                                        qpos=qpos)[0]
    _check_close(dtype, got, want, scale)


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    ts, _ = _inputs(cuda_device, torch.float32, b=2, t=11, h=2, dh=16, e=4)
    with pytest.raises(ValueError, match="seed"):
        mau_attention(*ts, False, True, 0.1, num_heads=2)
    half = [x.half() if i < 4 else x for i, x in enumerate(ts)]
    with pytest.raises(ValueError, match="dtype"):
        mau_attention(*half, num_heads=2)
    long, _ = _inputs(cuda_device, torch.float32, b=1, t=129, h=2, dh=16,
                      e=4)
    with pytest.raises(ValueError, match="Tk"):
        mau_attention(*long, num_heads=2)
    odd, _ = _inputs(cuda_device, torch.float32, b=1, t=5, h=2, dh=24, e=4)
    with pytest.raises(ValueError, match="head dim"):
        mau_attention(*odd, num_heads=2)


def test_model_on_card_matches_cpu(cuda_device):
    """fp32 EasyDGL logits, kernel on the card vs plain on the CPU: 1e-4."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                                  synthetic_split)
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import to_device
    cfg = preset("EasyDGL", num_items=60, seqslen=10, num_units=32,
                 num_heads=2, num_events=4, batch_size=4)
    params = random_flax_params(cfg, 0)
    ds = synthetic_split(num_rows=4, num_items=60, seqslen=10, seed=2)
    loader = BatchLoader(ds, data_mode="mau", batch_size=4,
                         is_training=False,
                         mark_table=synthetic_mark_table(60, 4, seed=1),
                         needs_marks=True)
    features, _, _ = next(loader.epoch(0))
    logits = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = build_model(cfg, device=dev, params=params)
        with torch.no_grad():
            logits[dev.type] = model(to_device(features, dev))[0].cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _check_by_scale(dtype, got, want, what):
    tol = GRAD_TOL[dtype]
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach().float(), b.detach().float()
        assert a.shape == b.shape, (what, i)
        assert bool(torch.isfinite(a).all()), (what, i)
        err = float((a - b).abs().max())
        assert err <= tol * float(b.abs().max()), (what, i, err)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("causal,diag,tq", CASES[:3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain_version(cuda_device, dtype, causal,
                                               diag, tq, shape, rate):
    """The forward (with dropout and the raw residual) and the backward
    kernel, the same seed on both sides, against the plain versions."""
    _backward_vs_plain(cuda_device, dtype, causal, diag, tq, SHAPES[shape],
                       rate)


@pytest.mark.parametrize("shape,causal,diag,tq,rate", [
    ("dh128", True, False, None, 0.2), ("dh128", False, True, None, 0.0),
    ("dh128", False, True, 4, 0.2),
    # Tk = 128: 16 query rows a block, the key gradients summed in fp32
    ("tk128_dh128", True, False, None, 0.1),
    ("tk128_dh128", False, True, None, 0.0)])
def test_dh128_bf16_backward_takes_the_tensor_cores(cuda_device, shape,
                                                    causal, diag, tq, rate):
    """bf16 at dh = 128 runs kPre, mau_bwd_int_tc<128> and kPost (the
    library says so, and no CUDA-core kernel is left for it), and matches
    the plain version, also where a block takes fewer query rows than Tq."""
    from easydgl_tpu_torch.kernels import mau_attention as ma
    dims = {"dh128": SHAPES["dh128"],
            "tk128_dh128": dict(b=2, t=128, h=2, dh=128, e=8)}[shape]
    assert ma._bwd_lib().mau_attention_bwd_tensor_cores(128, 1) == 1
    assert ma._bwd_lib().mau_attention_bwd_tensor_cores(128, 0) == 0
    t = dims["t"]
    rows = t if tq is None else tq
    qc = ma._bwd_query_chunk(rows, t, 128, dims["e"], True)
    assert (qc < rows) == (shape == "tk128_dh128")
    _backward_vs_plain(cuda_device, torch.bfloat16, causal, diag, tq, dims,
                       rate)


def test_bwd_smem_bytes_mirror_the_library(cuda_device):
    """``bwd_smem_bytes``, by which the wrapper picks the query rows a
    block, equals the library's own count for every dh and both dtypes."""
    from easydgl_tpu_torch.kernels import mau_attention as ma
    lib = ma._bwd_lib()
    for dh in ma.KERNEL_HEAD_DIMS:
        for code in (0, 1):
            tc = bool(lib.mau_attention_bwd_tensor_cores(dh, code))
            assert tc == (code == 1)
            for qc, tk, e in ((32, 128, 64), (16, 128, 64), (30, 30, 64),
                              (6, 31, 3), (8, 128, 128), (31, 31, 12)):
                assert lib.mau_attention_bwd_smem_bytes(qc, tk, dh, e, code) \
                    == ma.bwd_smem_bytes(qc, tk, dh, e, tc), (qc, tk, dh, e)


def _backward_vs_plain(cuda_device, dtype, causal, diag, tq, dims, rate):
    ts, qpos = _inputs(cuda_device, dtype, tq=tq, **dims)
    h = dims["h"]
    diff = [x.clone().requires_grad_(i < 4 or i > 6)
            for i, x in enumerate(ts)]
    seed = torch.tensor(20240611, device=cuda_device)
    before = (mau_attention.launches, mau_attention_bwd.launches)
    out, lam = mau_attention(*diff, causal, diag, rate, num_heads=h,
                             qpos=qpos, dropout_seed=seed)
    want_o, want_l = mau_attention_reference(
        *ts, causal=causal, diag_reset=diag, dropout_rate=rate,
        dropout_seed=seed, num_heads=h, qpos=qpos)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    go = torch.randn(out.shape, generator=g, device=cuda_device).to(dtype)
    gl = torch.randn(lam.shape, generator=g, device=cuda_device)
    grads = torch.autograd.grad((out.float() * go.float()).sum()
                                + (lam * gl).sum(),
                                [diff[i] for i in (0, 1, 2, 3, 7, 8, 9, 10)])
    assert (mau_attention.launches, mau_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _check_by_scale(dtype, (out, lam), (want_o, want_l), "forward")
    want = mau_attention_bwd_reference(
        *ts, go, gl, causal=causal, diag_reset=diag, dropout_rate=rate,
        dropout_seed=seed, num_heads=h, qpos=qpos)
    _check_by_scale(dtype, grads, want, "backward")
    for a, x in zip(grads[:4], ts[:4]):
        assert a.dtype == x.dtype


@pytest.mark.parametrize("n,v,c", [(77, 1001, 64), (300, 2000, 512),
                                   (15, 33, 4), (3840, 17771, 50),
                                   (9, 40, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_catalog_kernels_match_plain_version(cuda_device, dtype, n, v, c):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    h = torch.randn(n, c, generator=g, device=cuda_device).to(dtype)
    t = torch.randn(v, c, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(v, generator=g, device=cuda_device)
    lab = torch.randint(0, v, (n,), generator=g, device=cuda_device)
    lab[0], lab[-1] = 0, v - 1
    dlse, dll = (torch.randn(n, generator=g, device=cuda_device)
                 for _ in range(2))
    lse, ll = catalog_nll_fwd(h, t, b, lab)
    want = catalog_nll_reference(h, t, b, lab)
    _check_by_scale(dtype, (lse, ll), want, "forward")
    got = catalog_nll_bwd(h, t, b, lab, want[0], dlse, dll)
    want = catalog_nll_bwd_reference(h, t, b, lab, want[0], dlse, dll)
    assert got[0].dtype == got[1].dtype == dtype
    _check_by_scale(dtype, got, want, "backward")


@pytest.mark.parametrize("n,v,c", [(77, 1001, 64), (3072, 8886, 512),
                                   (3072, 4443, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_catalog_kernels_take_label_minus_one_as_plain_version(
        cuda_device, dtype, n, v, c):
    """A vocab slice's rows (``kernels/spmd.py``): a label outside the
    slice is -1, label logit 0 and no one-hot term in the backward, in the
    kernels as in the plain version; at the flagship's slices of 17,772
    ids over mp = 2 and 4, and at a small C on the CUDA cores."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    h = torch.randn(n, c, generator=g, device=cuda_device).to(dtype)
    t = (torch.randn(v, c, generator=g, device=cuda_device) / 8).to(dtype)
    b = torch.randn(v, generator=g, device=cuda_device)
    lab = torch.randint(0, v, (n,), generator=g, device=cuda_device)
    lab[::3] = -1
    dlse, dll = (torch.randn(n, generator=g, device=cuda_device) / n
                 for _ in range(2))
    lse, ll = catalog_nll_fwd(h, t, b, lab)
    want = catalog_nll_reference(h, t, b, lab)
    assert float(ll[lab < 0].abs().max()) == 0.0
    assert float(want[1][lab < 0].abs().max()) == 0.0
    _check_by_scale(torch.float32, (lse, ll), want, "forward")
    got = catalog_nll_bwd(h, t, b, lab, want[0], dlse, dll)
    want = catalog_nll_bwd_reference(h, t, b, lab, want[0], dlse, dll)
    _check_by_scale(dtype, got, want, "backward")


@pytest.mark.parametrize("splits", ["library", 1, 3, "one_per_tile"])
@pytest.mark.parametrize("n,v", [(77, 1001), (4097, 17771), (65536, 17771)])
def test_catalog_forward_kernel_matches_plain_version(cuda_device, n, v,
                                                      splits):
    """The bf16 forward at C = 512 (the wgmma kernel) against the plain
    version, however the vocab is split (the library's choice, forced
    counts, one split per 128-id tile), with labels at 0, at 63 and 64
    (either side of a 64-id boundary inside a tile) and at V - 1 (the
    ragged last tile). lse and ll are held to the fp32 scale tolerance:
    both sides sum exact bf16 products in fp32."""
    from easydgl_tpu_torch.kernels.scoring import _launch_fwd
    rng = np.random.default_rng(n + v)
    h = torch.tensor(rng.normal(size=(n, 512)), dtype=torch.float32,
                     device=cuda_device).to(torch.bfloat16)
    t = torch.tensor(rng.normal(size=(v, 512)) / 8, dtype=torch.float32,
                     device=cuda_device).to(torch.bfloat16)
    b = torch.tensor(rng.normal(size=v) * 0.1, dtype=torch.float32,
                     device=cuda_device)
    lab = torch.tensor(rng.integers(0, v, n), device=cuda_device)
    lab[:4] = torch.tensor([0, 63, 64, v - 1])
    count = {"library": 0, "one_per_tile": -(-v // 128)}.get(splits, splits)
    before = catalog_nll_fwd.launches
    got = _launch_fwd(h, t, b, lab, splits=count)
    assert catalog_nll_fwd.launches == before + 1
    want = catalog_nll_reference(h, t, b, lab)
    _check_by_scale(torch.float32, got, want, f"forward, splits {splits}")


@pytest.mark.parametrize("n,v,c,rows", [(333, 1001, 512, "alternating"),
                                        (333, 1001, 64, "alternating"),
                                        (4096, 2000, 512, "padded")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_catalog_backward_of_dead_rows_matches_plain_version(cuda_device,
                                                             dtype, n, v, c,
                                                             rows):
    """Rows with label 0 and dlse = dll = 0 (the train step's padded
    positions): dead and live rows mixed within and across 64-row tiles,
    or left-padded histories of 2048 positions. The backward matches the
    plain version (as ``_check_by_scale``) and its d_hidden is exactly 0
    on the dead rows; on the wgmma kernel (bf16, C = 512) and the CUDA
    cores (bf16 at C = 64, fp32)."""
    from easydgl_tpu_torch.kernels.scoring import catalog_live_rows
    rng = np.random.default_rng(n + c)
    if rows == "alternating":
        dead = (np.arange(n) // 3) % 2 == 0
        dead[64:128], dead[192:256] = True, False
    else:
        lengths = rng.integers(1, 2049, n // 2048)
        dead = (np.arange(2048)[None] < 2048 - lengths[:, None]).reshape(-1)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    h = torch.randn(n, c, generator=g, device=cuda_device).to(dtype)
    t = (torch.randn(v, c, generator=g, device=cuda_device) / 8).to(dtype)
    b = torch.randn(v, generator=g, device=cuda_device)
    lab = torch.randint(1, v, (n,), generator=g, device=cuda_device)
    dlse, dll = (torch.randn(n, generator=g, device=cuda_device)
                 for _ in range(2))
    dead_t = torch.tensor(dead, device=cuda_device)
    lab[dead_t], dlse[dead_t], dll[dead_t] = 0, 0.0, 0.0
    live = catalog_live_rows(dlse, dll)
    assert 0 < int(live.sum()) < live.numel()
    lse, _ = catalog_nll_reference(h, t, b, lab)
    got = catalog_nll_bwd(h, t, b, lab, lse, dlse, dll)
    want = catalog_nll_bwd_reference(h, t, b, lab, lse, dlse, dll)
    _check_by_scale(dtype, got, want, "dead rows")
    assert float(got[0][dead_t].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype,splits", [
    (torch.bfloat16, (1, 1)), (torch.bfloat16, (3, 7)),
    (torch.bfloat16, (16, 2)), (torch.float32, (1, 1)),
    (torch.float32, (5, 1))])
def test_catalog_backward_splits_match_plain_version(cuda_device, dtype,
                                                     splits):
    """However the backward's passes divide their work (d_hidden's vocab
    splits, d_table's row-tile splits, as the library would choose them on
    another card), it matches the plain version, with left-padded rows;
    the CUDA-core kernel refuses to split d_table."""
    from easydgl_tpu_torch.kernels.scoring import _launch_bwd
    n, v, c = 2048 + 333, 3000, 512
    g = torch.Generator(device=cuda_device).manual_seed(4)
    h = torch.randn(n, c, generator=g, device=cuda_device).to(dtype)
    t = (torch.randn(v, c, generator=g, device=cuda_device) / 8).to(dtype)
    b = torch.randn(v, generator=g, device=cuda_device)
    lab = torch.randint(1, v, (n,), generator=g, device=cuda_device)
    dlse, dll = (torch.randn(n, generator=g, device=cuda_device)
                 for _ in range(2))
    lab[:700], dlse[:700], dll[:700] = 0, 0.0, 0.0
    lse, _ = catalog_nll_reference(h, t, b, lab)
    got = _launch_bwd(h, t, b, lab, lse, dlse, dll, splits=splits)
    want = catalog_nll_bwd_reference(h, t, b, lab, lse, dlse, dll)
    _check_by_scale(dtype, got, want, f"splits {splits}")
    assert float(got[0][:700].float().abs().max()) == 0.0
    if dtype == torch.float32:
        with pytest.raises(RuntimeError):
            _launch_bwd(h, t, b, lab, lse, dlse, dll, splits=(1, 2))


def test_train_step_on_card_matches_cpu(cuda_device):
    """One fp32 EasyDGL train step at dropout 0, kernels on the card vs
    the plain versions on the CPU: loss 1e-5 relative; parameters after
    the TF-Adam update within 2 lr where the gradient is within 1e-4 of
    its leaf's scale of zero (the first Adam step is ~lr * sign(g)), else
    1e-5 + 1e-4 |p|."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                                  synthetic_split)
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import (build_train_step, init_state,
                                               loss_and_grads, to_device)
    cfg = preset("EasyDGL", num_items=60, seqslen=10, num_units=32,
                 num_heads=2, num_events=4, batch_size=4, masklen=3,
                 hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0,
                 ct_reg=0.1)
    params = random_flax_params(cfg, 0)
    table = synthetic_mark_table(60, 4, seed=1)
    ds = synthetic_split(num_rows=4, num_items=60, seqslen=10, seed=2)
    loader = BatchLoader(ds, data_mode="mau", batch_size=4, masklen=3,
                         is_training=True)
    features, labels, _ = next(loader.epoch(0))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = build_model(cfg, device=dev, params=params)
        step = build_train_step(model, mark_table=table)
        from easydgl_tpu_torch.train.steps import device_marks
        feats = device_marks(to_device(features, dev),
                             torch.as_tensor(labels, device=dev),
                             torch.as_tensor(table, dtype=torch.float32,
                                             device=dev), is_training=True)
        _, grads = loss_and_grads(model, feats, torch.as_tensor(
            labels, device=dev))
        state, loss = step(init_state(model), features, labels,
                           torch.Generator(device=dev))
        out[dev.type] = (float(loss), {k: v.detach().cpu() for k, v in
                                       state.params.items()},
                         {k: v.cpu() for k, v in grads.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for name, want in out["cpu"][1].items():
        g = out["cpu"][2][name].abs()
        near = g <= 1e-4 * float(g.max()) + 1e-12
        err = (out["cuda"][1][name] - want).abs()
        ok = (err <= 1e-5 + 1e-4 * want.abs()) | (near & (err <= 1e-3))
        assert bool(ok.all()), name


def _check_stats(dtype, got, want):
    """m, l, seq_units of the stats kernel. A row that sees no key has m =
    -(2^32)+1 exactly and would set the scale of m and l, so: m on those
    rows equal, elsewhere within tol of the largest |m| of the rows that see
    a key; l (>= 1) within tol of itself, elementwise; seq_units by scale."""
    m, l, su = got
    tol = GRAD_TOL[dtype]
    dead = want.m < -1e9
    assert torch.equal(m[dead], want.m[dead])
    live = want.m[~dead]
    assert float((m[~dead] - live).abs().max()) <= tol * float(
        live.abs().max())
    assert bool(((l - want.l).abs() <= tol * want.l).all())
    _check_by_scale(dtype, (su,), (want.su,), "seq_units")


STREAMED_SHAPES = {"small": dict(b=3, t=77, h=2, dh=16, e=4),
                   "unaligned": dict(b=2, t=300, h=8, dh=64, e=64),
                   "dh128": dict(b=2, t=130, h=2, dh=128, e=8),
                   "dh32": dict(b=2, t=65, h=4, dh=32, e=12),
                   "e128": dict(b=2, t=130, h=2, dh=64, e=128)}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(STREAMED_SHAPES))
@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_kernels_match_plain_version(cuda_device, dtype, causal,
                                              diag, shape, rate):
    """Each of the three streamed kernels on the plain version's inputs
    (so each is held on its own), then the chain: m, l, seq_units, lam and
    out against the blocked plain version; row 0 is fully masked."""
    ts, _ = _inputs(cuda_device, dtype, **STREAMED_SHAPES[shape])
    q, k, v, t, km, iv, oh, wd, bd, w, sc = ts
    h = STREAMED_SHAPES[shape]["h"]
    seed = torch.tensor(777, device=cuda_device)
    kw = dict(causal=causal, num_heads=h)
    want = mau_blocked_forward(*ts, diag_reset=diag, dropout_rate=rate,
                               dropout_seed=seed, **kw)
    before = [f.launches for f in (mau_stats, mau_intensity,
                                   mau_modulated_out)]
    m, l, su = mau_stats(q, k, t, km, **kw)
    lam = mau_intensity(want.su, iv, wd, bd, w, sc)
    out = mau_modulated_out(q, k, v, km, oh, want.lam, want.m, want.l,
                            diag_reset=diag, dropout_rate=rate,
                            dropout_seed=seed, **kw)
    chain = mau_streamed(*ts, causal, diag, rate, num_heads=h,
                         dropout_seed=seed)
    assert [f.launches for f in (mau_stats, mau_intensity,
                                 mau_modulated_out)] == [x + 2 for x in
                                                         before]
    assert out.dtype == dtype and lam.dtype == torch.float32
    _check_stats(dtype, (m, l, su), want)
    _check_by_scale(torch.float32, (lam,), (want.lam,), "intensity")
    _check_by_scale(dtype, (out,), (want.out,), "out")
    _check_by_scale(dtype, chain, (want.out, want.lam), "chain")
    # the fully masked row: uniform over its t real keys
    assert bool((l[0] == STREAMED_SHAPES[shape]["t"]).all())


def test_streamed_kernels_refuse_what_they_do_not_take(cuda_device):
    """A single kernel has no gradient of its own (mau_streamed has);
    training takes dh in (16, 32, 64); a dropout rate needs a seed; the
    head dim must be one the kernels take."""
    ts, _ = _inputs(cuda_device, torch.float32, b=2, t=40, h=2, dh=16, e=4)
    q = ts[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="differentiate mau_streamed"):
        mau_stats(q, ts[1], ts[3], ts[4], num_heads=2)
    out, _ = mau_streamed(q, *ts[1:], num_heads=2)
    assert out.requires_grad
    with pytest.raises(ValueError, match="seed"):
        mau_streamed(*ts, False, True, 0.1, num_heads=2)
    odd, _ = _inputs(cuda_device, torch.float32, b=1, t=40, h=2, dh=24, e=4)
    with pytest.raises(ValueError, match="head dim"):
        mau_streamed(*odd, num_heads=2)
    wide, _ = _inputs(cuda_device, torch.float32, b=1, t=40, h=2, dh=128,
                      e=4)
    wide[0].requires_grad_(True)
    with pytest.raises(ValueError, match="head dim"):
        mau_streamed(*wide, num_heads=2)
    many, _ = _inputs(cuda_device, torch.float32, b=1, t=40, h=2, dh=16,
                      e=129)
    fwd = mau_blocked_forward(*many, num_heads=2)
    go = torch.zeros_like(many[0])
    with pytest.raises(ValueError, match="E=129"):
        mau_glam(*many[:3], many[4], many[6], fwd.m, fwd.l, go, num_heads=2)


def test_streamed_and_fused_kernels_agree(cuda_device):
    """At T = 31, fp32, rate 0.1 and one seed, the streamed kernels and the
    fused mau_attention kernel compute one function and draw one mask."""
    ts, _ = _inputs(cuda_device, torch.float32, b=8, t=31, h=8, dh=64, e=64)
    seed = torch.tensor(4242, device=cuda_device)
    got = mau_streamed(*ts, False, True, 0.1, num_heads=8, dropout_seed=seed)
    want = mau_attention(*ts, False, True, 0.1, num_heads=8,
                         dropout_seed=seed)
    _check_by_scale(torch.float32, got, want, "streamed vs fused")


@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_output_kernel_entry_by_entry(cuda_device, dtype, causal,
                                               diag):
    """With v[j, h*dh + d] = 1 where d == j, out[i, h*dh + j] is entry
    (h, i, j) of the dropped, modulated probs, rounded once: entries the
    plain version drops or hides are 0 on both sides, the others within
    GRAD_TOL of themselves, and about a tenth of the nonzero ones dropped."""
    b, t, h, dh = 3, 100, 2, 128
    ts, _ = _inputs(cuda_device, dtype, b=b, t=t, h=h, dh=dh, e=4, seed=5)
    ts[2] = torch.eye(t, dh, device=cuda_device)[None, :, None, :].expand(
        b, t, h, dh).reshape(b, t, h * dh).to(dtype).contiguous()
    q, k, v, _, km, _, oh, *_ = ts
    seed = torch.tensor(99, device=cuda_device)
    kw = dict(causal=causal, diag_reset=diag, num_heads=h)
    want = mau_blocked_forward(*ts, dropout_rate=0.1, dropout_seed=seed, **kw)
    kept = output_reference(q, k, v, km, oh, want.lam, want.m, want.l,
                            **kw).float()
    got = mau_modulated_out(q, k, v, km, oh, want.lam, want.m, want.l,
                            dropout_rate=0.1, dropout_seed=seed, **kw).float()
    ref = want.out.float()
    zero = ref == 0
    assert torch.equal(got[zero], ref[zero])
    assert float(((got - ref).abs()[~zero] / ref.abs()[~zero]).max()) <= \
        GRAD_TOL[dtype]
    dropped = float((zero & (kept != 0)).sum() / (kept != 0).sum())
    assert 0.07 < dropped < 0.13, dropped


def test_lc_model_on_card_matches_cpu(cuda_device):
    """fp32 EasyDGL-LC logits at a small width, streamed kernels on the
    card vs the blocked plain version on the CPU: 1e-4."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                                  synthetic_split)
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import to_device
    cfg = preset("EasyDGL-LC", num_items=60, seqslen=255, num_units=64,
                 num_heads=2, num_events=4, batch_size=4, masklen=16,
                 compute_dtype="float32")
    params = random_flax_params(cfg, 0)
    ds = synthetic_split(num_rows=4, num_items=60, seqslen=255, seed=2)
    loader = BatchLoader(ds, data_mode="mau", batch_size=4,
                         is_training=False,
                         mark_table=synthetic_mark_table(60, 4, seed=1),
                         needs_marks=True)
    features, _, _ = next(loader.epoch(0))
    logits = {}
    before = mau_stats.launches
    for dev in (cuda_device, torch.device("cpu")):
        model = build_model(cfg, device=dev, params=params)
        with torch.no_grad():
            logits[dev.type] = model(to_device(features, dev))[0].cpu()
    assert mau_stats.launches == before + 1
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)


STREAMED_BWD_SHAPES = {"small": dict(b=3, t=77, h=2, dh=16, e=4),
                       "unaligned": dict(b=2, t=300, h=8, dh=64, e=64),
                       "dh32": dict(b=2, t=65, h=4, dh=32, e=12),
                       "e128": dict(b=2, t=130, h=2, dh=64, e=128)}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(STREAMED_BWD_SHAPES))
@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_backward_kernels_match_plain_version(cuda_device, dtype,
                                                       causal, diag, shape,
                                                       rate):
    """Each of the four backward kernels on the plain pieces' inputs (so
    each is held on its own), then ``_MauStreamed``'s gradients against
    ``_MauBlocked``'s; the intensity VJP is fp32 in both compute dtypes.
    A non-zero cotangent of mark_intensity, so the TPP path counts."""
    ts, _ = _inputs(cuda_device, dtype, **STREAMED_BWD_SHAPES[shape])
    q, k, v, t, km, iv, oh, wd, bd, w, sc = ts
    h = STREAMED_BWD_SHAPES[shape]["h"]
    seed = torch.tensor(31337, device=cuda_device)
    kw = dict(causal=causal, diag_reset=diag, dropout_rate=rate,
              dropout_seed=seed, num_heads=h)
    fwd = mau_blocked_forward(*ts, **kw)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    go = (torch.randn(q.shape, generator=g, device=cuda_device)
          * 1e-2).to(dtype)
    gl = torch.randn(fwd.lam.shape, generator=g, device=cuda_device) * 1e-3
    before = [f.launches for f in STREAMED_KERNELS]

    glam = mau_glam(q, k, v, km, oh, fwd.m, fwd.l, go, **kw)
    want = glam_reference(q, k, v, km, oh, fwd.m, fwd.l, go, **kw)
    _check_by_scale(dtype, (glam,), (want,), "glam")
    g_lam = want + gl
    got = mau_intensity_bwd(fwd.su, iv, wd, bd, w, sc, g_lam)
    want = intensity_vjp_reference(fwd.su, iv, wd, bd, w, sc, g_lam)
    _check_by_scale(torch.float32, got, want, "intensity vjp")
    rho = row_correction(fwd.out, go, fwd.su, want[0], h)
    p2 = (q, k, v, t, km, oh, fwd.lam, fwd.m, fwd.l, go, want[0], rho)
    dq = mau_dq(*p2, **kw)
    _check_by_scale(dtype, (dq,), (dq_reference(*p2, **kw),), "dq")
    dkvt = mau_dkvt(*p2, **kw)
    _check_by_scale(dtype, dkvt, dkvt_reference(*p2, **kw), "dkvt")
    assert all(x.dtype == dtype for x in (dq,) + dkvt)

    grads = {}
    for name, fn in (("card", mau_streamed), ("plain", mau_blocked)):
        diff = [x.clone().requires_grad_(i in (0, 1, 2, 3, 7, 8, 9, 10))
                for i, x in enumerate(ts)]
        out, lam = fn(*diff, causal, diag, rate, num_heads=h,
                      dropout_seed=seed)
        grads[name] = torch.autograd.grad(
            (out.float() * go.float()).sum() + (lam * gl).sum(),
            [diff[i] for i in (0, 1, 2, 3, 7, 8, 9, 10)])
    _check_by_scale(dtype, grads["card"], grads["plain"], "chained")
    # the pieces once each, then _MauStreamed: three forward launches,
    # each backward kernel a second time
    assert [f.launches - x for f, x in zip(STREAMED_KERNELS, before)] == [
        1, 1, 1, 2, 2, 2, 2]
    # a fully masked row: no gradient into its queries
    assert float(grads["card"][0][0].float().abs().max()) == 0.0


@pytest.mark.parametrize("dh,e,b,t", [(16, 64, 2, 1000), (32, 64, 1, 999),
                                      (64, 64, 3, 701), (16, 128, 1, 333),
                                      (32, 128, 2, 77), (64, 128, 1, 1023)])
def test_intensity_vjp_kernel_matches_plain_version(cuda_device, dh, e, b,
                                                    t):
    """The intensity VJP (split bf16 products on wgmma) against
    ``intensity_vjp_reference``: dh 16, 32, 64, E 64 and 128, H = 2 and row
    counts B * H * T that are no multiple of the 64-row tile or the
    2048-row chunk; every output held to the fp32 tolerance."""
    rng = np.random.default_rng(dh * 1000 + e + t)
    h = 2
    f32 = dict(dtype=torch.float32, device=cuda_device)
    su = torch.tensor(rng.normal(0, 0.5, (b, h, t, dh)), **f32)
    iv = torch.tensor(rng.exponential(1.0, (b, t)), **f32)
    wd = torch.tensor(rng.normal(0, 0.2, (dh + 1, e * dh)), **f32)
    bd = torch.tensor(rng.normal(0, 0.1, e * dh), **f32)
    w = torch.tensor(rng.normal(0, 0.2, (e, dh)), **f32)
    sc = torch.tensor(rng.normal(0, 0.3, e), **f32)
    g_lam = torch.tensor(rng.normal(0, 1e-3, (b, h, t, e)), **f32)
    before = mau_intensity_bwd.launches
    got = mau_intensity_bwd(su, iv, wd, bd, w, sc, g_lam)
    assert mau_intensity_bwd.launches == before + 1
    want = intensity_vjp_reference(su, iv, wd, bd, w, sc, g_lam)
    _check_by_scale(torch.float32, got, want, f"intensity vjp dh={dh} E={e}")


# dh, E, B, T: every head width, E 64 and 128 and the largest E the
# wrapper took before its split-bf16 kernel (its fp32 kernel's shared
# memory), H = 2, row counts B * H * T no multiple of the 64-row tile
@pytest.mark.parametrize("dh,e,b,t", [
    (16, 64, 2, 1000), (16, 128, 1, 333), (16, 888, 1, 77),
    (32, 64, 1, 999), (32, 128, 2, 77), (32, 871, 1, 65),
    (64, 64, 3, 701), (64, 128, 1, 1023), (64, 837, 1, 33),
    (128, 64, 2, 130), (128, 128, 1, 333), (128, 769, 1, 77)])
def test_intensity_kernel_matches_plain_version(cuda_device, dh, e, b, t):
    """The intensity head (split bf16 products on wgmma) against
    ``intensity_reference`` at the fp32 tolerance, one launch a call."""
    rng = np.random.default_rng(dh * 1000 + e + t + 7)
    h = 2
    f32 = dict(dtype=torch.float32, device=cuda_device)
    su = torch.tensor(rng.normal(0, 0.5, (b, h, t, dh)), **f32)
    iv = torch.tensor(rng.exponential(1.0, (b, t)), **f32)
    wd = torch.tensor(rng.normal(0, 0.2, (dh + 1, e * dh)), **f32)
    bd = torch.tensor(rng.normal(0, 0.1, e * dh), **f32)
    w = torch.tensor(rng.normal(0, 0.2, (e, dh)), **f32)
    sc = torch.tensor(rng.normal(0, 0.3, e), **f32)
    before = mau_intensity.launches
    got = mau_intensity(su, iv, wd, bd, w, sc)
    assert mau_intensity.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, h, t, e)
    want = intensity_reference(su, iv, wd, bd, w, sc)
    _check_by_scale(torch.float32, (got,), (want,), f"intensity dh={dh} E={e}")


def _dq_key_mask(b, tk):
    """Key masks for dq: row 0 has no real key; row 1 a blind prefix under
    causal (its first real key at 100, inside a tile); row 2 key tiles
    with no real key between live ones; row 3 every key real."""
    km = np.zeros((b, tk), np.float32)
    km[1, 100:] = 1.0
    km[2, 5:40] = 1.0
    km[2, 180:] = 1.0
    km[3] = 1.0
    return km


@pytest.mark.parametrize("tq,tk", [(300, 300), (200, 300), (300, 200)])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_kernel_on_blind_rows_and_empty_key_tiles(cuda_device, dtype,
                                                        causal, dh, tq, tk):
    """``mau_stats`` against ``stats_reference`` on a batch row with no real
    key, a causal blind prefix, key tiles with no real key and Tq != Tk: m,
    l and seq_units held as the streamed cases hold them, one launch, and a
    row that sees no key uniform over every key (l = Tk exactly)."""
    rng = np.random.default_rng(tq + 3 * tk + dh + int(causal))
    b, h = 4, 2
    c = h * dh
    f32 = dict(dtype=torch.float32, device=cuda_device)
    q = torch.tensor(rng.normal(size=(b, tq, c)), **f32).to(dtype)
    k, t = (torch.tensor(rng.normal(size=(b, tk, c)), **f32).to(dtype)
            for _ in range(2))
    km = torch.tensor(_dq_key_mask(b, tk), **f32)
    before = mau_stats.launches
    got = mau_stats(q, k, t, km, causal=causal, num_heads=h)
    assert mau_stats.launches == before + 1
    assert all(x.dtype == torch.float32 for x in got)
    assert got[2].shape == (b, h, tq, dh)
    want = stats_reference(q, k, t, km, causal=causal, num_heads=h)
    _check_stats(dtype, got, SimpleNamespace(m=want[0], l=want[1],
                                             su=want[2]))
    assert bool((got[1][0] == tk).all())
    if causal:
        assert bool((got[1][1, :, :100] == tk).all())


@pytest.mark.parametrize("tq,tk", [(300, 300), (200, 300), (300, 200)])
@pytest.mark.parametrize("dh,e", [(32, 12), (64, 64)])
@pytest.mark.parametrize("causal,diag", [(False, True), (True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_kernel_on_blind_rows_and_empty_key_tiles(cuda_device, dtype,
                                                     causal, diag, dh, e, tq,
                                                     tk):
    """``mau_dq`` against ``dq_reference`` (dropout 0.1) on a batch row with
    no real key, a causal blind prefix, key tiles with no real key and
    Tq != Tk: held by scale, and exactly 0 on the rows that see no key."""
    rng = np.random.default_rng(tq + 7 * tk + dh + int(causal))
    b, h = 4, 2
    c = h * dh
    f32 = dict(dtype=torch.float32, device=cuda_device)
    q = torch.tensor(rng.normal(size=(b, tq, c)), **f32).to(dtype)
    k, v, t = (torch.tensor(rng.normal(size=(b, tk, c)), **f32).to(dtype)
               for _ in range(3))
    km = torch.tensor(_dq_key_mask(b, tk), **f32)
    oh = torch.tensor((rng.random((b, tk, e)) < 0.2).astype(np.float32),
                      **f32)
    lam = torch.tensor(rng.random((b, h, tq, e)), **f32)
    go = (torch.tensor(rng.normal(0, 1e-2, (b, tq, c)), **f32)).to(dtype)
    g_su = torch.tensor(rng.normal(0, 1e-2, (b, h, tq, dh)), **f32)
    rho = torch.tensor(rng.normal(0, 1e-3, (b, h, tq)), **f32)
    m, l, _ = stats_reference(q, k, t, km, causal=causal, num_heads=h)
    seed = torch.tensor(2024, device=cuda_device)
    kw = dict(causal=causal, diag_reset=diag, dropout_rate=0.1,
              dropout_seed=seed, num_heads=h)
    args = (q, k, v, t, km, oh, lam, m, l, go, g_su, rho)
    before = mau_dq.launches
    dq = mau_dq(*args, **kw)
    assert mau_dq.launches == before + 1
    assert dq.dtype == dtype and dq.shape == q.shape
    _check_by_scale(dtype, (dq,), (dq_reference(*args, **kw),), "dq")
    assert float(dq[0].float().abs().max()) == 0.0
    if causal:
        assert float(dq[1, :100].float().abs().max()) == 0.0


def test_lc_train_step_on_card_matches_cpu(cuda_device):
    """One fp32 EasyDGL-LC train step at a small width (L+1 = 256,
    dh = 32) and dropout 0, streamed kernels on the card vs ``_MauBlocked``
    on the CPU: loss 1e-5 relative; every gradient within 1e-4 of its
    leaf's largest entry; parameters after the TF-Adam update within 2 lr
    where the gradient is within 1e-4 of its leaf's scale of zero, else
    1e-5 + 1e-4 |p|."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                                  synthetic_split)
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import (build_train_step, device_marks,
                                               init_state, loss_and_grads,
                                               to_device)
    cfg = preset("EasyDGL-LC", num_items=60, seqslen=255, num_units=64,
                 num_heads=2, num_events=4, batch_size=2, masklen=16,
                 compute_dtype="float32", hidden_dropout_rate=0.0,
                 attention_probs_dropout_rate=0.0, ct_reg=0.1)
    params = random_flax_params(cfg, 0)
    table = synthetic_mark_table(60, 4, seed=1)
    ds = synthetic_split(num_rows=2, num_items=60, seqslen=255, seed=2)
    features, labels, _ = next(BatchLoader(
        ds, data_mode="mau", batch_size=2, masklen=16,
        is_training=True).epoch(0))
    out = {}
    before = mau_dkvt.launches
    for dev in (cuda_device, torch.device("cpu")):
        model = build_model(cfg, device=dev, params=params)
        lab = torch.as_tensor(labels, device=dev)
        feats = device_marks(to_device(features, dev), lab,
                             torch.as_tensor(table, dtype=torch.float32,
                                             device=dev), is_training=True)
        _, grads = loss_and_grads(model, feats, lab)
        state, loss = build_train_step(model, mark_table=table)(
            init_state(model), features, labels, torch.Generator(device=dev))
        out[dev.type] = (float(loss), {k: v.detach().cpu() for k, v in
                                       state.params.items()},
                         {k: v.cpu() for k, v in grads.items()})
    assert mau_dkvt.launches == before + 2
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for name, want in out["cpu"][2].items():
        err = float((out["cuda"][2][name] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-12, name
    for name, want in out["cpu"][1].items():
        g = out["cpu"][2][name].abs()
        near = g <= 1e-4 * float(g.max()) + 1e-12
        err = (out["cuda"][1][name] - want).abs()
        ok = (err <= 1e-5 + 1e-4 * want.abs()) | (near & (err <= 1e-3))
        assert bool(ok.all()), name


# ---------------------------------------------------------------- flash

FLASH_SHAPES = {"t77_dh16": dict(b=3, h=2, tq=77, tk=77, dh=16),
                "t300_dh64": dict(b=2, h=4, tq=300, tk=300, dh=64),
                "tq100_tk300_dh32": dict(b=2, h=2, tq=100, tk=300, dh=32),
                # whole batch rows of padding (0 and 2) beside full rows
                "t200_dead_rows_dh64": dict(b=4, h=2, tq=200, tk=200, dh=64,
                                            pad=(200, 70, 200, 0)),
                # Tk not a multiple of 64, padding ending mid-tile
                "t333_midtile_dh64": dict(b=2, h=2, tq=333, tk=333, dh=64,
                                          pad=(0, 100))}


def _flash_inputs(dev, dtype, *, b, h, tq, tk, dh, dv=None, seed=0,
                  pad=None, qk_std=1.0):
    """numpy-drawn q, k (B, H, T, dh) ~ N(0, qk_std^2), v, dO (B, H, T, dv,
    default dh); a key mask with holes, left-padded where Tq == Tk (``pad``
    keys a row, else random lengths), with row 0 fully masked."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dv = dh if dv is None else dv
    q = (qk_std * rng.normal(size=(b, h, tq, dh))).astype(f32)
    dout = rng.normal(size=(b, h, tq, dv)).astype(f32)
    k = (qk_std * rng.normal(size=(b, h, tk, dh))).astype(f32)
    v = rng.normal(size=(b, h, tk, dv)).astype(f32)
    km = (rng.random((b, tk)) > 0.1).astype(f32)
    if tq == tk:
        lengths = (rng.integers(1, tk + 1, b) if pad is None
                   else tk - np.minimum(pad, tk))
        km *= np.arange(tk)[None] >= tk - lengths[:, None]
    km[0] = 0.0
    ts = [torch.tensor(x, device=dev) for x in (q, k, v, km, dout)]
    return [x.to(dtype) if i != 3 else x for i, x in enumerate(ts)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(FLASH_SHAPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_version(cuda_device, dtype, causal, shape,
                                           rate):
    _check_flash_kernels(cuda_device, dtype, causal, FLASH_SHAPES[shape],
                         rate)


def test_flash_kernels_at_the_bert4rec_lc_shape(cuda_device):
    """BERT4REC-LC's attention (B=2 of its 32, H=8, T=2048, dh=64): bf16,
    not causal, dropout 0.1; a row of padding beside one whose padding
    ends mid-tile."""
    _check_flash_kernels(cuda_device, torch.bfloat16, False,
                         dict(b=2, h=8, tq=2048, tk=2048, dh=64,
                              pad=(2048, 700)), 0.1)


def _check_flash_kernels(cuda_device, dtype, causal, shape, rate):
    """Forward (out, lse) and the backward (dq, dk, dv), each on the plain
    version's inputs; then ``flash_attention``'s chained backward against
    the chained plain pieces. out as ``_check_close``; lse fp32 to 1e-4;
    the gradients as ``_check_by_scale``; every batch row with no visible
    key exactly 0."""
    from easydgl_tpu_torch.kernels import flash_attention as fl
    q, k, v, km, dout = _flash_inputs(cuda_device, dtype, **shape)
    kw = dict(causal=causal, dropout_rate=rate,
              seed=torch.tensor(77, device=cuda_device))
    before = [fn.launches for fn in fl.FLASH_KERNELS]
    out, lse = fl.flash_attention_fwd(q, k, v, km, **kw)
    want_o, want_l = fl.flash_fwd_reference(q, k, v, km, **kw)
    scale = want_o if dtype == torch.float32 else fl.flash_fwd_reference(
        q, k, v.abs(), km, **kw)[0]
    _check_close(dtype, (out, lse), (want_o, want_l), scale)
    torch.testing.assert_close(lse, want_l, atol=1e-4, rtol=1e-4)
    delta = fl.flash_delta(dout, want_o)
    args = (q, k, v, km, dout, want_l, delta)
    grads = fl.flash_attention_bwd(*args, **kw)
    _check_by_scale(dtype, grads, fl.flash_bwd_reference(*args, **kw),
                    "pieces")
    assert [fn.launches for fn in fl.FLASH_KERNELS] == [b + 1 for b in before]
    dead = [r for r in range(km.shape[0]) if not bool((km[r] > 0).any())]
    assert 0 in dead
    for x in (out,) + grads:
        for r in dead:
            assert float(x[r].float().abs().max()) == 0.0
    diff = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(fl.flash_attention(*diff, km, **kw), diff,
                              dout)
    p_out, p_lse = fl.flash_fwd_reference(q, k, v, km, **kw)
    p_args = (q, k, v, km, dout, p_lse, fl.flash_delta(dout, p_out))
    _check_by_scale(dtype, got, fl.flash_bwd_reference(*p_args, **kw),
                    "chain")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", ["t200_dead_rows_dh64",
                                   "t333_midtile_dh64"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_dh128_matches_plain_version(cuda_device, dtype,
                                                   causal, shape, rate):
    """The forward at dh = 128 (the wgmma kernel in bf16, the CUDA cores in
    fp32; the backward does not take it) on whole rows of padding and on
    padding that ends mid-tile: out as ``_check_close``, lse fp32 to 1e-4,
    out exactly 0 on every batch row with no visible key."""
    from easydgl_tpu_torch.kernels import flash_attention as fl
    q, k, v, km, _ = _flash_inputs(cuda_device, dtype,
                                   **dict(FLASH_SHAPES[shape], dh=128))
    kw = dict(causal=causal, dropout_rate=rate,
              seed=torch.tensor(78, device=cuda_device))
    out, lse = fl.flash_attention_fwd(q, k, v, km, **kw)
    want_o, want_l = fl.flash_fwd_reference(q, k, v, km, **kw)
    scale = want_o if dtype == torch.float32 else fl.flash_fwd_reference(
        q, k, v.abs(), km, **kw)[0]
    _check_close(dtype, (out, lse), (want_o, want_l), scale)
    torch.testing.assert_close(lse, want_l, atol=1e-4, rtol=1e-4)
    dead = [r for r in range(km.shape[0]) if not bool((km[r] > 0).any())]
    for r in dead:
        assert float(out[r].float().abs().max()) == 0.0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_run_to_run(cuda_device, dtype, rate):
    """Two launches of the backward on the same inputs: dk and dv are each
    one block's sums and agree exactly; dq sums a row's key tiles by fp32
    atomics in the order the blocks run, so it is held to the
    kernel-vs-plain tolerance of ``_check_by_scale``."""
    from easydgl_tpu_torch.kernels import flash_attention as fl
    q, k, v, km, dout = _flash_inputs(cuda_device, dtype,
                                      **FLASH_SHAPES["t333_midtile_dh64"])
    kw = dict(causal=True, dropout_rate=rate,
              seed=torch.tensor(5, device=cuda_device))
    out, lse = fl.flash_attention_fwd(q, k, v, km, **kw)
    args = (q, k, v, km, dout, lse, fl.flash_delta(dout, out))
    first = fl.flash_attention_bwd(*args, **kw)
    second = fl.flash_attention_bwd(*args, **kw)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    _check_by_scale(dtype, second[:1], first[:1], "rerun")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_draw_one_dropout_mask(cuda_device, dtype):
    """q = 0 and k = v = I: out, dq (dO = 1) and dv (dO = I) show the keep
    factor of every (i, j) as the kernels drew it; each equals
    ``dropout_factor`` exactly."""
    from easydgl_tpu_torch.kernels import flash_attention as fl
    from easydgl_tpu_torch.kernels.mau_attention import dropout_factor
    b, h, t, rate = 2, 2, 64, 0.25
    dev = cuda_device
    eye = torch.eye(t, device=dev).expand(b, h, t, t).to(dtype).contiguous()
    q = torch.zeros(b, h, t, t, device=dev, dtype=dtype)
    ones = torch.ones(b, h, t, t, device=dev, dtype=dtype)
    km = torch.ones(b, t, device=dev)
    kw = dict(causal=False, dropout_rate=rate, scale=1.0,
              seed=torch.tensor(123, device=dev))
    out, lse = fl.flash_attention_fwd(q, eye, eye, km, **kw)
    delta = fl.flash_delta(ones, out)
    dq = fl.flash_attention_bwd(q, eye, eye, km, ones, lse, delta, **kw)[0]
    dv = fl.flash_attention_bwd(q, eye, eye, km, eye, lse,
                                fl.flash_delta(eye, out), **kw)[2]
    keep = dropout_factor(123, (b, h, t, t), rate, dev)
    # out: p = exp(0) = 1 exactly, so out * t is keep rounded to the
    # compute dtype; dv and dq carry p = exp(-log t), within an ulp of 1/t,
    # rounded to bf16 once (dv) or twice (dq: ds, then dq) in bf16
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(out.float() * t, keep.to(dtype).float(),
                               atol=0, rtol=0)
    torch.testing.assert_close(dv.transpose(-1, -2).float() * t, keep,
                               atol=0, rtol=1e-2 if bf16 else 1e-5)
    torch.testing.assert_close(dq.float() * t + delta[..., None], keep,
                               atol=2e-2 if bf16 else 1e-5, rtol=0)


def test_flash_kernels_refuse_what_they_do_not_take(cuda_device):
    """Any head width runs (widths the narrow kernels do not take, dh = 24
    and the backward at 128, take the wide kernels); k of another width
    than q, a dtype other than fp32 / bf16, dropout without a seed and a
    gradient of one kernel are refused."""
    from easydgl_tpu_torch.kernels import flash_attention as fl
    q, k, v, km, dout = _flash_inputs(cuda_device, torch.float32, b=1, h=1,
                                      tq=8, tk=8, dh=24)
    out, lse = fl.flash_attention_fwd(q, k, v, km)
    with pytest.raises(ValueError, match="shape"):
        fl.flash_attention_fwd(q, k[..., :16], v, km)
    q, k, v, km, dout = _flash_inputs(cuda_device, torch.float32, b=1, h=1,
                                      tq=8, tk=8, dh=128)
    out, lse = fl.flash_attention_fwd(q, k, v, km)
    fl.flash_attention_bwd(q, k, v, km, dout, lse, lse)
    with pytest.raises(ValueError, match="dtype"):
        fl.flash_attention_fwd(q.half(), k.half(), v.half(), km)
    with pytest.raises(ValueError, match="seed"):
        fl.flash_attention(q, k, v, km, dropout_rate=0.1)
    with pytest.raises(RuntimeError, match="differentiate"):
        fl.flash_attention_fwd(q.requires_grad_(), k, v, km)


def test_sasrec_lc_model_on_card_matches_cpu(cuda_device):
    """A small fp32 SASREC-LC (L=256, the flash kernels on the card, the
    plain version on the CPU): logits to 1e-4, and the train-step loss and
    every gradient leaf to 1e-4 of its scale (the key bias, zero in exact
    arithmetic, to 1e-4 of the key weight's)."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import synthetic_split
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import loss_and_grads, to_device
    cfg = preset("SASREC-LC", num_items=60, seqslen=256, num_units=64,
                 num_heads=2, batch_size=3, compute_dtype="float32",
                 hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0)
    params = random_flax_params(cfg, 0)
    ds = synthetic_split(num_rows=3, num_items=60, seqslen=256, seed=2)
    feats = {}
    for train in (False, True):
        f, lab, _ = next(BatchLoader(ds, data_mode="regressive", batch_size=3,
                                     is_training=train).epoch(0))
        feats[train] = (f, lab)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = build_model(cfg, device=dev, params=params)
        with torch.no_grad():
            logits = model(to_device(feats[False][0], dev))[0].cpu()
        loss, grads = loss_and_grads(model, to_device(feats[True][0], dev),
                                     torch.as_tensor(feats[True][1],
                                                     device=dev))
        res[dev.type] = (logits, float(loss),
                         {n: g.cpu() for n, g in grads.items()})
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    assert abs(res["cuda"][1] - res["cpu"][1]) <= 1e-5 * abs(res["cpu"][1])
    gc, gp = res["cuda"][2], res["cpu"][2]
    for name, want in gp.items():
        ref = gp[name[:-4] + "weight"] if name.endswith("_attn.k.bias") \
            else want
        err = float((gc[name] - want).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (name, err)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bert4rec_lc_model_kernels_match_plain_engine(cuda_device, rate):
    """A small fp32 BERT4REC-LC (L+1=256, C=64, H=2) on the card with the
    flash kernels against the same model with its long-context engine's
    plain version (``long_context_engine``), on the same generator seed:
    the plain flash version draws the kernels' dropout mask, so the two
    agree at dropout 0.1 too. Eval logits on a batch with a row of no key
    at all (every attention row the mean of V, not the kernel's zeros) to
    1e-4; the training forward's loss to 1e-5 relative and every gradient
    leaf to 1e-4 of its scale (the key bias, zero in exact arithmetic, to
    1e-4 of the key weight's); the flash kernels launched once a block."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import synthetic_split
    from easydgl_tpu_torch.kernels import flash_attention as fl
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import loss_and_grads, to_device
    cfg = preset("BERT4REC-LC", num_items=60, seqslen=255, masklen=32,
                 num_units=64, num_heads=2, batch_size=3,
                 compute_dtype="float32", hidden_dropout_rate=rate,
                 attention_probs_dropout_rate=rate)
    params = random_flax_params(cfg, 0)
    ds = synthetic_split(num_rows=3, num_items=60, seqslen=255, seed=2)
    feats = {}
    for train in (False, True):
        f, lab, _ = next(BatchLoader(ds, data_mode="masked", batch_size=3,
                                     masklen=32, is_training=train).epoch(0))
        feats[train] = (to_device(f, cuda_device),
                        torch.as_tensor(lab, device=cuda_device))
    feats[False][0]["seqs_i"][0] = 0     # a row that sees no key
    module, name, plain = type(build_model(
        cfg, device=cuda_device, params=params)).long_context_engine
    saved, res = getattr(module, name), {}
    for engine in ("kernels", "plain"):
        model = build_model(cfg, device=cuda_device, params=params)
        before = [fn.launches for fn in fl.FLASH_KERNELS]
        if engine == "plain":
            setattr(module, name, plain)
        try:
            with torch.no_grad():
                logits = model(feats[False][0])[0]
            gen = torch.Generator(device=cuda_device).manual_seed(7)
            loss, grads = loss_and_grads(model, *feats[True], gen)
        finally:
            setattr(module, name, saved)
        after = [fn.launches - b for fn, b in zip(fl.FLASH_KERNELS, before)]
        assert after == ([4, 2] if engine == "kernels" else [0, 0])
        res[engine] = (logits, float(loss), grads)
    (lk, loss_k, gk), (lp, loss_p, gp) = res["kernels"], res["plain"]
    assert bool(torch.isfinite(lk).all())
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for pname, want in gp.items():
        ref = gp[pname[:-4] + "weight"] if pname.endswith("_attn.k.bias") \
            else want
        err = float((gk[pname] - want).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (pname, err)


def _ctsma_batch(cfg, rows, seed, train, dev):
    """A regressive_entire batch of ``cfg`` (left-padded synthetic
    histories, start time 1e9 s, marks from a seeded table) on ``dev``."""
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                                  synthetic_split)
    from easydgl_tpu_torch.train.steps import to_device
    ds = synthetic_split(num_rows=rows, num_items=cfg.num_items,
                         seqslen=cfg.seqslen, seed=seed)
    f, lab, _ = next(BatchLoader(
        ds, data_mode="regressive_entire", batch_size=rows,
        is_training=train, needs_marks=True,
        mark_table=synthetic_mark_table(cfg.num_items, cfg.num_events,
                                        seed=seed)).epoch(0))
    return to_device(f, dev), torch.as_tensor(lab, device=dev)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ctsma_lc_model_kernels_match_plain_engine(cuda_device, rate):
    """A small fp32 CTSMA-LC (L=256, C=64, H=2, E=4, causal) on the card
    with the seven streamed kernels against the same model with its
    long-context engine's plain version (``long_context_engine``:
    ``mau_blocked`` and ``_MauBlocked``), on the same generator seed (both
    draw one dropout mask from it). Left-padded histories, so rows that see
    no key under the causal mask, and an eval row with no key at all. Eval
    logits and intensities to 1e-4; the training loss (its TPP term set by
    those rows' raw spans) to 1e-5 relative and every gradient leaf to 1e-4
    of its scale (a key bias, zero in exact arithmetic, to 1e-4 of its key
    weight's); the streamed kernels launched once a block a pass."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import loss_and_grads
    cfg = preset("CTSMA-LC", num_items=60, seqslen=256, num_units=64,
                 num_heads=2, num_events=4, batch_size=3, ct_reg=1e-3,
                 compute_dtype="float32", hidden_dropout_rate=rate,
                 attention_probs_dropout_rate=rate)
    params = random_flax_params(cfg, 0)
    evalb = _ctsma_batch(cfg, 3, 2, False, cuda_device)
    evalb[0]["seqs_i"][0] = 0            # a row that sees no key at all
    trainb = _ctsma_batch(cfg, 3, 3, True, cuda_device)
    ids = trainb[0]["seqs_i"]
    assert bool((ids[:, 0] == 0).any()) and bool((ids[:, -1] != 0).all())
    model_cls = type(build_model(cfg, device=cuda_device, params=params))
    module, name, plain = model_cls.long_context_engine
    saved, res = getattr(module, name), {}
    for engine in ("kernels", "plain"):
        model = build_model(cfg, device=cuda_device, params=params)
        before = [fn.launches for fn in STREAMED_KERNELS]
        if engine == "plain":
            setattr(module, name, plain)
        try:
            with torch.no_grad():
                logits, aux = model(evalb[0])
            gen = torch.Generator(device=cuda_device).manual_seed(7)
            loss, grads = loss_and_grads(model, *trainb, gen)
        finally:
            setattr(module, name, saved)
        after = [fn.launches - b for fn, b in zip(STREAMED_KERNELS, before)]
        assert after == ([2, 2, 2, 1, 1, 1, 1] if engine == "kernels"
                         else [0] * 7)
        res[engine] = (logits, aux["intensities"][0], float(loss), grads)
    (lk, ik, loss_k, gk), (lp, ip, loss_p, gp) = res["kernels"], res["plain"]
    assert bool(torch.isfinite(lk).all())
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ik, ip, atol=1e-4, rtol=1e-4)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for pname, want in gp.items():
        ref = gp[pname[:-4] + "weight"] if pname.endswith("_mau.k.bias") \
            else want
        err = float((gk[pname] - want).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (pname, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ctsma_fused_case_matches_plain_version(cuda_device, dtype):
    """The fused kernels as PRESETS["CTSMA"] drives them: dh = 128 (H = 4),
    causal without the diagonal reset, dropout 0.2, distinct Q and K
    tensors, on a CTSMA batch's key mask (left padding: rows that see no
    key) and spans (unclipped: the last padding row's is the first real
    item's whole timestamp, ~11,574 days), T = 30. The forward and the
    backward against the plain versions, the same seed on both sides."""
    from easydgl_tpu_torch.config import preset
    cfg = preset("CTSMA", num_items=300, num_events=64)
    feats, _ = _ctsma_batch(cfg, 6, 4, True, cuda_device)
    ids = feats["seqs_i"]
    b, t = ids.shape
    ts = feats["seqs_t"] / cfg.time_scale
    km = (ids != 0).float()
    iv = ts[:, 1:] - ts[:, :-1]
    assert t == 30 and float(iv.max()) > 1e4 and bool((km[:, 0] == 0).any())
    g = torch.Generator(device=cuda_device).manual_seed(5)
    h, dh, e = 4, 128, 64
    q, k, v, tt = (torch.randn(b, t, h * dh, generator=g, device=cuda_device)
                   .to(dtype) for _ in range(4))
    oh = feats["seqs_marks"]
    wd = torch.randn(dh + 1, e * dh, generator=g, device=cuda_device) * 0.2
    bd = torch.randn(e * dh, generator=g, device=cuda_device) * 0.1
    w = torch.randn(e, dh, generator=g, device=cuda_device) * 0.2
    sc = torch.randn(e, generator=g, device=cuda_device) * 0.3
    ts_ = [q, k, v, tt, km, iv, oh, wd, bd, w, sc]
    diff = [x.clone().requires_grad_(i < 4 or i > 6)
            for i, x in enumerate(ts_)]
    seed = torch.tensor(1234, device=cuda_device)
    before = (mau_attention.launches, mau_attention_bwd.launches)
    out, lam = mau_attention(*diff, True, False, 0.2, num_heads=h,
                             dropout_seed=seed)
    want_o, want_l = mau_attention_reference(
        *ts_, causal=True, diag_reset=False, dropout_rate=0.2,
        dropout_seed=seed, num_heads=h)
    go = torch.randn(out.shape, generator=g, device=cuda_device).to(dtype)
    gl = torch.randn(lam.shape, generator=g, device=cuda_device)
    grads = torch.autograd.grad((out.float() * go.float()).sum()
                                + (lam * gl).sum(),
                                [diff[i] for i in (0, 1, 2, 3, 7, 8, 9, 10)])
    assert (mau_attention.launches, mau_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _check_by_scale(dtype, (out, lam), (want_o, want_l), "forward")
    want = mau_attention_bwd_reference(
        *ts_, go, gl, causal=True, diag_reset=False, dropout_rate=0.2,
        dropout_seed=seed, num_heads=h)
    _check_by_scale(dtype, grads, want, "backward")


def _tiny_harness(num_rows):
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                                  synthetic_split)
    cfg = preset("EasyDGL", num_items=60, seqslen=10, num_units=32,
                 num_heads=2, num_events=4, batch_size=8, masklen=3)
    splits = [synthetic_split(num_rows=n, num_items=60, seqslen=10, seed=s)
              for n, s in ((num_rows, 1), (8, 2), (8, 3))]
    return cfg, splits, synthetic_mark_table(60, 4, seed=4)


def test_train_loop_on_card_launches_the_kernels(cuda_device, tmp_path):
    """``train_model`` on the card at a tiny size: each step and eval batch
    launches the MAU kernels and each step the catalog kernels (the
    wrappers' counts and the profiler's kernel names); the checkpoint it
    writes restores to the same weights."""
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.train.checkpoint import Checkpointer
    from easydgl_tpu_torch.train.loop import train_model
    from easydgl_tpu_torch.train.steps import init_state
    cfg, (tr, vl, te), table = _tiny_harness(24)
    counters = (mau_attention, mau_attention_bwd, catalog_nll_fwd,
                catalog_nll_bwd)
    for fn in counters:
        fn.launches = 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, summary = train_model(cfg, tr, vl, te, mark_table=table,
                                     ckpt_dir=str(tmp_path), num_epochs=1)
        torch.cuda.synchronize()
    assert state.step == 3 and np.isfinite(summary["N10"])
    assert [fn.launches for fn in counters] == [3 + 2, 3, 3, 3]
    names = " ".join(e.key for e in prof.key_averages())
    for kernel in ("mau_fwd", "mau_bwd", "catalog"):
        assert kernel in names, kernel
    assert next(iter(state.params.values())).is_cuda
    fresh = build_model(cfg.replace(seed=cfg.seed + 1), device="cuda")
    restored = Checkpointer(str(tmp_path)).restore(init_state(fresh))
    for name, want in state.params.items():
        assert torch.equal(restored.params[name], want), name


@pytest.mark.parametrize("size", [1, 2, 3])
def test_device_prefetch_gives_back_the_loader_batches(cuda_device, size):
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.train.loop import device_prefetch
    cfg, (tr, _, _), table = _tiny_harness(60)
    loader = BatchLoader(tr, data_mode="mau", batch_size=8, masklen=3,
                         is_training=True, mark_table=table,
                         needs_marks=True)
    want = list(loader.epoch(1))
    got = list(device_prefetch(loader.epoch(1), size=size))
    assert len(got) == len(want) == 8
    for (gf, gl, gv), (wf, wl, wv) in zip(got, want):
        assert set(gf) == set(wf)
        for key, arr in wf.items():
            assert gf[key].is_cuda
            np.testing.assert_array_equal(gf[key].cpu().numpy(), arr)
        np.testing.assert_array_equal(gl.cpu().numpy(), wl)
        np.testing.assert_array_equal(gv.cpu().numpy(), wv)


# GRU4REC, S2PNM and TiSASREC (both interval forms): no kernel on their
# forward, the catalog kernels in their train step.
RECURRENT_AND_INTERVAL = {"GRU4REC": {}, "S2PNM": {}, "TiSASREC": {},
                          "TiSASREC-factored": dict(attention_impl="factored")}


def _small_cfg(name, compute_dtype):
    from easydgl_tpu_torch.config import preset
    kw = dict(RECURRENT_AND_INTERVAL[name])
    return preset(name.split("-")[0], num_items=60, seqslen=10, num_units=64,
                  num_heads=1 if name == "S2PNM" else 2, batch_size=4,
                  timelen=12, compute_dtype=compute_dtype,
                  hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0,
                  **kw)


def _small_batch(cfg, train):
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import synthetic_split
    ds = synthetic_split(num_rows=4, num_items=60, seqslen=10, seed=2)
    f, lab, _ = next(BatchLoader(ds, data_mode="regressive", batch_size=4,
                                 is_training=train).epoch(0))
    return f, lab


@pytest.mark.parametrize("name", list(RECURRENT_AND_INTERVAL))
def test_recurrent_and_interval_models_on_card_match_cpu(cuda_device, name):
    """Eval logits (C = 64, L = 10), the card against the CPU: fp32 to
    1e-4; bf16 (the same ops, sums in another order, where one flipped
    bf16 rounding of the GRU's carry or of an activation moves a logit by
    about 2^-8 of its scale) to 2e-2 of the largest logit, the padding
    item's -1000 column left out."""
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import to_device
    for dtype in ("float32", "bfloat16"):
        cfg = _small_cfg(name, dtype)
        params = random_flax_params(cfg, 0)
        feats = _small_batch(cfg, False)[0]
        logits = {}
        for dev in (cuda_device, torch.device("cpu")):
            model = build_model(cfg, device=dev, params=params)
            with torch.no_grad():
                logits[dev.type] = model(to_device(feats, dev))[0].cpu()
        got, want = logits["cuda"][:, 1:], logits["cpu"][:, 1:]
        if dtype == "float32":
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            err = float((got - want).abs().max())
            assert err <= 2e-2 * float(want.abs().max()), (dtype, err)


@pytest.mark.parametrize("name", list(RECURRENT_AND_INTERVAL))
def test_recurrent_and_interval_train_step_runs_catalog_kernels(cuda_device,
                                                                name):
    """A train step (C = 64) in bf16 and in fp32 launches the catalog
    forward and backward once each, and so does each ``build_train_step``
    step. Its loss equals the loss through the catalog's plain version on
    the card (``catalog_nll_written_out``, whose backward rounds g to the
    compute dtype before both products as the kernels do) to 1e-5
    relative, and each gradient leaf that one's to 1e-4 (fp32) or 1e-2
    (bf16) of its scale; a key bias, 0 in exact arithmetic, to its key
    weight's."""
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train import steps
    counts = lambda: (catalog_nll_fwd.launches,  # noqa: E731
                      catalog_nll_bwd.launches)
    for dtype, tol in (("bfloat16", 1e-2), ("float32", 1e-4)):
        cfg = _small_cfg(name, dtype)
        model = build_model(cfg, device=cuda_device,
                            params=random_flax_params(cfg, 0))
        f, lab = _small_batch(cfg, True)
        feats = steps.to_device(f, cuda_device)
        labels = torch.as_tensor(lab, device=cuda_device)
        for fn in (catalog_nll_fwd, catalog_nll_bwd):
            fn.launches = 0
        loss, grads = steps.loss_and_grads(model, feats, labels)
        assert counts() == (1, 1) and np.isfinite(float(loss))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(steps, "catalog_nll", catalog_nll_written_out)
            loss_p, grads_p = steps.loss_and_grads(model, feats, labels)
        assert counts() == (1, 1)
        state, loss1 = steps.build_train_step(model)(
            steps.init_state(model), f, lab, torch.Generator(device="cuda"))
        assert counts() == (2, 2)
        assert np.isfinite(float(loss1)) and state.step == 1
        assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
        for n, want in grads_p.items():
            ref = grads_p[n[:-4] + "weight"] if n.endswith("attn.k.bias") \
                else want
            err = float((grads[n] - want).abs().max())
            assert err <= tol * float(ref.abs().max()), (
                dtype, n, err, float(ref.abs().max()))


@pytest.mark.parametrize("rows,length,max_days,timelen",
                         [(4, 9, 12, 8), (512, 31, 300, 256)])
def test_interval_buckets_on_card_equal_cpu_on_day_boundaries(
        cuda_device, rows, length, max_days, timelen):
    """TiSASREC's buckets of whole-day stamps (``day_boundary_stamps``), at
    the CPU tests' shape and at the preset's (B = 512, L = 30, timelen
    256): on the card equal to the CPU's and to numpy's fp32 ones, which
    the CPU tests hold equal to the JAX model's run op by op. Dividing by
    a Python float (a CPU scalar, which CUDA's division turns into a
    product with the fp32 reciprocal) moves some of these spans: the
    stamps reach the order the buckets depend on."""
    from easydgl_tpu_torch.data.synthetic import day_boundary_stamps
    from easydgl_tpu_torch.models.tisasrec import (interval_buckets,
                                                   interval_buckets_numpy)
    day = 86400.0
    stamps = torch.as_tensor(day_boundary_stamps(
        np.random.default_rng(0), rows, length, max_days=max_days, day=day))
    want = interval_buckets_numpy(stamps.numpy(), day, timelen)
    got = interval_buckets(stamps.to(cuda_device), day, timelen)
    assert got.is_cuda and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(
        interval_buckets(stamps, day, timelen).numpy(), want)
    ts = stamps.to(cuda_device) / day
    by_reciprocal = (ts[:, 1:, None] - ts[:, None, :-1]).clamp(
        0.0, float(timelen)).to(torch.int32).cpu().numpy()
    assert (by_reciprocal != want).sum() > 0


@pytest.mark.parametrize("name", ["TiSASREC", "TiSASREC-factored"])
def test_tisasrec_on_card_matches_cpu_on_day_boundaries(cuda_device, name):
    """fp32 eval logits (C = 64, L = 10, timelen 12) of a batch of
    whole-day stamps up to 16 days apart, the card against the CPU, to
    1e-4."""
    from easydgl_tpu_torch.data.synthetic import day_boundary_stamps
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    cfg = _small_cfg(name, "float32")
    rng = np.random.default_rng(1)
    stamps = day_boundary_stamps(rng, 4, 11, max_days=16)
    ids = rng.integers(1, 60, (4, 10))
    ids[0, :2] = 0
    params = random_flax_params(cfg, 0)
    logits = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = build_model(cfg, device=dev, params=params)
        with torch.no_grad():
            logits[dev.type] = model({
                "seqs_i": torch.as_tensor(ids, device=dev),
                "seqs_t": torch.as_tensor(stamps, device=dev)})[0].cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------- wide heads
# The flash kernels at head widths the narrow ones do not take
# (``flash_wide.cu``; their dk and dv, like dq, sum by atomics): TGAT's augmented heads (q, k 2,048 wide, v 512 as the
# port passes it, or 2,048) and TGREC's (150, fp32), an odd narrow width
# and the backward at dh = 128. q and k ~ N(0, 0.3^2) at the wide widths,
# so that the logits (sums over 2,048 products) stay of order 1.
WIDE_SHAPES = {
    "tgat_dv512": dict(b=2, h=1, tq=300, tk=300, dh=2048, dv=512,
                       pad=(300, 70), qk_std=0.3),
    "tgat_dv2048": dict(b=2, h=1, tq=130, tk=130, dh=2048, dv=2048,
                        pad=(130, 100), qk_std=0.3),
    "tgrec_150": dict(b=3, h=1, tq=333, tk=333, dh=150, pad=(333, 100, 0),
                      qk_std=0.3),
    "dh24_h2": dict(b=2, h=2, tq=77, tk=77, dh=24),
    "dh128": dict(b=2, h=2, tq=200, tk=200, dh=128, pad=(200, 70),
                  qk_std=0.5),
    "tq100_tk300_dh96": dict(b=2, h=2, tq=100, tk=300, dh=96, dv=40)}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_flash_kernels_match_plain_version(cuda_device, dtype, causal,
                                                shape, rate):
    """The wide kernels forward and backward, each on the plain version's
    inputs, and the chained backward, as ``_check_flash_kernels``; every
    batch row with no visible key exactly 0."""
    _check_flash_kernels(cuda_device, dtype, causal, WIDE_SHAPES[shape],
                         rate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_flash_kernels_draw_one_dropout_mask(cuda_device, dtype):
    """q = 0 and k = v = I at a width the narrow kernels do not take (t =
    256, a power of two, so that out * t is exact): out, dq (dO = 1) and dv
    (dO = I) show the keep factor of every (i, j) as the wide kernels drew
    it; each equals ``dropout_factor``. The
    kept share is 1 - rate within 4 standard deviations and every kept
    entry is scaled by 1 / (1 - rate)."""
    from easydgl_tpu_torch.kernels import flash_attention as fl
    from easydgl_tpu_torch.kernels.mau_attention import dropout_factor
    b, h, t, rate = 2, 2, 256, 0.25
    dev = cuda_device
    eye = torch.eye(t, device=dev).expand(b, h, t, t).to(dtype).contiguous()
    q = torch.zeros(b, h, t, t, device=dev, dtype=dtype)
    ones = torch.ones(b, h, t, t, device=dev, dtype=dtype)
    km = torch.ones(b, t, device=dev)
    kw = dict(causal=False, dropout_rate=rate, scale=1.0,
              seed=torch.tensor(321, device=dev))
    before = fl.flash_attention_fwd.launches
    out, lse = fl.flash_attention_fwd(q, eye, eye, km, **kw)
    assert fl.flash_attention_fwd.launches == before + 1
    delta = fl.flash_delta(ones, out)
    dq = fl.flash_attention_bwd(q, eye, eye, km, ones, lse, delta, **kw)[0]
    dv = fl.flash_attention_bwd(q, eye, eye, km, eye, lse,
                                fl.flash_delta(eye, out), **kw)[2]
    keep = dropout_factor(321, (b, h, t, t), rate, dev)
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(out.float() * t, keep.to(dtype).float(),
                               atol=0, rtol=0)
    torch.testing.assert_close(dv.transpose(-1, -2).float() * t, keep,
                               atol=0, rtol=1e-2 if bf16 else 1e-5)
    torch.testing.assert_close(dq.float() * t + delta[..., None], keep,
                               atol=2e-2 if bf16 else 1e-5, rtol=0)
    kept = keep > 0
    share, n = float(kept.float().mean()), kept.numel()
    assert abs(share - (1 - rate)) <= 4 * (rate * (1 - rate) / n) ** 0.5
    torch.testing.assert_close(keep[kept], torch.full_like(
        keep[kept], 1 / (1 - rate)), atol=0, rtol=0)


def test_flash_context_scale_on_card(cuda_device):
    """``flash_context(scale=s)`` on the card (the wide kernels: q and k 64
    wide, v 16) multiplies q . k by s, not by 1/sqrt(64): against the
    materialised softmax at s, fp32, no dead row."""
    from easydgl_tpu_torch.nn.attention import attention_probs, flash_context
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k = (torch.randn(2, 1, 90, 64, generator=g, device=cuda_device)
            for _ in range(2))
    v = torch.randn(2, 1, 90, 16, generator=g, device=cuda_device)
    km = torch.ones(2, 90, device=cuda_device)
    s = 16 ** -0.5
    got = flash_context(q, k, v, km, causal=True, rate=0.0, generator=None,
                        scale=s)
    want = attention_probs(q, k, key_mask=km, causal=True, scale=s) @ v
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


# TGAT and TGREC: the catalog kernels in every train step (TGREC at its
# preset's C = 50), the flash kernels once a block under "flash".
BOCHNER = {"TGAT": {}, "TGAT-flash": dict(attention_impl="flash"),
           "TGREC": {}, "TGREC-flash": dict(attention_impl="flash")}


def _bochner_cfg(name, compute_dtype):
    from easydgl_tpu_torch.config import preset
    base = name.split("-")[0]
    return preset(base, num_items=60, seqslen=10,
                  num_units=50 if base == "TGREC" else 64,
                  num_heads=1 if base == "TGREC" else 2, num_blocks=2,
                  batch_size=4, compute_dtype=compute_dtype,
                  hidden_dropout_rate=0.0, attention_probs_dropout_rate=0.0,
                  **BOCHNER[name])


@pytest.mark.parametrize("name", list(BOCHNER))
def test_bochner_train_step_launches_rows_3_to_9(cuda_device, name):
    """A train step (C = 64, TGREC's 50) in bf16 and in fp32 launches the
    catalog forward and backward once each and, under "flash", the flash
    forward and backward once a block; its loss and gradients equal those
    of the same model on the card with the written-out plain versions
    (``catalog_nll_written_out``, ``flash_attention_written_out``: g and
    ds rounded to the compute dtype where the kernels round them): loss to
    1e-5 relative, each leaf to 1e-4 (fp32) or 1e-2 (bf16) of its scale, a
    key bias of its key weight's. fp32 eval logits equal the CPU's to
    1e-4."""
    from easydgl_tpu_torch.kernels import flash_attention as fl
    from easydgl_tpu_torch.models.registry import MODELS, build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train import steps
    counters = (catalog_nll_fwd, catalog_nll_bwd) + fl.FLASH_KERNELS
    flash = "flash" in name
    for dtype, tol in (("bfloat16", 1e-2), ("float32", 1e-4)):
        cfg = _bochner_cfg(name, dtype)
        params = random_flax_params(cfg, 0)
        model = build_model(cfg, device=cuda_device, params=params)
        f, lab = _small_batch(cfg, True)
        feats = steps.to_device(f, cuda_device)
        labels = torch.as_tensor(lab, device=cuda_device)
        for fn in counters:
            fn.launches = 0
        loss, grads = steps.loss_and_grads(model, feats, labels)
        nb = cfg.num_blocks if flash else 0
        assert [fn.launches for fn in counters] == [1, 1, nb, nb]
        module, attr, _ = MODELS[cfg.model].long_context_engine
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(steps, "catalog_nll", catalog_nll_written_out)
            mp.setattr(module, attr, fl.flash_attention_written_out)
            loss_p, grads_p = steps.loss_and_grads(model, feats, labels)
        assert [fn.launches for fn in counters] == [1, 1, nb, nb]
        assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
        for n, want in grads_p.items():
            ref = grads_p[n[:-4] + "weight"] if n.endswith("attn.k.bias") \
                else want
            err = float((grads[n] - want).abs().max())
            assert err <= tol * float(ref.abs().max()), (
                dtype, n, err, float(ref.abs().max()))
        state, loss1 = steps.build_train_step(model)(
            steps.init_state(model), f, lab, torch.Generator(device="cuda"))
        assert [fn.launches for fn in counters] == [2, 2, 2 * nb, 2 * nb]
        assert np.isfinite(float(loss1)) and state.step == 1
        if dtype == "float32":
            ef = _small_batch(cfg, False)[0]
            logits = {}
            for dev in (cuda_device, torch.device("cpu")):
                m = build_model(cfg, device=dev, params=params)
                with torch.no_grad():
                    logits[dev.type] = m(steps.to_device(ef, dev))[0].cpu()
            torch.testing.assert_close(logits["cuda"], logits["cpu"],
                                       atol=1e-4, rtol=1e-4)


# GREC and TimelyREC (both user-tower forms): the catalog kernels in every
# train step (GREC's at its untied head of num_items + 2 rows), the flash
# kernels once a step under TimelyREC's "flash" (one attention layer).
ZOO_TAIL = {"GREC": {}, "TimelyREC": {},
            "TimelyREC-flash": dict(attention_impl="flash")}


def _tail_cfg(name, compute_dtype, **kw):
    from easydgl_tpu_torch.config import preset
    return preset(name.split("-")[0], num_items=60, seqslen=10,
                  num_units=64, num_heads=2, batch_size=4, dilations=(1, 2),
                  compute_dtype=compute_dtype, hidden_dropout_rate=0.0,
                  attention_probs_dropout_rate=0.0,
                  **dict(ZOO_TAIL[name], **kw))


def _tail_batch(cfg, train):
    """A batch of the model's protocol, datetime fields included."""
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import synthetic_split
    from easydgl_tpu_torch.models.registry import model_class
    ds = synthetic_split(num_rows=4, num_items=60, seqslen=10, seed=2,
                         with_datetime=True)
    f, lab, _ = next(BatchLoader(ds, data_mode=model_class(cfg).data_mode,
                                 batch_size=4, masklen=cfg.masklen,
                                 is_training=train).epoch(0))
    return f, lab


def _grads_card_and_cpu(cfg, f, lab, dev):
    """(loss, gradients) of one batch on the card and on the CPU."""
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train import steps
    params = random_flax_params(cfg, 0)
    out = {}
    for d in (dev, torch.device("cpu")):
        model = build_model(cfg, device=d, params=params)
        loss, grads = steps.loss_and_grads(model, steps.to_device(f, d),
                                           torch.as_tensor(lab, device=d))
        out[d.type] = (float(loss), {k: g.cpu() for k, g in grads.items()})
    return out["cuda"], out["cpu"]


@pytest.mark.parametrize("name", list(ZOO_TAIL))
def test_grec_and_timelyrec_on_card_match_cpu(cuda_device, name):
    """fp32 (C = 64, L = 10): eval logits, the card against the CPU, to
    1e-4; one train step's loss to 1e-5 relative and each gradient leaf to
    1e-4 of its scale (a key bias of its key weight's), the card's
    catalog (and flash) kernels against the CPU's plain versions."""
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train.steps import to_device
    cfg = _tail_cfg(name, "float32")
    params = random_flax_params(cfg, 0)
    feats = _tail_batch(cfg, False)[0]
    logits = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = build_model(cfg, device=dev, params=params)
        with torch.no_grad():
            logits[dev.type] = model(to_device(feats, dev))[0].cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)
    (loss, grads), (loss_p, grads_p) = _grads_card_and_cpu(
        cfg, *_tail_batch(cfg, True), cuda_device)
    assert abs(loss - loss_p) <= 1e-5 * abs(loss_p)
    for n, want in grads_p.items():
        ref = grads_p[n[:-4] + "weight"] if n.endswith("attn.k.bias") \
            else want
        err = float((grads[n] - want).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (n, err)


@pytest.mark.parametrize("name", list(ZOO_TAIL))
def test_grec_and_timelyrec_train_step_launches_rows_3_to_9(cuda_device,
                                                            name):
    """A train step in bf16 and in fp32 launches the catalog forward and
    backward once each and, under "flash", the flash forward and backward
    once (TimelyREC's one user-tower attention); its loss and gradients
    equal those of the same model on the card with the written-out plain
    versions (g and ds rounded where the kernels round them): loss to 1e-5
    relative, each leaf to 1e-4 (fp32) or 1e-2 (bf16) of its scale, a key
    bias of its key weight's."""
    from easydgl_tpu_torch.kernels import flash_attention as fl
    from easydgl_tpu_torch.models.registry import MODELS, build_model
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train import steps
    counters = (catalog_nll_fwd, catalog_nll_bwd) + fl.FLASH_KERNELS
    nb = 1 if "flash" in name else 0
    for dtype, tol in (("bfloat16", 1e-2), ("float32", 1e-4)):
        cfg = _tail_cfg(name, dtype)
        model = build_model(cfg, device=cuda_device,
                            params=random_flax_params(cfg, 0))
        f, lab = _tail_batch(cfg, True)
        feats = steps.to_device(f, cuda_device)
        labels = torch.as_tensor(lab, device=cuda_device)
        for fn in counters:
            fn.launches = 0
        loss, grads = steps.loss_and_grads(model, feats, labels)
        assert [fn.launches for fn in counters] == [1, 1, nb, nb]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(steps, "catalog_nll", catalog_nll_written_out)
            if MODELS[cfg.model].long_context_engine is not None:
                module, attr, _ = MODELS[cfg.model].long_context_engine
                mp.setattr(module, attr, fl.flash_attention_written_out)
            loss_p, grads_p = steps.loss_and_grads(model, feats, labels)
        assert [fn.launches for fn in counters] == [1, 1, nb, nb]
        assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
        for n, want in grads_p.items():
            ref = grads_p[n[:-4] + "weight"] if n.endswith("attn.k.bias") \
                else want
            err = float((grads[n] - want).abs().max())
            assert err <= tol * float(ref.abs().max()), (
                dtype, n, err, float(ref.abs().max()))
        state, loss1 = steps.build_train_step(model)(
            steps.init_state(model), f, lab, torch.Generator(device="cuda"))
        assert [fn.launches for fn in counters] == [2, 2, 2 * nb, 2 * nb]
        assert np.isfinite(float(loss1)) and state.step == 1


@pytest.mark.parametrize("shape", ["grec", "timelyrec"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_catalog_kernels_at_grec_and_timelyrec_shapes(cuda_device, dtype,
                                                      shape):
    """The catalog forward and backward against their plain versions at
    GREC's training shape (N = 3,072 masked rows, its untied head: V =
    17,773, a learned bias on every id, the table the transposed view of
    the (C, V) kernel, cast as the train step casts it) and TimelyREC's
    (N = 15,360, V = 17,771, the tied table, -1000 on id 0): lse and ll to
    1e-4 of their scale in both dtypes; d_hidden, d_table and d_bias to
    1e-4 (fp32) or 1e-2 (bf16) of theirs."""
    n, v = (3072, 17773) if shape == "grec" else (15360, 17771)
    g = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn(n, 512, generator=g, device="cuda").to(dtype)
    lim = (6.0 / (v + 512)) ** 0.5
    kernel = (torch.rand(512, v, generator=g, device="cuda") * 2 - 1) * lim
    table = kernel.t() if shape == "grec" else kernel.t().contiguous()
    table = table.to(dtype)
    assert table.is_contiguous() == (shape != "grec")
    bias = torch.randn(v, generator=g, device="cuda") * 0.1
    if shape != "grec":
        bias[0] = -1000.0
    lab = torch.randint(0, v, (n,), generator=g, device="cuda")
    dlse = torch.randn(n, generator=g, device="cuda") / n
    dll = torch.randn(n, generator=g, device="cuda") / n
    got = catalog_nll_fwd(h, table, bias, lab)
    want = catalog_nll_reference(h, table, bias, lab)
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
    got = catalog_nll_bwd(h, table, bias, lab, want[0], dlse, dll)
    ref = catalog_nll_bwd_reference(h, table, bias, lab, want[0], dlse, dll)
    tol = TOL[dtype] if dtype == torch.float32 else 1e-2
    for a, w in zip(got, ref):
        err = float((a.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err


def test_grec_conv_fp32_on_card_matches_cpu(cuda_device):
    """GREC's dilated convolution at its preset's width (C = 512, W = 3,
    dilation 4 and 8, both padding forms) in fp32 on the card within 1e-5
    of its largest entry of the CPU's: a TF32 product (cuDNN's default
    for convolutions) misses by ~1e-3."""
    from easydgl_tpu_torch.nn.cnn import DilatedConv1D
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 31, 512, generator=g)
    for dilation in (4, 8):
        for causal in (True, False):
            conv = DilatedConv1D(3, 512, 512, dilation, causal)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(3, 512, 512, generator=g)
                                  * 0.02)
                conv.bias.copy_(torch.randn(512, generator=g) * 0.1)
                want = conv(x)
                got = conv.to(cuda_device)(x.to(cuda_device)).cpu()
            assert got.dtype == torch.float32
            err = float((got - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (dilation, causal,
                                                            err)


def test_easydgl_lc_gathered_queries_on_card(cuda_device):
    """EasyDGL-LC with ``gather_queries=True`` at L+1 = 160 (more keys than
    the fused kernels take; C = 64, H = 2, E = 4, fp32), with the fused
    entry point made to raise: eval logits on the card equal the CPU's to
    1e-4, and a train step's loss (1e-5 relative) and gradients (1e-4 of
    each leaf's scale), the catalog kernels launched once each, no MAU
    kernel."""
    from easydgl_tpu_torch.config import preset
    from easydgl_tpu_torch.data.loader import BatchLoader
    from easydgl_tpu_torch.data.synthetic import (synthetic_mark_table,
                                                  synthetic_split)
    from easydgl_tpu_torch.models.registry import build_model
    from easydgl_tpu_torch.nn import temporal
    from easydgl_tpu_torch.parity import random_flax_params
    from easydgl_tpu_torch.train import steps

    def refuse(*args, **kw):
        raise AssertionError("the fused MAU kernel was called")

    cfg = preset("EasyDGL-LC", num_items=60, seqslen=159, masklen=16,
                 num_units=64, num_heads=2, num_events=4, batch_size=2,
                 compute_dtype="float32", hidden_dropout_rate=0.0,
                 attention_probs_dropout_rate=0.0, gather_queries=True)
    table = synthetic_mark_table(60, 4, seed=2)
    ds = synthetic_split(num_rows=2, num_items=60, seqslen=159, seed=3)
    params = random_flax_params(cfg, 1)
    counters = (catalog_nll_fwd, catalog_nll_bwd) + STREAMED_KERNELS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(temporal, "mau_attention", refuse)
        for train in (False, True):
            f, lab, _ = next(BatchLoader(
                ds, data_mode="mau", batch_size=2, masklen=16,
                is_training=train, mark_table=table,
                needs_marks=True).epoch(0))
            out = {}
            for fn in counters:
                fn.launches = 0
            for dev in (cuda_device, torch.device("cpu")):
                model = build_model(cfg, device=dev, params=params)
                feats = steps.to_device(f, dev)
                labels = torch.as_tensor(lab, device=dev)
                if train:
                    loss, grads = steps.loss_and_grads(model, feats, labels)
                    out[dev.type] = (float(loss), grads)
                else:
                    with torch.no_grad():
                        out[dev.type] = model(feats)[0].cpu()
            assert [fn.launches for fn in counters] == (
                [1, 1] if train else [0, 0]) + [0] * len(STREAMED_KERNELS)
            if not train:
                torch.testing.assert_close(out["cuda"], out["cpu"],
                                           atol=1e-4, rtol=1e-4)
                continue
            (loss, grads), (loss_p, grads_p) = out["cuda"], out["cpu"]
            assert abs(loss - loss_p) <= 1e-5 * abs(loss_p)
            for n, want in grads_p.items():
                err = float((grads[n].cpu() - want).abs().max())
                assert err <= 1e-4 * float(want.abs().max()), (n, err)
