"""Mamba2's prefill glue kernels (``kernels/ssm_glue``: ``ssm_conv_act``
before ``ssd_scan``, ``ssm_gate_norm`` after it) against their plain
versions, ``models.mamba2._conv_act`` and ``_gate_norm``.

On the CPU: the plain versions composed around the scan give
``ssm_block_apply``'s prefill output and caches bit for bit as the block
computed them before the kernels (``_block_as_before``, its ops copied
unchanged); ``ssm_block_apply`` takes the wrappers only at prefill on
plain tensors, keeps the torch ops at decode, at train and on a mesh, and
launches nothing on the CPU; the wrappers' checks raise on a wrong dtype,
shape, stride or alignment; a cost analysis charges each wrapper its
``roofline.work`` formula.

On the card (``gpu`` marker; no JAX in this file): each kernel against its
plain version at mamba2-1.3b's widths (B 8, d_inner 4096, N 128, 64
heads) over S 1, 3, 1024, 1500 and 4096, the whole block's prefill output
and its four cache leaves against the plain path, and the launch count of
a full mamba2-1.3b prefill. Each tolerance is stated where it is used.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssm_glue import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.roofline import work  # noqa: E402
from repro_torch.roofline.op_analysis import analyze  # noqa: E402

ARCH = "mamba2-1.3b"
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CACHES = ("conv_x", "conv_B", "conv_C", "h")
U = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -24}   # unit roundoff


def _block_params(cfg, dtype, device, seed=0):
    """One SSM block's parameters at Mamba2's initial scales: projections
    of std 1/sqrt(fan in) (dt's a tenth of it), A in [1, 16] and dt in
    [0.001, 0.1] log-uniform, norm weights and D 1 + 0.1 N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    p = {}
    for name, d in mamba2.ssm_block_defs(cfg).items():
        t = torch.randn(d.shape, generator=g)
        if name in ("in_x", "in_z", "in_B", "in_C", "in_dt", "out"):
            t = t / d.shape[0] ** 0.5 * (0.1 if name == "in_dt" else 1.0)
        elif name.startswith("conv_"):
            t = 0.5 * t
        elif name in ("ln", "gn", "D_skip"):
            t = 1.0 + 0.1 * t
        elif name == "dt_bias":
            u = torch.rand(d.shape, generator=g)
            dt0 = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
            t = dt0 + torch.log(-torch.expm1(-dt0))     # softplus^-1(dt0)
        elif name == "A_log":
            t = torch.log(1.0 + 15.0 * torch.rand(d.shape, generator=g))
        p[name] = t.to(dtype).to(device)
    return p


def _x(B, S, D, dtype, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, S, D), generator=g).to(dtype).to(device)


def _block_as_before(ctx, p, x):
    """``ssm_block_apply``'s prefill as it was before the glue kernels, its
    ops copied unchanged (the scan through ``ssd_scan``'s wrapper)."""
    cfg = ctx.cfg
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H, P = s.n_heads(cfg.d_model), s.head_dim
    Bsz, S, _ = x.shape
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z = L.dense(h, p["in_z"])
    xin = L.dense(h, p["in_x"])
    Bm = L.dense(h, p["in_B"])
    Cm = L.dense(h, p["in_C"])
    dt = L.dense(h, p["in_dt"])
    xin, cx = mamba2._causal_conv(xin, p["conv_x"], None)
    Bm, cB = mamba2._causal_conv(Bm, p["conv_B"], None)
    Cm, cC = mamba2._causal_conv(Cm, p["conv_C"], None)
    xin = F.silu(xin.float()).to(xin.dtype)
    Bm = F.silu(Bm.float()).to(Bm.dtype)
    Cm = F.silu(Cm.float()).to(Cm.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(Bsz, S, H, P)
    y, h_fin = ssd_ops.ssd_scan(xh.float(), dt, Bm.float(), Cm.float(), A,
                                chunk=min(s.chunk, S))
    cache = {"conv_x": cx, "conv_B": cB, "conv_C": cC, "h": h_fin}
    y = y + p["D_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, di)
    y = y * F.silu(z.float())
    y = L.rms_norm(y.to(x.dtype), p["gn"], cfg.norm_eps)
    return x + L.dense(y, p["out"]), cache


def _block_plain(ctx, p, x):
    """The block's prefill with the glue's plain versions around
    ``ssd_scan``'s wrapper (on the card its kernel): the path the fused
    one is held against."""
    cfg = ctx.cfg
    s = cfg.ssm
    H, P = s.n_heads(cfg.d_model), s.head_dim
    Bsz, S, _ = x.shape
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xin, Bm, Cm, dt = (L.dense(h, p[n]) for n in
                          ("in_z", "in_x", "in_B", "in_C", "in_dt"))
    xin, Bm, Cm, dt, (cx, cB, cC) = mamba2._conv_act(
        xin, Bm, Cm, dt, p["conv_x"], p["conv_B"], p["conv_C"],
        p["dt_bias"])
    xh = xin.reshape(Bsz, S, H, P)
    A = -torch.exp(p["A_log"].float())
    y, h_fin = ssd_ops.ssd_scan(xh.float(), dt, Bm.float(), Cm.float(), A,
                                chunk=min(s.chunk, S))
    y = mamba2._gate_norm(y, xh, z, p["D_skip"], p["gn"], cfg.norm_eps)
    return x + L.dense(y, p["out"]), {"conv_x": cx, "conv_B": cB,
                                      "conv_C": cC, "h": h_fin}


def _reduced_cfg(dtype):
    return reduced(get_config(ARCH), dtype=dtype)


# ---- CPU ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 3, 11, 20])
def test_plain_glue_composes_to_the_block_as_before(dtype, S):
    """On the CPU ``ssm_block_apply``'s prefill (the wrappers' plain
    versions) and the plain functions composed around the scan give the
    output and the four cache leaves of the block as it was, bit for bit:
    S below the conv's 3 state rows, at them, ragged over chunks of 8."""
    cfg = _reduced_cfg(dtype)
    p = _block_params(cfg, DT[dtype], "cpu", seed=S)
    x = _x(2, S, cfg.d_model, DT[dtype], "cpu", seed=S + 1)
    ctx = T.Ctx(cfg=cfg, mode="prefill")
    ops.reset_launches()
    want, wc = _block_as_before(ctx, p, x)
    got, gc = mamba2.ssm_block_apply(ctx, p, x)
    plain, pc = _block_plain(ctx, p, x)
    assert ops.launches == 0
    for out, caches in ((got, gc), (plain, pc)):
        assert out.dtype == DT[dtype] and torch.equal(out, want)
        assert set(caches) == set(CACHES)
        for n in CACHES:
            assert caches[n].dtype == wc[n].dtype
            assert torch.equal(caches[n], wc[n]), n


@pytest.fixture
def glue_calls(monkeypatch):
    """The calls ``ssm_block_apply`` makes of each glue wrapper."""
    calls = []

    def spy(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(mamba2, name, call)
    spy("ssm_conv_act", ops.ssm_conv_act)
    spy("ssm_gate_norm", ops.ssm_gate_norm)
    return calls


@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
def test_dispatch_keeps_the_torch_ops_on_the_cpu(glue_calls, mode):
    """Prefill on plain tensors goes through the wrappers, whose CPU path
    is the plain version (0 launches); decode (S 1 on the conv state) and
    train (autograd through ``_ssd_chunked``) never reach them."""
    cfg = _reduced_cfg("float32")
    p = _block_params(cfg, torch.float32, "cpu", seed=3)
    x = _x(2, 1 if mode == "decode" else 9, cfg.d_model, torch.float32,
           "cpu", seed=4)
    ops.reset_launches()
    if mode == "decode":
        _, pre = mamba2.ssm_block_apply(T.Ctx(cfg=cfg, mode="prefill"), p,
                                        _x(2, 9, cfg.d_model, torch.float32,
                                           "cpu", seed=5))
        glue_calls.clear()
        mamba2.ssm_block_apply(
            T.Ctx(cfg=cfg, mode="decode", positions=torch.tensor([9, 9])),
            p, x, {n: t.clone() for n, t in pre.items()})
    elif mode == "train":
        p = {n: t.requires_grad_() for n, t in p.items()}
        out, _ = mamba2.ssm_block_apply(T.Ctx(cfg=cfg, mode="train"), p, x)
        out.square().sum().backward()
        assert p["conv_x"].grad is not None and p["gn"].grad is not None
    else:
        mamba2.ssm_block_apply(T.Ctx(cfg=cfg, mode="prefill"), p, x)
    assert glue_calls == (["ssm_conv_act", "ssm_gate_norm"]
                          if mode == "prefill" else [])
    assert ops.launches == 0


def test_dispatch_keeps_the_torch_ops_on_a_mesh(glue_calls, tmp_path):
    """On a one-rank DeviceMesh (every tensor a DTensor) the prefill runs
    the plain ops, never the wrappers, and equals the prefill without a
    mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    cfg = _reduced_cfg("float32")
    par = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    plain = build_model(cfg, par, "cpu")
    params = plain.init(seed=2)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(2, 13)))
    want_logits, want = plain.prefill_fn(params, {"tokens": tokens})
    assert glue_calls == ["ssm_conv_act", "ssm_gate_norm"] * cfg.n_layers
    glue_calls.clear()
    ops.reset_launches()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        api = build_model(cfg, par, "cpu", mesh=make_local_mesh(1, 1, "cpu"),
                          sharded=True)
        logits, caches = api.prefill_fn(api.load(params),
                                        {"tokens": tokens})
        assert glue_calls == [] and ops.launches == 0
        np.testing.assert_allclose(logits.full_tensor().numpy(),
                                   want_logits.numpy(), atol=1e-6, rtol=0)
        for n in CACHES:
            np.testing.assert_allclose(caches[n].full_tensor().numpy(),
                                       want[n].numpy(), atol=1e-5, rtol=0)
    finally:
        dist.destroy_process_group()


def _conv_args(B=2, S=5, DI=16, N=8, H=8, W=4, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to(dtype)
    return dict(xin=r(B, S, DI), Bm=r(B, S, N), Cm=r(B, S, N), dt=r(B, S, H),
                conv_x=r(W, DI), conv_B=r(W, N), conv_C=r(W, N),
                dt_bias=r(H))


def _norm_args(B=2, S=5, H=2, P=8, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)

    def r(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(dt)
    return dict(y=r(B, S, H, P, dt=torch.float32),
                xh=r(B, S, H, P, dt=torch.float32), z=r(B, S, H * P),
                D_skip=r(H), gn=r(H * P))


def _strided(t):
    """The same values, not contiguous."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


def _shifted(t):
    """The same values and shape, starting 4 bytes past a 16-byte
    boundary."""
    buf = torch.zeros(t.numel() + 4, dtype=t.dtype)
    out = buf[4 // t.element_size():][:t.numel()].view(t.shape)
    out.copy_(t)
    return out


CONV_BAD = {
    "f16": (TypeError, "float32 or bfloat16",
            lambda a: {k: v.half() for k, v in a.items()}),
    "mixed_dtype": (TypeError, "conv_B must be",
                    lambda a: dict(a, conv_B=a["conv_B"].float())),
    "Cm_shape": (ValueError, "expected", lambda a: dict(a, Cm=a["Cm"][:, 1:])),
    "x_2d": (ValueError, "expected", lambda a: dict(a, xin=a["xin"][0])),
    "DI_not_8": (ValueError, "multiples of 8",
                 lambda a: dict(a, xin=a["xin"][..., :12].contiguous(),
                                conv_x=a["conv_x"][:, :12].contiguous())),
    "width_5": (ValueError, "only 4", lambda a: dict(_conv_args(W=5))),
    "width_3": (ValueError, "only 4", lambda a: dict(_conv_args(W=3))),
    "H_not_8": (ValueError, "multiples of 8",
                lambda a: dict(_conv_args(H=3))),
    "strided": (ValueError, "contiguous",
                lambda a: dict(a, xin=_strided(a["xin"]))),
    "unaligned": (ValueError, "16-byte",
                  lambda a: dict(a, Bm=_shifted(a["Bm"]))),
}


@pytest.mark.parametrize("case", list(CONV_BAD))
def test_conv_act_check_raises(case):
    exc, match, bad = CONV_BAD[case]
    with pytest.raises(exc, match=match):
        ops._check_conv(**bad(_conv_args()))


NORM_BAD = {
    "y_bf16": (TypeError, "y must be",
               lambda a: dict(a, y=a["y"].bfloat16())),
    "gn_f32": (TypeError, "gn must be", lambda a: dict(a, gn=a["gn"].float())),
    "z_shape": (ValueError, "expected", lambda a: dict(a, z=a["z"][:, :, 1:])),
    "y_3d": (ValueError, "expected",
             lambda a: dict(a, y=a["y"].reshape(2, 5, 16))),
    "P_not_8": (ValueError, "multiple of 8",
                lambda a: _norm_args(P=12)),
    "strided": (ValueError, "contiguous",
                lambda a: dict(a, xh=_strided(a["xh"]))),
    "unaligned": (ValueError, "16-byte",
                  lambda a: dict(a, z=_shifted(a["z"]))),
}


@pytest.mark.parametrize("case", list(NORM_BAD))
def test_gate_norm_check_raises(case):
    exc, match, bad = NORM_BAD[case]
    with pytest.raises(exc, match=match):
        ops._check_norm(**bad(_norm_args()))


@pytest.mark.parametrize("which", ["conv", "norm"])
def test_checks_pass_what_the_kernels_take_but_the_cpu(which):
    """Well-formed operands pass every check but the last: they lie on the
    CPU, and the kernels take CUDA tensors only."""
    check, args = ((ops._check_conv, _conv_args()) if which == "conv"
                   else (ops._check_norm, _norm_args()))
    with pytest.raises(ValueError, match="one CUDA device"):
        check(**args)


@pytest.mark.parametrize("which", ["conv", "norm"])
def test_plain_path_is_charged_its_formula(which):
    """Under a cost analysis each wrapper charges its ``roofline.work``
    formula (no operations: the analysis counts none for elementwise
    ops), its plain version's ops counted as the kernel's own."""
    if which == "conv":
        a = _conv_args(B=2, S=7, DI=16, N=8, H=2, W=4, dtype=torch.float32)
        r = analyze(ops.ssm_conv_act, *a.values())
        name, formula = "ssm_conv_act", work.ssm_conv_act_work(
            2, 7, 16, 8, 2, 4, torch.float32)
    else:
        a = _norm_args(B=2, S=7, H=2, P=8, dtype=torch.float32)
        r = analyze(ops.ssm_gate_norm, *a.values(), eps=1e-5)
        name, formula = "ssm_gate_norm", work.ssm_gate_norm_work(
            2, 7, 16, 2, torch.float32)
    assert r["kernels"] == {name: {"calls": 1, "flops": formula[0],
                                   "bytes": formula[1]}}
    assert r["flops"] == 0 and r["bytes"] == formula[1]
    assert r["bytes_inner_loops"] > 0


def test_work_formulas_count_each_byte_once():
    """mamba2-1.3b's widths, bf16: 26.5 KB a token before the scan, 48 KB
    after it (each input read and each output written once)."""
    bf = torch.bfloat16
    _, conv = work.ssm_conv_act_work(1, 1, 4096, 128, 64, 4, bf)
    assert conv == (4096 + 256 + 64) * 6 + 2 * (4 * 4352 + 64 + 3 * 4352)
    _, norm = work.ssm_gate_norm_work(1, 1, 4096, 64, bf)
    assert norm == 4096 * 12 + 2 * (64 + 4096)


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_S = [1, 3, 1024, 1500, 4096]


def _card_conv_args(S, dtype, dev, B=8, DI=4096, N=128, H=64, W=4):
    """Operands at mamba2-1.3b's widths: the in projections of unit scale,
    conv weights of std 0.5, dt of std 0.1 and dt_bias about -4."""
    g = torch.Generator().manual_seed(S)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g) * scale + shift).to(
            dtype).to(dev)
    return dict(xin=r(B, S, DI), Bm=r(B, S, N), Cm=r(B, S, N),
                dt=r(B, S, H, scale=0.1), conv_x=r(W, DI, scale=0.5),
                conv_B=r(W, N, scale=0.5), conv_C=r(W, N, scale=0.5),
                dt_bias=r(H, shift=-4.0))


def _conv64(x, w):
    """The causal conv in float64 from zeros, and the sum of its terms'
    magnitudes, sum_i |x_(s-W+1+i) w_i|."""
    W = w.shape[0]
    xp = torch.cat([torch.zeros_like(x[:, :W - 1]), x], 1).double()
    S = x.shape[1]
    terms = [xp[:, i:i + S] * w[i].double() for i in range(W)]
    return sum(terms), sum(t.abs() for t in terms)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S", CARD_S)
def test_conv_act_matches_plain_on_card(cuda, S, dtype):
    """x, B and C against the plain version and a float64 conv; dt' and
    the conv states against the plain version.

    The plain version rounds each of the conv's W products and W - 1
    partial sums to the dtype (unit roundoff u: 2^-8 in bf16), each by at
    most u times the sum m of the terms' magnitudes, so its conv is off by
    at most 7 u m; SiLU's slope lies in [-0.1, 1.1], and each side then
    rounds once more (u of its value). The kernel sums in f32 and rounds
    once: within u of silu of the exact conv, plus the f32 sum's 4 x 2^-24
    m. dt' is the same f32 ops on both sides (2 f32 ulps allowed for the
    libraries' expf / log1pf); the states are the input rows, exact."""
    dt_ = DT[dtype]
    a = _card_conv_args(S, dt_, cuda)
    before = ops.launches
    xh, Bf, Cf, dtf, state = ops.ssm_conv_act(*a.values())
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    B_, _, DI = a["xin"].shape
    H = a["dt"].shape[2]
    assert xh.shape == (B_, S, H, DI // H) and xh.dtype == torch.float32
    px, pB, pC, pdt, pstate = mamba2._conv_act(*a.values())
    u = U[dt_]
    for got, want, x, w in ((xh.reshape(B_, S, DI), px, a["xin"],
                             a["conv_x"]), (Bf, pB, a["Bm"], a["conv_B"]),
                            (Cf, pC, a["Cm"], a["conv_C"])):
        exact, m = _conv64(x, w)
        oracle = F.silu(exact)
        g, p = got.double(), want.double()
        assert ((g - p).abs() <= u * (8 * m + g.abs() + p.abs())
                + 1e-30).all()
        assert ((g - oracle).abs() <= u * oracle.abs() + 2.0 ** -21 * m
                + 1e-30).all()
    torch.testing.assert_close(dtf, pdt, rtol=2.0 ** -22, atol=0.0)
    for got, want in zip(state, pstate):
        assert got.dtype == dt_ and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S", CARD_S)
def test_gate_norm_matches_plain_on_card(cuda, S, dtype):
    """Against the plain version on the same operands. The gated values
    are the same f32 ops in the same order on both sides, rounded alike,
    but for SiLU's expf, which the two libraries may round an f32 ulp
    apart; the mean square's summation order differs (a few f32 ulps of
    rsqrt's argument). Either can move a value across one rounding to the
    dtype, before or after the normalisation, and the product with gn
    rounds once more: at most four steps of the dtype (2^-5 of the value
    in bf16; 1e-6 in f32). In bf16 such crossings are rare (under 1e-3 of
    the elements); in f32 every value carries the few-ulp difference."""
    dt_ = DT[dtype]
    B_, H, P = 8, 64, 64
    g = torch.Generator().manual_seed(S + 7)

    def r(*shape, d=dt_, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g) * scale + shift).to(d).to(
            cuda)
    y, xh = r(B_, S, H, P, d=torch.float32), r(B_, S, H, P, d=torch.float32)
    z = r(B_, S, H * P)
    D, gn = r(H, scale=0.1, shift=1.0), r(H * P, scale=0.1, shift=1.0)
    before = ops.launches
    out = ops.ssm_gate_norm(y, xh, z, D, gn, 1e-5)
    torch.cuda.synchronize()
    assert ops.launches == before + 1 and out.dtype == dt_
    want = mamba2._gate_norm(y, xh, z, D, gn, 1e-5)
    rtol = 2.0 ** -5 if dt_ == torch.bfloat16 else 1e-6
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=1e-30)
    if dt_ == torch.bfloat16:
        assert float((out != want).float().mean()) < 1e-3


def _rel(a, b, ref):
    return float((a.double() - b.double()).norm() / ref.double().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("S", CARD_S)
def test_block_prefill_matches_plain_on_card(cuda, S):
    """mamba2-1.3b's block (d_model 2048) at B 8 in bf16: the fused
    prefill (2 glue launches, 1 scan) against the plain path (the glue's
    torch ops around the same scan kernel), and both against the same
    block in f32 on the plain path.

    The two bf16 paths differ by where they round: the plain conv rounds
    its products and partial sums to bf16, the kernel does not. So the
    fused path is no farther from the f32 block than the plain one (10%
    allowed for the error's noise), and the two lie within the sum of
    their distances to it: 2.1 x the plain path's own bf16 error, for the
    output's update (output - x) and for the state h. The conv states are
    the projections' rows, the same ops on both paths: exact."""
    cfg = get_config(ARCH)
    p = _block_params(cfg, torch.bfloat16, cuda, seed=S)
    x = _x(8, S, cfg.d_model, torch.bfloat16, cuda, seed=S + 1)
    ctx = T.Ctx(cfg=cfg, mode="prefill")
    glue, scans = ops.launches, ssd_ops.launches
    got, gc = mamba2.ssm_block_apply(ctx, p, x)
    torch.cuda.synchronize()
    assert (ops.launches - glue, ssd_ops.launches - scans) == (2, 1)
    want, wc = _block_plain(ctx, p, x)
    assert ops.launches - glue == 2
    ref, rc = _block_plain(T.Ctx(cfg=cfg, mode="prefill"),
                           {n: t.float() for n, t in p.items()}, x.float())
    upd = [t.float() - x.float() for t in (got, want, ref)]
    err_f, err_p = _rel(upd[0], upd[2], upd[2]), _rel(upd[1], upd[2], upd[2])
    print(f"S={S}: update vs f32 fused {err_f:.3g} plain {err_p:.3g}; "
          f"fused vs plain {_rel(upd[0], upd[1], upd[2]):.3g}")
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert err_f <= 1.1 * err_p
    assert _rel(upd[0], upd[1], upd[2]) <= 2.1 * err_p
    hf, hp = _rel(gc["h"], rc["h"], rc["h"]), _rel(wc["h"], rc["h"], rc["h"])
    print(f"S={S}: h vs f32 fused {hf:.3g} plain {hp:.3g}")
    assert gc["h"].dtype == torch.float32 and hf <= 1.1 * hp
    assert _rel(gc["h"], wc["h"], rc["h"]) <= 2.1 * hp
    for n in ("conv_x", "conv_B", "conv_C"):
        assert gc[n].dtype == torch.bfloat16 and torch.equal(gc[n], wc[n]), n


@pytest.mark.gpu
def test_prefill_launches_each_kernel_once_a_layer_on_card(cuda):
    """A full mamba2-1.3b prefill (48 layers, bf16) launches 2 x 48 glue
    kernels and 48 scans; a decode step after it none of either."""
    cfg = get_config(ARCH)
    api = build_model(cfg, ParallelConfig(param_dtype="bfloat16",
                                          compute_dtype="bfloat16"), cuda)
    params = api.init(seed=0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(2, 300)), device=cuda)
    ops.reset_launches()
    ssd_ops.reset_launches()
    logits, caches = api.prefill_fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert (ops.launches, ssd_ops.launches) == (2 * cfg.n_layers,
                                                cfg.n_layers)
    ops.reset_launches()
    ssd_ops.reset_launches()
    api.decode_fn(params, caches, logits[:, -1].argmax(-1)[:, None],
                  torch.full((2,), 300, device=cuda))
    torch.cuda.synchronize()
    assert (ops.launches, ssd_ops.launches) == (0, 0)


@pytest.mark.gpu
def test_kernels_raise_on_what_they_do_not_take_on_card(cuda):
    a = {k: v.to(cuda) for k, v in _conv_args().items()}
    n = {k: v.to(cuda) for k, v in _norm_args().items()}
    before = ops.launches
    with pytest.raises(TypeError, match="conv_B must be"):
        ops.ssm_conv_act(*dict(a, conv_B=a["conv_B"].float()).values())
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssm_conv_act(*dict(a, xin=_strided(a["xin"])).values())
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.ssm_conv_act(*dict(a, dt_bias=a["dt_bias"].cpu()).values())
    with pytest.raises(TypeError, match="y must be"):
        ops.ssm_gate_norm(*dict(n, y=n["y"].bfloat16()).values(), 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.ssm_gate_norm(*(t.to(cuda) for t in _norm_args(P=12).values()),
                          1e-5)
    with pytest.raises(ValueError, match="at most 8192"):
        ops.ssm_gate_norm(*(t.to(cuda) for t in _norm_args(
            B=1, S=1, H=129, P=64).values()), 1e-5)
    assert ops.launches == before
