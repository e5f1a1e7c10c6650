"""The port's flash attention against the reference kernel.

On the CPU the port's wrapper runs its plain version; it is held against
the reference Pallas kernel in interpret mode and against the reference's
dense ``llama.attention``, at the bounds of ``tests/test_ops.py``: 2e-5 in
f32 (the same algorithm, summed in another order) and 5e-2 in bf16 (the
dense reference rounds its scores and probabilities to bf16, a few ulps at
|o| ~ 1). Inputs are drawn with numpy and handed to both sides.

Tests marked ``cuda`` hold the CUDA kernel against the plain version on the
card and skip without one; run them with
``python -m pytest tests/test_torch_*.py -m cuda``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import llama as ref_llama
from brpc_tpu.ops import flash_attention as ref_flash
from brpc_tpu_torch import optim
from brpc_tpu_torch.models import llama
from brpc_tpu_torch.ops import _build
from brpc_tpu_torch.ops import flash_attention as fa
from brpc_tpu_torch.utils.tree import tree_leaves


def _inputs(seed, b=2, t=128, hq=4, hkv=2, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d))]


def _port(arrays, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return fa.flash_attention(q, k, v, **kw).float().numpy()


def _references(arrays, dtype=jnp.float32, *, causal=True, block_q=32,
                block_k=32):
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    kernel = ref_flash(q, k, v, causal=causal, block_q=block_q,
                       block_k=block_k, interpret=True)
    dense = ref_llama.attention(q, k, v, causal=causal)
    return [np.asarray(x, np.float32) for x in (kernel, dense)]


@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference(causal):
    arrays = _inputs(0)
    got = _port(arrays, causal=causal, block_q=32, block_k=32)
    for want in _references(arrays, causal=causal):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_uneven_blocks():
    arrays = _inputs(1, t=64)
    got = _port(arrays, block_q=16, block_k=64)
    for want in _references(arrays, block_q=16, block_k=64):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16(causal):
    arrays = _inputs(2, t=64)
    got = _port(arrays, torch.bfloat16, causal=causal, block_q=32,
                block_k=32)
    for want in _references(arrays, jnp.bfloat16, causal=causal):
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_gqa_groups(hq, hkv):
    arrays = _inputs(3, t=64, hq=hq, hkv=hkv)
    got = _port(arrays, block_q=32, block_k=32)
    for want in _references(arrays):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cpu_runs_plain_version_without_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, t=64))
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, block_q=32, block_k=32)
    want = fa.flash_attention_reference(q, k, v, block_q=32, block_k=32)
    assert torch.equal(got, want)
    assert got.shape == (2, 64, 4 * 32) and got.dtype == torch.float32
    assert fa.launches == before


def _mla_inputs(seed, b=2, t=64, hq=4, hkv=4, dqk=192, dv=128):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=g)
            for h, d in ((hq, dqk), (hkv, dqk), (hkv, dv))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [None, 0.114721])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_plain_version_at_its_own_v_head_dim_is_dense_attention(
        causal, scale, hq, hkv):
    """At q/k head dim 192 and v head dim 128 (latent attention's), with
    the default or a given scale, the plain version is dense attention
    within the f32 bound (the same function, summed in another order)."""
    q, k, v = _mla_inputs(9, hq=hq, hkv=hkv)
    got = fa.flash_attention(q, k, v, causal=causal, scale=scale,
                             block_q=32, block_k=32)
    want = llama.attention(q, k, v, causal=causal, scale=scale)
    assert got.shape == (2, 64, hq * 128)
    assert (got - want).abs().max() <= 2e-5
    if scale is None:
        assert torch.equal(got, fa.flash_attention(
            q, k, v, causal=causal, scale=192 ** -0.5, block_q=32,
            block_k=32))


def test_plain_backward_at_its_own_v_head_dim_and_scale():
    """The plain backward with v's head dim and a scale of its own against
    autograd through dense attention, on the CPU."""
    q, k, v = (x.requires_grad_(True) for x in _mla_inputs(10, t=32))
    grad = torch.randn((2, 32, 4 * 128),
                       generator=torch.Generator().manual_seed(11))
    got = torch.autograd.grad(fa.flash_attention(q, k, v, scale=0.3,
                                                 block_q=16, block_k=16),
                              (q, k, v), grad)
    want = torch.autograd.grad(llama.attention(q, k, v, scale=0.3),
                               (q, k, v), grad)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4


def test_reference_kernel_cannot_be_differentiated():
    """The reference kernel is forward only: ``jax.grad`` through it fails."""
    q, k, v = (jnp.asarray(a) for a in _inputs(8, t=64))
    with pytest.raises(AssertionError):
        jax.grad(lambda q: ref_flash(q, k, v, block_q=32, block_k=32,
                                     interpret=True).sum())(q)


def _requiring_grad(seed):
    return [torch.from_numpy(a).requires_grad_(True)
            for a in _inputs(seed, t=64)]


# (B, T, Hq, Hkv, D): MHA and GQA at head dims 64 and 128, T 64 to 256.
_GRAD_SHAPES = [(2, 64, 4, 4, 64), (1, 128, 4, 2, 64), (1, 256, 8, 2, 128),
                (2, 128, 4, 1, 128)]


def _grad_inputs(shape, seed):
    b, t, hq, hkv, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d),
                                                    dtype=np.float32))
               for h in (hq, hkv, hkv))
    grad = torch.from_numpy(rng.standard_normal((b, t, hq * d),
                                                dtype=np.float32))
    return q, k, v, grad


@pytest.mark.parametrize("via", ["autograd", "reference"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", _GRAD_SHAPES)
def test_cpu_backward_matches_dense_autograd(shape, causal, via):
    """dq, dk and dv of ``flash_attention``'s CPU backward (``autograd``)
    and of ``flash_attention_backward_reference`` called on the forward's
    output and log-sum-exp (``reference``) against autograd through dense
    ``llama.attention``, all in f32: the same function summed in another
    order, within 2e-5 of the largest gradient element (measured ~1e-6)."""
    q, k, v, grad = _grad_inputs(shape, seed=sum(shape) + causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    dense = llama.attention(*leaves, causal=causal)
    want = torch.autograd.grad(dense, leaves, grad)
    if via == "autograd":
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=causal, block_q=64,
                                 block_k=64)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, grad)
    else:
        out, lse = fa._reference(q, k, v, causal, 64)
        assert lse.shape == (shape[0], shape[2], shape[1])
        got = fa.flash_attention_backward_reference(
            q, k, v, out, lse, grad, causal=causal, block_q=64, block_k=64)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err = (g - w).abs().max().item()
        assert err <= 2e-5 * w.abs().max().item(), (name, err)


def test_cpu_backward_in_bf16_rounds_p_and_ds_once():
    """With bf16 inputs the CPU backward rounds P and dS to bf16 before
    their products, as the kernels do, and sums in f32: within 2**-6 of the
    largest gradient element of dense attention's f32 gradients (the
    inputs themselves are bf16, so both sides see the same values)."""
    q, k, v, grad = (x.bfloat16() for x in _grad_inputs((1, 128, 4, 2, 64),
                                                        seed=3))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, block_q=64,
                                                 block_k=64), leaves, grad)
    f32 = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(llama.attention(*f32), f32, grad.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = (g.float() - w).abs().max().item()
        assert err <= 2.0 ** -6 * w.abs().max().item()


def test_forward_with_grad_inputs_matches_plain_version():
    q, k, v = _requiring_grad(10)
    got = fa.flash_attention(q, k, v, block_q=32, block_k=32)
    with torch.no_grad():
        want = fa.flash_attention_reference(q, k, v, block_q=32, block_k=32)
        assert fa.flash_attention(q, k, v, block_q=32,
                                  block_k=32).grad_fn is None
    assert torch.equal(got.detach(), want)
    with torch.inference_mode():
        assert fa.flash_attention(q, k, v, block_q=32,
                                  block_k=32).grad_fn is None


def test_train_step_with_flash_attention_matches_dense_step():
    """``make_train_step(cfg, opt, attn_fn=flash_attention)`` steps on the
    tiny config (bf16 compute) and matches the dense step: losses within
    2e-3 (7e-4 measured), first gradients within 3 % of each leaf's norm
    (1.2 % measured: both round the probabilities to bf16, dense also its
    scores, at different places), and each leaf's change over three AdamW
    steps within 15 % of the dense change's norm (7 % measured: AdamW's
    first steps divide by |g|, so a weight whose gradient is within
    rounding of zero moves by about lr either way)."""
    cfg = llama.LlamaConfig.tiny()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))

    def fresh():
        return llama.trainable(llama.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu"))

    grads = []
    for attn_fn in (fa.flash_attention, None):
        params = fresh()
        llama.loss_fn(params, tokens, cfg, attn_fn).backward()
        grads.append([p.grad for p in tree_leaves(params)])
    for g, w in zip(*grads):
        assert (g - w).norm() <= 0.03 * w.norm()
    runs = []
    for attn_fn in (fa.flash_attention, None):
        params = fresh()
        step = llama.make_train_step(cfg, optim.adamw(params, 1e-3),
                                     attn_fn=attn_fn)
        losses = [step(params, tokens).item() for _ in range(3)]
        runs.append((losses, [p.detach() for p in tree_leaves(params)]))
    (flash_losses, flash_params), (dense_losses, dense_params) = runs
    assert flash_losses[-1] < flash_losses[0]
    assert np.allclose(flash_losses, dense_losses, rtol=0, atol=2e-3)
    for p, w, start in zip(flash_params, dense_params,
                           tree_leaves(fresh())):
        assert p.grad is None
        assert (p - w).norm() <= 0.15 * (w - start.detach()).norm()


class _Seen:
    """What ``fa.trains`` reads of a tensor, for devices this host lacks."""

    def __init__(self, device, dtype, shape):
        self.device, self.dtype, self.shape = torch.device(device), dtype, shape

    def dim(self):
        return len(self.shape)


_ROUTES = [
    ("cpu bf16", _Seen("cpu", torch.bfloat16, (2, 2048, 32, 128)), False),
    ("cuda f32", _Seen("cuda", torch.float32, (2, 2048, 32, 128)), False),
    ("cuda f16", _Seen("cuda", torch.float16, (2, 2048, 32, 128)), False),
    ("cuda bf16 head dim 32", _Seen("cuda", torch.bfloat16, (2, 128, 4, 32)),
     False),
    ("cuda bf16 T 200", _Seen("cuda", torch.bfloat16, (1, 200, 4, 128)),
     False),
    ("cuda bf16 three dims", _Seen("cuda", torch.bfloat16, (2048, 32, 128)),
     False),
    ("cuda bf16 the train cell", _Seen("cuda", torch.bfloat16,
                                       (2, 2048, 32, 128)), True),
    ("cuda bf16 D 64 T 96", _Seen("cuda", torch.bfloat16, (2, 96, 8, 64)),
     True),
]


@pytest.mark.parametrize("case,q,k1", _ROUTES)
def test_train_attention_routes_by_what_it_observes(monkeypatch, case, q,
                                                    k1):
    """The train step's rule: K1 (``flash_attention``) for a CUDA bf16 q at
    a head dim and T the kernels take, dense ``attention`` otherwise."""
    assert fa.trains(q) is k1
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **kw: "k1")
    monkeypatch.setattr(llama, "attention", lambda *a, **kw: "dense")
    assert llama.train_attention(q, q, q) == ("k1" if k1 else "dense")


def test_train_attention_on_the_cpu_is_dense_attention():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(12, t=64))
    for causal in (True, False):
        assert torch.equal(llama.train_attention(q, k, v, causal=causal),
                           llama.attention(q, k, v, causal=causal))


def _bad(change):
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, t=64))
    return change(q, k, v)


_REJECTED = [
    ("t not divisible", lambda q, k, v: (q[:, :48].contiguous(),
                                         k[:, :48].contiguous(),
                                         v[:, :48].contiguous()), ValueError),
    ("float16", lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),
    ("mixed dtypes", lambda q, k, v: (q, k.bfloat16(), v), TypeError),
    ("not contiguous", lambda q, k, v: (q.transpose(2, 3).contiguous()
                                        .transpose(2, 3), k, v), ValueError),
    ("hq not a multiple of hkv", lambda q, k, v: (q[:, :, :3].contiguous(),
                                                  k, v), ValueError),
    ("head dim 16", lambda q, k, v: (q[..., :16].contiguous(),
                                     k[..., :16].contiguous(),
                                     v[..., :16].contiguous()), ValueError),
    ("seq mismatch", lambda q, k, v: (q, k[:, :32].contiguous(),
                                      v[:, :32].contiguous()), ValueError),
    ("three dims", lambda q, k, v: (q[0], k[0], v[0]), ValueError),
    ("v head dim of its own at 32", lambda q, k, v: (
        q, k, v[..., :16].contiguous()), ValueError),
    ("k and v heads differ", lambda q, k, v: (q, k, v[:, :, :1].contiguous()),
     ValueError),
]
# Pairs of (q/k, v) head dims the kernels do not take.
_REJECTED_PAIRS = [(192, 64), (128, 64), (192, 192), (96, 128)]


@pytest.mark.parametrize("dqk,dv", _REJECTED_PAIRS)
def test_rejects_head_dim_pairs_the_kernels_do_not_take(dqk, dv):
    q, k, v = _mla_inputs(12, t=32, dqk=dqk, dv=dv)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)


@pytest.mark.parametrize("case,args,exc", _REJECTED)
def test_rejects(case, args, exc):
    q, k, v = _bad(args)
    with pytest.raises(exc):
        fa.flash_attention(q, k, v, block_q=32, block_k=32)


def test_other_devices_are_refused():
    q, k, v = (torch.from_numpy(a).to("meta") for a in _inputs(7, t=64))
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention(q, k, v, block_q=32, block_k=32)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.sources() == ["device_programs", "embedding_rows",
                                "flash_attention"]
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build()
    # the library name is keyed by the source's content and the flags
    assert _build.library_path("flash_attention").name.startswith(
        "libflash_attention-")


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (csrc / "kern.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    assert _build.sources() == ["kern"]
    first = _build.library_path("kern")
    assert first == _build.library_path("kern")
    (csrc / "common.cuh").write_text("// v2\n")
    second = _build.library_path("kern")
    assert second != first
    (csrc / "kern.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.library_path("kern") not in (first, second)


def _kernel_arithmetic(q, k, v, *, causal, split_p=True, block_k=64):
    """The bf16 kernel's arithmetic in plain PyTorch: bf16 q·k products
    summed in f32 and scaled only after the product, masked scores -1e30,
    an online softmax in powers of two over K tiles of ``block_k`` (running
    max m of the unscaled scores, p = 2**(s·c - m·c) with c =
    D**-0.5·log2(e)), and P fed to the P·V product as bf16: split into
    p_hi = bf16(p) and p_lo = bf16(p - p_hi), or rounded once."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    scale_log2 = d ** -0.5 * 1.4426950408889634
    qf = q.float().view(b, t, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    rows = torch.arange(t)[:, None]
    m = torch.full((b, hkv, hq // hkv, t, 1), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, t, block_k):
        x = qf @ kf[..., k0:k0 + block_k, :].transpose(-1, -2)
        cols = torch.arange(k0, min(k0 + block_k, t))[None, :]
        if causal:
            x = torch.where(cols <= rows, x, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * scale_log2)
        p = torch.exp2(x * scale_log2 - m_new * scale_log2)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vf[..., k0:k0 + block_k, :]
        if split_p:
            pv = pv + (p - p_hi).bfloat16().float() @ vf[..., k0:k0 + block_k, :]
        acc = acc * alpha + pv
        m = m_new
    out = (acc / l.clamp_min(1e-20)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq * d)


def _of_bf16_step(got, want):
    """Worst element's |got - want| over one bf16 step of the plain value,
    2**-7 * max(|want|, 2**-4): the bound chip_smoke.py and the card test
    hold the kernel to."""
    err = (got.float() - want.float()).abs()
    return (err / (2.0 ** -7 * want.float().abs().clamp_min(2.0 ** -4))).max()


@pytest.mark.parametrize("causal", [True, False])
def test_split_probabilities_meet_the_kernel_bound(causal):
    """At Llama-3-8B heads, P split in two bf16 halves keeps the kernel's
    arithmetic within one bf16 step of the plain version per element; P
    rounded once to bf16 does not, which is why the kernel splits it."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, h, 128),
                                                    dtype=np.float32))
               .bfloat16() for h in (32, 8, 8))
    want = fa.flash_attention_reference(q, k, v, causal=causal)
    split = _kernel_arithmetic(q, k, v, causal=causal)
    assert split.dtype == torch.bfloat16 and split.shape == want.shape
    assert _of_bf16_step(split, want) <= 1.0
    once = _kernel_arithmetic(q, k, v, causal=causal, split_p=False)
    assert _of_bf16_step(once, want) > 1.0


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest, ties
    away from zero, 10 mantissa bits (13 low bits of the f32 cleared), on
    the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, split):
    """a @ b on the tensor cores: each operand split into hi = tf32(x) and
    lo = tf32(x - hi) and the product taken as lo·hi + hi·lo + hi·hi in
    f32, or each operand rounded to TF32 once."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if not split:
        return a_hi @ b_hi
    return _tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi) + a_hi @ b_hi


def _f32_kernel_arithmetic(q, k, v, *, causal, split=True, block_k=64):
    """The f32 kernel's arithmetic in plain PyTorch: q scaled by D**-0.5 in
    f32, S = Q K^T and O += P V as TF32 products (``_tf32_product``),
    masked scores -1e30, an online softmax over K tiles of ``block_k`` with
    p = 2**(s·log2(e) - m·log2(e)), and acc / max(l, 1e-20)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    log2e = 1.4426950408889634
    qf = (q * d ** -0.5).view(b, t, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    kf = k.permute(0, 2, 1, 3).unsqueeze(2)
    vf = v.permute(0, 2, 1, 3).unsqueeze(2)
    rows = torch.arange(t)[:, None]
    m = torch.full((b, hkv, hq // hkv, t, 1), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, t, block_k):
        kt = kf[..., k0:k0 + block_k, :].transpose(-1, -2)
        s = _tf32_product(qf, kt, split)
        if causal:
            cols = torch.arange(k0, min(k0 + block_k, t))[None, :]
            s = torch.where(cols <= rows, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.exp2(s * log2e - m_new * log2e)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_product(p, vf[..., k0:k0 + block_k, :],
                                          split)
        m = m_new
    out = acc / l.clamp_min(1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq * d)


def test_tf32_rounding_is_cvt_rna():
    """Nearest with ties away from zero, at 10 mantissa bits, signs alike."""
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 3 * 2 ** -11, one + 2 ** -12,
                      one + 2 ** -11 + 2 ** -20, -(one + 2 ** -11), 0.0,
                      -0.0], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, one + 2 ** -9, one,
                         one + 2 ** -10, -(one + 2 ** -10), 0.0, -0.0],
                        dtype=torch.float32)
    got = _tf32(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("causal", [True, False])
def test_split_tf32_products_meet_the_f32_bound(causal):
    """At Llama-3-8B's head dim and the serving length (two query heads on
    one kv head), the f32 kernel's split-TF32 arithmetic stays within the
    f32 gate, 2e-5 of the plain version per element; one TF32 product of
    each operand misses it, which is why the kernel splits them."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2048, h, 128),
                                                    dtype=np.float32))
               for h in (2, 1, 1))
    want = fa.flash_attention_reference(q, k, v, causal=causal)
    split = _f32_kernel_arithmetic(q, k, v, causal=causal)
    assert split.shape == want.shape
    assert (split - want).abs().max() <= 2e-5
    once = _f32_kernel_arithmetic(q, k, v, causal=causal, split=False)
    assert (once - want).abs().max() > 2e-5


def test_value_error_contract_matches_reference():
    arrays = _inputs(6, t=48)
    with pytest.raises(ValueError):
        _port(arrays, block_q=32, block_k=32)
    with pytest.raises(ValueError):
        _references(arrays)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


# (B, T, Hq, Hkv, D): the tiny config's heads, Llama-3-8B's, a T that is not
# a multiple of the kernels' 64-row tiles, a T < 64 that is not a multiple
# of 16, a T that is a multiple of 128 but not of 256, group 4 at D=64, a
# ragged T at D=32 (neither a multiple of 8 nor of the 64-row tiles), and
# Hq = Hkv at D=64 over several 128-row query tiles.
_CARD_SHAPES = [(2, 128, 4, 2, 32), (1, 2048, 32, 8, 128),
                (4, 512, 32, 8, 128), (2, 96, 8, 8, 64), (2, 40, 4, 1, 128),
                (1, 384, 32, 8, 128), (3, 640, 8, 2, 64), (3, 77, 4, 2, 32),
                (2, 512, 8, 8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype, causal):
    """Kernel and plain version both compute in f32 and differ only in the
    order of their sums (~1e-6): 2e-5 in f32. In bf16 both round the same
    f32 value, so each element may differ by one bf16 step of the plain
    value, 2**-7 * |want|, with |want| floored at 2**-4."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    b, t, hq, hkv, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=cuda_device)
               .to(dtype) for h in (hq, hkv, hkv))
    kernel = fa._KERNELS[dtype]
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == {**before, kernel: before[kernel] + 1}
    want = fa.flash_attention_reference(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, t, hq * d)
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        bound = 2.0 ** -7 * want.float().abs().clamp_min(2.0 ** -4)
    else:
        bound = torch.full_like(err, 2e-5)
    worst = (err / bound).max().item()
    assert worst <= 1.0, (f"max |err| {err.max().item()}, worst element at "
                          f"{worst} of its bound")


# (B, T, Hq, Hkv): DeepSeek-V2-Lite's heads at 2k and at the cell's 16k,
# GQA over several query tiles, and a ragged T under 128.
_CARD_MLA_SHAPES = [(1, 2048, 16, 16), (1, 16384, 16, 16), (2, 640, 16, 4),
                    (1, 77, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _CARD_MLA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_latent_attention_head_dims_match_plain_on_card(cuda_device, shape,
                                                        causal):
    """bf16 at q/k head dim 192 and v head dim 128, scaled by V2-Lite's
    0.114721: one launch, each element within one bf16 step of the plain
    value (as at the other head dims)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    b, t, hq, hkv = shape
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=cuda_device)
               .bfloat16() for h, d in ((hq, 192), (hkv, 192), (hkv, 128)))
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, causal=causal, scale=0.114721)
    torch.cuda.synchronize()
    assert fa.launches == {**before, "bf16": before["bf16"] + 1}
    want = fa.flash_attention_reference(q, k, v, causal=causal,
                                        scale=0.114721)
    assert got.shape == (b, t, hq * 128)
    err = (got.float() - want.float()).abs()
    bound = 2.0 ** -7 * want.float().abs().clamp_min(2.0 ** -4)
    assert (err / bound).max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [None, 0.1])
@pytest.mark.parametrize("shape", [s for s in _CARD_SHAPES
                                   if s[4] in fa.BACKWARD_HEAD_DIMS])
def test_serving_and_training_forwards_scale_alike_on_card(cuda_device, shape,
                                                          scale):
    """The serving entry and the entry that also writes the log-sum-exp
    are handed one scale (``softmax_scale``: D**-0.5 by default) and give
    the same bits at it, at the default and at another; the log-sum-exp is
    the plain version's at that scale within 1e-5."""
    b, t, hq, hkv, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(14)
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=cuda_device)
               .bfloat16() for h in (hq, hkv, hkv))
    serve = fa._launch(q, k, v, True, scale=scale)
    train, lse = fa._launch(q, k, v, True, keep_lse=True, scale=scale)
    assert torch.equal(serve, train)
    _, want = fa._reference(q, k, v, True, min(128, t), scale)
    assert (lse[..., :t] - want).abs().max() <= 1e-5


@pytest.mark.cuda
def test_f32_and_training_refuse_latent_attention_on_card(cuda_device):
    q, k, v = (torch.randn((1, 128, 4, d), device=cuda_device)
               for d in (192, 192, 128))
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention(q, k, v)
    q, k, v = (x.bfloat16().requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(q, k, v, scale=0.1)
    assert not fa.trains(q)
    with pytest.raises(RuntimeError, match="no .* backward"):
        out.float().sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 32)])
def test_kernel_is_forward_only_on_card(cuda_device, dtype, d):
    """Where the kernels have no backward (f32, or bf16 at head dim 32),
    inputs that require grad still launch the forward once and give the
    same output, and the backward raises."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn((1, 256, h, d), generator=g, device=cuda_device)
               .to(dtype).requires_grad_(True) for h in (32, 8, 8))
    kernel = fa._KERNELS[dtype]
    before = dict(fa.launches)
    out = fa.flash_attention(q, k, v)
    assert fa.launches == {**before, kernel: before[kernel] + 1}
    assert out.grad_fn is not None and not fa.trains(q)
    with torch.no_grad():
        want = fa.flash_attention(q, k, v)
    assert torch.equal(out.detach(), want)
    with pytest.raises(RuntimeError, match="no .* backward"):
        out.float().sum().backward()
    assert q.grad is None


def _card_grad_inputs(device, shape, seed):
    b, t, hq, hkv, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=device)
               .bfloat16().requires_grad_(True) for h in (hq, hkv, hkv))
    grad = torch.randn((b, t, hq * d), generator=g, device=device).bfloat16()
    return q, k, v, grad


# The train cell's attention (MHA) and a GQA shape.
_CARD_GRAD_SHAPES = [(2, 2048, 32, 32, 128), (1, 1024, 32, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", _CARD_GRAD_SHAPES)
def test_backward_kernels_match_plain_on_card(cuda_device, shape, causal):
    """dq, dk and dv of the backward kernels against
    ``flash_attention_backward_reference`` on the same output and
    log-sum-exp, both in bf16 on the card: within 1e-2 of the largest
    element of each and 2e-3 in norm (3.3e-3 and 2.4e-4 measured). Both
    round P and dS to bf16 for the products, but P comes from the kernel's
    exp2 and the plain version's exp, which differ by ulps and so flip a
    bf16 rounding now and then (each 2**-9 of its term), and the flips add
    up over T x Hq/Hkv terms."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    q, k, v, grad = _card_grad_inputs(cuda_device, shape, seed=9)
    before = dict(fa.launches)
    out = fa.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), grad)
    torch.cuda.synchronize()
    assert fa.launches == {**before, "bf16": before["bf16"] + 1,
                           "bf16_backward": before["bf16_backward"] + 1}
    _, lse = fa._launch(q.detach(), k.detach(), v.detach(), causal,
                        keep_lse=True)
    want = fa.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), out.detach(), lse, grad,
        causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        g, w = g.float(), w.float()
        assert (g - w).abs().max() <= 1e-2 * w.abs().max(), name
        assert (g - w).norm() <= 2e-3 * w.norm(), name


@pytest.mark.cuda
def test_backward_is_deterministic_on_card(cuda_device):
    """Two backwards of one step give the same bits: dK and dV of a KV
    head are summed over its query heads in one block's registers, dQ in
    another kernel, with no atomics."""
    q, k, v, grad = _card_grad_inputs(cuda_device, (2, 2048, 32, 8, 128),
                                      seed=10)
    runs = [torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v),
                                grad) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _CARD_GRAD_SHAPES)
def test_serving_forward_is_the_training_forward_on_card(cuda_device, shape):
    """The serving forward (no grad, ``brt_flash_attention_bf16``) and the
    training forward that also writes the log-sum-exp give the same bits,
    and the log-sum-exp is the plain version's within 1e-5 (f32 sums in
    another order)."""
    q, k, v, _ = _card_grad_inputs(cuda_device, shape, seed=11)
    before = dict(fa.launches)
    train = fa.flash_attention(q, k, v)
    with torch.no_grad():
        serve = fa.flash_attention(q, k, v)
    with torch.inference_mode():
        inference = fa.flash_attention(q, k, v)
    assert torch.equal(train.detach(), serve)
    assert torch.equal(serve, inference)
    assert fa.launches == {**before, "bf16": before["bf16"] + 3}
    _, lse = fa._launch(q.detach(), k.detach(), v.detach(), True,
                        keep_lse=True)
    _, want = fa._reference(q.detach(), k.detach(), v.detach(), True, 128)
    assert (lse[..., :shape[1]] - want).abs().max() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case,args,exc", _REJECTED)
def test_f32_kernel_launches_once_and_refuses_on_card(cuda_device, case,
                                                      args, exc):
    """On the card an f32 call launches the f32 kernel once and nothing
    else; what ``test_rejects`` refuses on the CPU is refused on the card
    before any launch."""
    q, k, v = (t.to(cuda_device) for t in _bad(lambda q, k, v: (q, k, v)))
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, block_q=32, block_k=32)
    torch.cuda.synchronize()
    assert fa.launches == {**before, "f32": before["f32"] + 1}
    want = fa.flash_attention_reference(q, k, v, block_q=32, block_k=32)
    assert (got - want).abs().max().item() <= 2e-5
    bad = [t.to(cuda_device) for t in _bad(args)]
    with pytest.raises(exc):
        fa.flash_attention(*bad, block_q=32, block_k=32)
    assert fa.launches == {**before, "f32": before["f32"] + 1}
