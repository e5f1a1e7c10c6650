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
    before = fa.launches
    got = fa.flash_attention(q, k, v, block_q=32, block_k=32)
    want = fa.flash_attention_reference(q, k, v, block_q=32, block_k=32)
    assert torch.equal(got, want)
    assert got.shape == (2, 64, 4 * 32) and got.dtype == torch.float32
    assert fa.launches == before


def test_reference_kernel_cannot_be_differentiated():
    """The reference kernel is forward only: ``jax.grad`` through it fails."""
    q, k, v = (jnp.asarray(a) for a in _inputs(8, t=64))
    with pytest.raises(AssertionError):
        jax.grad(lambda q: ref_flash(q, k, v, block_q=32, block_k=32,
                                     interpret=True).sum())(q)


def _requiring_grad(seed):
    return [torch.from_numpy(a).requires_grad_(True)
            for a in _inputs(seed, t=64)]


def test_backward_raises_on_cpu():
    q, k, v = _requiring_grad(9)
    out = fa.flash_attention(q, k, v, block_q=32, block_k=32)
    assert out.grad_fn is not None
    with pytest.raises(RuntimeError, match="forward only"):
        out.sum().backward()
    assert q.grad is None and k.grad is None and v.grad is None


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


def test_train_step_with_flash_attention_raises_at_first_step():
    cfg = llama.LlamaConfig.tiny()
    params = llama.trainable(llama.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    before = [p.detach().clone() for p in tree_leaves(params)]
    step = llama.make_train_step(cfg, optim.adamw(params, 1e-3),
                                 attn_fn=fa.flash_attention)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))
    with pytest.raises(RuntimeError, match="forward only"):
        step(params, tokens)
    for p, b in zip(tree_leaves(params), before):
        assert torch.equal(p, b) and p.grad is None


def _bad(change):
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, t=64))
    return change(q, k, v)


@pytest.mark.parametrize("case,args,exc", [
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
])
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
# of 16, a T that is a multiple of 128 but not of 256, and group 4 at D=64.
_CARD_SHAPES = [(2, 128, 4, 2, 32), (1, 2048, 32, 8, 128),
                (4, 512, 32, 8, 128), (2, 96, 8, 8, 64), (2, 40, 4, 1, 128),
                (1, 384, 32, 8, 128), (3, 640, 8, 2, 64)]


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
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_forward_only_on_card(cuda_device, dtype):
    """With inputs that require grad the kernel still launches once and
    gives the same output, and its backward raises, as on the CPU."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn((1, 256, h, 128), generator=g, device=cuda_device)
               .to(dtype).requires_grad_(True) for h in (32, 8, 8))
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    assert fa.launches == before + 1 and out.grad_fn is not None
    with torch.no_grad():
        want = fa.flash_attention(q, k, v)
    assert torch.equal(out.detach(), want)
    with pytest.raises(RuntimeError, match="forward only"):
        out.float().sum().backward()
    assert q.grad is None
