"""The backward of the video DiT's joint attention: the port's plain version
(autograd through ``attention_plain``) against ``jax.vjp`` of the JAX
package's ``_joint_attention`` on the CPU (``jax.nn.dot_product_attention``
there), and the CUDA kernels (``fluidnexus_torch/csrc/attention_bwd.cu``,
behind ``JointAttentionFn``, with the forward's row log-sum-exp) against the
plain version on the card. The card-only tests are marked `cuda` and skip
here; JAX is imported inside the CPU tests only, so on a machine with the
card and without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_bwd.py
"""
import math

import numpy as np
import pytest
import torch

from fluidnexus_torch.ops import attention_cuda as ac
from tests.torch_helpers import cuda_device  # noqa: F401


def _qkv(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [1, 47, 300])
@pytest.mark.parametrize("d", [16, 64])
def test_plain_backward_matches_jax_grad(s, d):
    """dq, dk, dv of the plain version by autograd against ``jax.vjp`` of the
    JAX CPU path, each at 1e-5 of its own max|ref| (f32 both sides)."""
    import jax
    import jax.numpy as jnp

    from fluidnexus_tpu.diffusion.video.dit import _joint_attention

    q, k, v = _qkv(2, 3, s, d, seed=s + d + 1)
    dout = np.random.default_rng(s).normal(size=(2, s, 3, d)).astype(np.float32)
    _, vjp = jax.vjp(_joint_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(dout))
    got = ac.attention_bwd_plain(*(torch.as_tensor(x) for x in (q, k, v)), torch.as_tensor(dout))
    for name, g, r in zip("qkv", got, refs):
        r = np.asarray(r)
        assert g.shape == r.shape == (2, 3, s, d), name
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_cpu_autograd_of_joint_attention_is_the_plain_backward():
    q, k, v = (torch.as_tensor(x).requires_grad_() for x in _qkv(1, 2, 33, 16, seed=5))
    dout = torch.randn(1, 33, 2, 16, generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(ac.joint_attention(q, k, v), (q, k, v), dout)
    for g, r in zip(grads, ac.attention_bwd_plain(q, k, v, dout)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    lse = ac.attention_lse_plain(q.detach(), k.detach())
    ref = torch.logsumexp(q.detach() @ k.detach().transpose(-1, -2) / 4.0, -1)
    torch.testing.assert_close(lse, ref, rtol=1e-6, atol=1e-6)


def test_cpu_bwd_takes_no_launch():
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 1, 5, 16, seed=4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ac.attention_bwd(q, k, v, q.transpose(1, 2), q[..., 0], q.transpose(1, 2))


def _bwd_inputs(b, h, s, d, seed, device, dtype, shift=0.0):
    """q, k, v (v a strided view of a (b, s, h, 3d) projection, as in the
    DiT) and dout; with ``shift`` c > 0 (q + c, k - c) every logit lies near
    -c^2 sqrt(d)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3))
    q, k = q + shift, k - shift
    dout = rng.normal(size=(b, s, h, d)).astype(np.float32)
    q, k, v, dout = (torch.as_tensor(x, device=device).to(dtype) for x in (q, k, v, dout))
    v_view = torch.cat([q, k, v], -1).transpose(1, 2).contiguous()[..., 2 * d:].transpose(1, 2)
    return q, k, v_view, dout


def _bwd_ok(dtype, grads, refs, tol=None):
    """Per output: f32 max|err| <= 2e-5 of that output's max|ref|; bf16 max
    <= 1e-2 and mean <= 2e-3 of it (P and dS are rounded to bf16 for the
    products). The scale is floored at 1e-3 of the largest output's: dq and
    dk are exactly 0 where the softmax has one key (s = 1)."""
    out = []
    floor = 1e-3 * max(float(r.abs().max()) for r in refs)
    for g, r in zip(grads, refs):
        err = (g.float() - r.float()).abs()
        scale = max(float(r.abs().max()), floor)
        emax, emean = float(err.max()), float(err.mean())
        ok = emax <= 2e-5 * scale if dtype == torch.float32 else (
            emax <= 1e-2 * scale and emean <= 2e-3 * scale)
        if tol is not None:
            ok = emax <= tol * scale
        out.append((ok, emax / scale, emean / scale))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_backward_kernels_match_plain_on_the_card(cuda_device, dtype, d):
    """Ragged lengths through JointAttentionFn (autograd), per output; the
    row log-sum-exp against torch.logsumexp of the plain scores; one case
    whose logits all lie near -150, where a pad key's unmasked P overflows
    and turns dQ into NaN: held finite and within 1e-3 (f32) or 5e-2 (bf16)
    of each output's max|ref| (f32's rounding of logits that large, peaked
    softmaxes)."""
    for s, low in ((1, False), (47, False), (64, False), (65, False), (777, False), (65, True)):
        shift = math.sqrt(150.0 / math.sqrt(d)) if low else 0.0
        q, k, v, dout = _bwd_inputs(2, 3, s, d, s + d, cuda_device, dtype, shift)
        before = dict(ac.LAUNCHES)
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        out = ac.joint_attention(qq, kk, vv)
        grads = torch.autograd.grad(out, (qq, kk, vv), dout)
        torch.cuda.synchronize()
        assert {n: ac.LAUNCHES[n] - before[n] for n in ac.LAUNCHES} == {
            "attention_fwd": 1, "attention_dq": 1, "attention_dkv": 1}
        refs = ac.attention_bwd_plain(q, k, v, dout)
        if low:
            tol = 1e-3 if dtype == torch.float32 else 5e-2
            assert all(bool(torch.isfinite(g).all()) for g in grads), s
            assert all(ok for ok, _, _ in _bwd_ok(dtype, grads, refs, tol)), s
            continue
        res = _bwd_ok(dtype, grads, refs)
        assert all(ok for ok, _, _ in res), (s, res)
        _, lse = ac.attention_fwd(q, k, v, lse=True)
        ref = ac.attention_lse_plain(q, k)
        assert float((lse - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max())), s


@pytest.mark.cuda
def test_backward_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 1, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="lse is"):
        ac.attention_bwd(q, q, q, q.transpose(1, 2), torch.zeros(1, 1, 9, device=cuda_device),
                         q.transpose(1, 2))
