"""The video DiT's joint attention: the port's plain version against the JAX
package's ``_joint_attention`` on the CPU (``jax.nn.dot_product_attention``
there), and the CUDA kernel (``fluidnexus_torch/csrc/attention.cu``) against
the plain version on the card. The card-only tests are marked `cuda` and skip
here; JAX is imported inside the CPU tests only, so on a machine with the
card and without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention.py
"""
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
def test_plain_matches_jax_joint_attention(s, d):
    import jax.numpy as jnp

    from fluidnexus_tpu.diffusion.video.dit import _joint_attention

    q, k, v = _qkv(2, 3, s, d, seed=s + d)
    ref = np.asarray(_joint_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = ac.joint_attention(*(torch.as_tensor(x) for x in (q, k, v)))
    assert out.shape == (2, s, 3, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_plain_query_chunks_change_nothing():
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 2, 130, 16, seed=3))
    torch.testing.assert_close(ac.attention_plain(q, k, v, rows=7),
                               ac.attention_plain(q, k, v), rtol=0, atol=0)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    ac.reset_launches()
    q, k, v = (torch.as_tensor(x) for x in _qkv(1, 1, 5, 16, seed=4))
    ac.joint_attention(q, k, v)
    assert ac.LAUNCHES["attention_fwd"] == 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ac.attention_fwd(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_kernel_matches_plain_on_the_card(cuda_device, dtype, d):
    """Ragged sequence lengths, the v input a strided view as in the DiT.
    Limits: bf16 output with bf16 P, max|err| <= 1e-2 max|ref|, mean|err|
    <= 2e-3 max|ref|; f32, 1e-5 of max|ref|."""
    for s in (1, 47, 64, 65, 777):
        q, k, v = (torch.as_tensor(x, device=cuda_device).to(dtype) for x in _qkv(2, 3, s, d, s))
        qkv = torch.cat([q, k, v], -1).transpose(1, 2).contiguous()   # (b, s, h, 3d)
        v_view = qkv[..., 2 * d:].transpose(1, 2)
        before = ac.LAUNCHES["attention_fwd"]
        out = ac.joint_attention(q, k, v_view)
        torch.cuda.synchronize()
        assert ac.LAUNCHES["attention_fwd"] == before + 1
        ref = ac.attention_plain(q, k, v).float()
        err = (out.float() - ref).abs()
        scale = float(ref.abs().max())
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-5 * scale, (s, float(err.max()), scale)
        else:
            assert float(err.max()) <= 1e-2 * scale, (s, float(err.max()), scale)
            assert float(err.mean()) <= 2e-3 * scale, (s, float(err.mean()), scale)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 1, 8, 48), device=cuda_device)
    with pytest.raises(ValueError, match="d in"):
        ac.joint_attention(q, q, q)
    h = torch.zeros((1, 1, 8, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ac.joint_attention(h, h, h)
