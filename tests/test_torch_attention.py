"""The video DiT's joint attention: the port's plain version against the JAX
package's ``_joint_attention`` on the CPU (``jax.nn.dot_product_attention``
there), which kernel takes which inputs and in what layout, and the CUDA
kernels (``fluidnexus_torch/csrc/attention.cu``: the Hopper kernel at bf16 and
head_dim 64, the mma.sync kernel otherwise; ``csrc/hopper_probe.cu``, the
Hopper building blocks on one tile) against the plain version or
``torch.matmul`` on the card. The card-only tests are marked `cuda` and skip
here; JAX is imported inside the CPU tests only, so on a machine with the
card and without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention.py
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from fluidnexus_torch.ops import attention_cuda as ac
from fluidnexus_torch.ops import cuda_build
from tests.torch_helpers import cuda_device  # noqa: F401
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)


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


def _dit_qkv(b, h, s, d, dtype=torch.bfloat16, device="cpu"):
    """q and k contiguous (b, h, s, d) and v a (b, h, s, d) view of a (b, s,
    3 h d) projection, as the DiT hands them to the attention."""
    qkv = torch.randn((b, s, 3 * h * d), generator=torch.Generator().manual_seed(s)).to(dtype)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.to(device).split(h * d, -1))
    return q.contiguous(), k.contiguous(), v


def _tma_readable(x):
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st > 0 and st * x.element_size() % 16 == 0 for st in x.stride()[:3]))


class _RecordingLib:
    """Stands in for the built library: records which C entry the wrapper
    calls and with what, and returns ``wgmma_err`` from the Hopper entry."""

    def __init__(self, wgmma_err=0):
        self.calls, self.wgmma_err = [], wgmma_err

    def fnx_attention_fwd(self, *args):
        self.calls.append(("fnx_attention_fwd", args))
        return 0

    def fnx_attention_fwd_wgmma(self, *args):
        self.calls.append(("fnx_attention_fwd_wgmma", args))
        return self.wgmma_err


def _route(monkeypatch, lib, q, k, v):
    """``attention_fwd`` on CPU tensors passed off as CUDA ones, into ``lib``."""
    monkeypatch.setattr(ac, "_lib", lambda: lib)
    monkeypatch.setattr(cuda_build, "require_cuda", lambda x, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    return ac.attention_fwd(q, k, v, lse=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_which_kernel_takes_which_dtype_and_head_dim(monkeypatch, dtype, d):
    """bf16 at head_dim 64 calls the Hopper entry, with no dtype or head_dim
    argument (it has one instantiation) and counts a launch of each count;
    every other case calls the mma.sync entry with its dtype code and
    head_dim and counts ``attention_fwd`` alone. Either gets the row
    strides of the DiT's q, k and strided v as they are."""
    q, k, v = _dit_qkv(2, 3, 5, d, dtype=dtype)
    lib = _RecordingLib()
    ac.reset_launches()
    out, lse = _route(monkeypatch, lib, q, k, v)
    assert out.shape == (2, 5, 3, d) and lse.shape == (2, 3, 5)
    wgmma = dtype == torch.bfloat16 and d == 64
    ((entry, args),) = lib.calls
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if wgmma:
        assert entry == "fnx_attention_fwd_wgmma" and args[5:17] == (2, 3, 5, *strides)
    else:
        assert entry == "fnx_attention_fwd"
        assert args[5:19] == (int(dtype == torch.bfloat16), 2, 3, 5, d, *strides)
    assert ac.LAUNCHES == {"attention_fwd": 1, "attention_fwd_wgmma": int(wgmma),
                           "attention_bwd_wgmma": 0, "attention_dq": 0, "attention_dkv": 0}


def test_a_tensor_map_that_cannot_be_encoded_raises_and_falls_back_to_nothing(monkeypatch):
    lib = _RecordingLib(wgmma_err=1000 + 1)
    ac.reset_launches()
    with pytest.raises(RuntimeError, match=r"tensor map .* could not be encoded \(CUresult 1\)"):
        _route(monkeypatch, lib, *_dit_qkv(1, 2, 9, 64))
    assert [entry for entry, _ in lib.calls] == ["fnx_attention_fwd_wgmma"]
    assert all(c == 0 for c in ac.LAUNCHES.values()), ac.LAUNCHES


def test_kernel_layout_keeps_the_dit_inputs_in_place():
    q, k, v = _dit_qkv(2, 4, 37, 64)
    assert v.stride() == (37 * 3 * 4 * 64, 64, 3 * 4 * 64, 1)
    for x in (q, k, v):
        assert ac._kernel_layout(x) is x
        assert _tma_readable(x)


@pytest.mark.parametrize("case", ["row_stride", "base", "zero_stride"])
def test_kernel_layout_copies_a_view_that_tma_cannot_read(case):
    if case == "row_stride":      # 68 elements a row: 136 bytes, not a multiple of 16
        x = torch.randn((2, 3, 5, 68)).to(torch.bfloat16)[..., :64]
    elif case == "base":          # one element into an allocation: 2 bytes off
        x = torch.randn(2 * 3 * 5 * 64 + 1).to(torch.bfloat16)[1:].view(2, 3, 5, 64)
    else:                         # one key and value broadcast over the heads
        x = torch.randn((2, 1, 5, 64)).to(torch.bfloat16).expand(2, 3, 5, 64)
    assert not _tma_readable(x)
    y = ac._kernel_layout(x)
    assert y is not x and y.is_contiguous() and _tma_readable(y)
    torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_cpu_bf16_head_dim_64_takes_the_plain_version_and_counts_no_launch():
    ac.reset_launches()
    q, k, v = _dit_qkv(1, 2, 9, 64)
    out = ac.joint_attention(q, k, v)
    torch.testing.assert_close(out, ac.attention_plain(q, k, v), rtol=0, atol=0)
    assert all(c == 0 for c in ac.LAUNCHES.values()), ac.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ac._attention_fwd_mma_sync(q, k, v)


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


def _errors(out, ref):
    err = (out.float() - ref.float()).abs()
    return float(err.max()), float(err.mean()), float(ref.float().abs().max())


@pytest.mark.cuda
def test_wgmma_kernel_matches_plain_at_ragged_s(cuda_device):
    """The Hopper kernel at s shorter than one 128-key tile, at one tile, one
    tile plus one and several tiles with a ragged last one, on the DiT's
    contiguous q and k and strided v; O within 1e-2 max and 2e-3 mean of
    max|ref| (bf16 output, bf16 P), the row log-sum-exp within 1e-5 of
    max(1, max|ref|). Each call is one launch of that kernel."""
    for s in (1, 47, 64, 127, 128, 129, 300, 777):
        q, k, v = _dit_qkv(2, 3, s, 64, device=cuda_device)
        before = dict(ac.LAUNCHES)
        out, lse = ac.attention_fwd(q, k, v, lse=True)
        torch.cuda.synchronize()
        assert ac.LAUNCHES["attention_fwd_wgmma"] == before["attention_fwd_wgmma"] + 1
        emax, emean, scale = _errors(out, ac.attention_plain(q, k, v))
        assert emax <= 1e-2 * scale and emean <= 2e-3 * scale, (s, emax, emean, scale)
        ref = ac.attention_lse_plain(q, k)
        assert float((lse - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max())), s


@pytest.mark.cuda
def test_wgmma_kernel_reads_strided_inputs_in_place(cuda_device):
    """q, k and v all (b, h, s, d) views of (b, s, h, d) buffers (no copy is
    made: their strides are what TMA takes), against the same values made
    contiguous."""
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in _dit_qkv(2, 3, 300, 64, device=cuda_device))
    assert all(ac._kernel_layout(x) is x for x in (q, k, v))
    out = ac.attention_fwd(q, k, v)
    ref = ac.attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.cuda
def test_wgmma_kernel_at_low_logits(cuda_device):
    """Every logit near -150 (q + c, k - c) at s = 65: a pad key left unmasked
    would take weight 2^0 against rows of weight 2^-216. Held finite and
    within 5e-2 of max|ref|, the bf16 limit of that case in chip_smoke.py."""
    c = math.sqrt(150.0 / math.sqrt(64))
    q, k, v = _dit_qkv(2, 3, 65, 64, device=cuda_device)
    q, k = q + c, k - c
    out, lse = ac.attention_fwd(q, k, v, lse=True)
    emax, _, scale = _errors(out, ac.attention_plain(q, k, v))
    assert bool(torch.isfinite(out).all()) and emax <= 5e-2 * scale, (emax, scale)
    ref = ac.attention_lse_plain(q, k)
    assert float((lse - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
def test_each_kernel_counts_its_own_launches(cuda_device):
    q, k, v = _dit_qkv(1, 2, 70, 64, device=cuda_device)
    ac.reset_launches()
    ac.joint_attention(q, k, v)
    ac.joint_attention(q[..., :16].contiguous(), k[..., :16].contiguous(), v[..., :16])
    ac.joint_attention(q.float(), k.float(), v.float())
    assert ac.LAUNCHES == {"attention_fwd": 3, "attention_fwd_wgmma": 1,
                           "attention_bwd_wgmma": 0, "attention_dq": 0, "attention_dkv": 0}
    out = ac._attention_fwd_mma_sync(q, k, v)
    assert ac.LAUNCHES["attention_fwd_wgmma"] == 1
    emax, emean, scale = _errors(out, ac.attention_plain(q, k, v))
    assert emax <= 1e-2 * scale and emean <= 2e-3 * scale


@pytest.mark.cuda
def test_hopper_blocks_on_one_tile(cuda_device):
    """csrc/hopper_probe.cu: TMA loads of a 64-row and two 128-row bf16 tiles
    (row strides 64, 192 and 320 elements) and a 1-D bulk copy of 256 f32;
    s = A B^T on wgmma from shared memory (m64n128k16) and w = A B[:64]^T
    (m64n64k16); o = bf16(s) V with A in registers
    and V read MN-major; t += B^T V with both operands read MN-major, summed
    into t_out by f32 pair reductions; u_c = bf16(s)[:, 64c:64c+64]^T V[:64]
    with bf16(s) stored to shared memory as A fragments and read back by the
    same MN-major product (the attention backward's dS K). s and t against
    torch.matmul of the same bf16 values in f32 (exact products, f32 sums in
    another order: 1e-5 of max|ref|), w against s's first 64 columns, o and u against the card's own s
    rounded to bf16 times V (1e-5 of max|ref|), t_out's start added, the
    bulk copy exact."""
    lib = cuda_build.load("hopper_probe")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.fnx_hopper_probe.argtypes = [p] * 10 + [ll] * 3 + [p]
    lib.fnx_hopper_probe.restype = ctypes.c_int
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((64, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    b = torch.randn((128, 192), generator=gen, device=cuda_device).to(torch.bfloat16)[:, 64:128]
    v = torch.randn((128, 320), generator=gen, device=cuda_device).to(torch.bfloat16)[:, 256:]
    r_in = torch.randn(256, generator=gen, device=cuda_device)
    t0 = torch.randn((64, 64), generator=gen, device=cuda_device)
    s_out = torch.empty((64, 128), device=cuda_device)
    o_out = torch.empty((64, 64), device=cuda_device)
    t_out = t0.clone()
    u_out = torch.empty((2, 64, 64), device=cuda_device)
    w_out = torch.empty((64, 64), device=cuda_device)
    r_out = torch.empty(256, device=cuda_device)
    err = lib.fnx_hopper_probe(a.data_ptr(), b.data_ptr(), v.data_ptr(), r_in.data_ptr(),
                               s_out.data_ptr(), o_out.data_ptr(), t_out.data_ptr(),
                               u_out.data_ptr(), w_out.data_ptr(), r_out.data_ptr(), a.stride(0),
                               b.stride(0), v.stride(0), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    torch.cuda.synchronize()
    s_ref = a.float() @ b.float().T
    assert float((s_out - s_ref).abs().max()) <= 1e-5 * float(s_ref.abs().max())
    assert float((w_out - s_ref[:, :64]).abs().max()) <= 1e-5 * float(s_ref[:, :64].abs().max())
    p_bf = s_out.to(torch.bfloat16).float()
    o_ref = p_bf @ v.float()
    assert float((o_out - o_ref).abs().max()) <= 1e-5 * float(o_ref.abs().max())
    t_ref = b.float().T @ v.float()
    assert float((t_out - t0 - t_ref).abs().max()) <= 1e-5 * float(t_ref.abs().max())
    for c in range(2):
        u_ref = p_bf[:, 64 * c:64 * c + 64].T @ v.float()[:64]
        assert float((u_out[c] - u_ref).abs().max()) <= 1e-5 * float(u_ref.abs().max()), c
    torch.testing.assert_close(r_out, r_in, rtol=0, atol=0)
