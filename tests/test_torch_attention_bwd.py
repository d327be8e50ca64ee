"""The backward of the video DiT's joint attention: the port's plain version
(autograd through ``attention_plain``) against ``jax.vjp`` of the JAX
package's ``_joint_attention`` on the CPU (``jax.nn.dot_product_attention``
there); which C entry ``attention_bwd`` calls, with what, and what it counts,
through a stand-in library on CPU tensors; and the CUDA kernels
(``fluidnexus_torch/csrc/attention_bwd.cu``: the Hopper kernel for bf16 at
head_dim 64, the mma.sync pair otherwise, behind ``JointAttentionFn``, with
the forward's row log-sum-exp) against the plain version on the card. The card-only tests are marked `cuda` and skip
here; JAX is imported inside the CPU tests only, so on a machine with the
card and without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_bwd.py
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


class _RecordingBwdLib:
    """Stands in for the built backward library on CPU tensors: records each
    C entry the wrapper calls and with what; the Hopper entry copies the rows
    it is handed (through their pointer) and writes ``dq_value`` into the dq
    workspace through its pointer and strides, as the kernel would, and
    returns ``wgmma_err``."""

    def __init__(self, dq_value=None, wgmma_err=0):
        self.calls, self.dq_value, self.wgmma_err, self.rows = [], dq_value, wgmma_err, None

    def fnx_attention_bwd(self, *args):
        self.calls.append(("fnx_attention_bwd", args[0], list(args[11:16]), list(args[16])))
        return 0

    def fnx_attention_bwd_wgmma(self, *args):
        b, h, s = args[8:11]
        st = list(args[11])
        self.calls.append(("fnx_attention_bwd_wgmma", args[:4], st))
        nq = -(-s // ac.BWD_TILE)
        n = b * h * nq * 2 * ac.BWD_TILE
        self.rows = np.ctypeslib.as_array((ctypes.c_float * n).from_address(args[4])).copy()
        if self.wgmma_err == 0 and self.dq_value is not None:
            flat = np.ctypeslib.as_array(
                (ctypes.c_float * (b * h * s * 64)).from_address(args[5]))
            ws = np.lib.stride_tricks.as_strided(flat, (b, h, s, 64),
                                                 [4 * x for x in st[12:15]] + [4])
            ws[...] = self.dq_value
        return self.wgmma_err


def _route_bwd(monkeypatch, lib, fn, q, k, v, out, lse, dout):
    """``fn`` (``attention_bwd`` or ``_attention_bwd_mma_sync``) on CPU
    tensors passed off as CUDA ones, into ``lib``."""
    monkeypatch.setattr(ac, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(cuda_build, "require_cuda", lambda x, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    return fn(q, k, v, out, lse, dout)


def _dit_bwd_inputs(b, h, s, d, dtype):
    """q, k contiguous and v a (b, h, s, d) view of a (b, s, 3 h d)
    projection, as the DiT hands them to the attention; out and dout (b, s,
    h, d); lse (b, h, s) f32."""
    gen = torch.Generator().manual_seed(s + d)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen).to(dtype)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.split(h * d, -1))
    out, dout = (torch.randn((b, s, h, d), generator=gen).to(dtype) for _ in range(2))
    return q.contiguous(), k.contiguous(), v, out, torch.randn((b, h, s), generator=gen), dout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_which_backward_takes_which_dtype_and_head_dim(monkeypatch, dtype, d):
    """bf16 at head_dim 64 makes one call, to the Hopper entry, with q, k,
    the DiT's strided v and dout's (b, h, s, d) view as they are (their
    pointers and strides), the dq workspace's (b, s, h, d) strides, and
    dk's and dv's; it counts one ``attention_bwd_wgmma``. Every other case
    calls the mma.sync entry for dq, then dkv, with its dtype code and
    head_dim, and counts one of each."""
    b, h, s = 2, 3, 5
    q, k, v, out, lse, dout = _dit_bwd_inputs(b, h, s, d, dtype)
    lib = _RecordingBwdLib()
    ac.reset_launches()
    grads = _route_bwd(monkeypatch, lib, ac.attention_bwd, q, k, v, out, lse, dout)
    assert [g.shape for g in grads] == [(b, h, s, d)] * 3
    if ac.takes_wgmma(dtype, d):
        ((entry, ptrs, st),) = lib.calls
        do_view = dout.transpose(1, 2)
        assert entry == "fnx_attention_bwd_wgmma"
        assert ptrs == (q.data_ptr(), k.data_ptr(), v.data_ptr(), do_view.data_ptr())
        assert st == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do_view.stride()[:3],
                      s * h * d, d, h * d, *grads[1].stride()[:3], *grads[2].stride()[:3]]
        want = {"attention_bwd_wgmma": 1}
    else:
        assert [(c[0], c[1], c[2]) for c in lib.calls] == [
            ("fnx_attention_bwd", w, [int(dtype == torch.bfloat16), b, h, s, d]) for w in (0, 1)]
        want = {"attention_dq": 1, "attention_dkv": 1}
    assert ac.LAUNCHES == {n: want.get(n, 0) for n in ac.LAUNCHES}


def test_wgmma_backward_hands_the_kernel_its_rows_and_casts_its_dq(monkeypatch):
    """What the Hopper entry reads and what the wrapper makes of what it
    writes: per 128-query tile the lse times log2(e) (+inf past s) and D =
    rowsum(dout * out) in f32 (0 past s), exactly; the f32 dq workspace,
    written through the pointer and strides handed over, comes back as dq in
    bf16, (b, h, s, d) over a contiguous (b, s, h, d)."""
    b, h, s, d = 2, 3, 130, 64
    q, k, v, out, lse, dout = _dit_bwd_inputs(b, h, s, d, torch.bfloat16)
    dq_value = np.random.default_rng(0).normal(size=(b, h, s, d)).astype(np.float32)
    lib = _RecordingBwdLib(dq_value=dq_value)
    grads = _route_bwd(monkeypatch, lib, ac.attention_bwd, q, k, v, out, lse, dout)
    rows = torch.as_tensor(lib.rows).view(b, h, 2, 2, 128)
    assert torch.equal(rows, ac.bwd_rows(lse, (dout.float() * out.float()).sum(-1).transpose(1, 2)))
    lse2 = rows[:, :, :, 0].reshape(b, h, 256)
    dd = rows[:, :, :, 1].reshape(b, h, 256)
    torch.testing.assert_close(lse2[..., :s], lse * math.log2(math.e), rtol=0, atol=0)
    assert bool(torch.isposinf(lse2[..., s:]).all()) and bool((dd[..., s:] == 0).all())
    torch.testing.assert_close(dd[..., :s], (dout.float() * out.float()).sum(-1).transpose(1, 2),
                               rtol=0, atol=0)
    assert grads[0].dtype == torch.bfloat16 and grads[0].transpose(1, 2).is_contiguous()
    torch.testing.assert_close(grads[0], torch.as_tensor(dq_value).to(torch.bfloat16),
                               rtol=0, atol=0)


def test_a_backward_tensor_map_that_cannot_be_encoded_raises_and_falls_back_to_nothing(
        monkeypatch):
    lib = _RecordingBwdLib(wgmma_err=1000 + 1)
    ac.reset_launches()
    with pytest.raises(RuntimeError, match=r"tensor map .* could not be encoded \(CUresult 1\)"):
        _route_bwd(monkeypatch, lib, ac.attention_bwd, *_dit_bwd_inputs(1, 2, 9, 64,
                                                                        torch.bfloat16))
    assert [c[0] for c in lib.calls] == ["fnx_attention_bwd_wgmma"]
    assert all(c == 0 for c in ac.LAUNCHES.values()), ac.LAUNCHES


def test_mma_sync_backward_is_forced_at_bf16_head_dim_64(monkeypatch):
    """``_attention_bwd_mma_sync`` runs the pair where ``attention_bwd`` would
    take the Hopper kernel, and counts the pair; on a real CPU tensor (no
    stand-in) it raises, as ``attention_bwd`` does."""
    inputs = _dit_bwd_inputs(1, 2, 9, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ac._attention_bwd_mma_sync(*inputs)
    lib = _RecordingBwdLib()
    ac.reset_launches()
    _route_bwd(monkeypatch, lib, ac._attention_bwd_mma_sync, *inputs)
    assert [(c[0], c[1]) for c in lib.calls] == [("fnx_attention_bwd", 0), ("fnx_attention_bwd", 1)]
    assert ac.LAUNCHES == {n: int(n in ("attention_dq", "attention_dkv")) for n in ac.LAUNCHES}


@pytest.mark.parametrize("s", [1, 127, 128, 129, 300])
def test_bwd_rows_pads_each_query_tile(s):
    """``bwd_rows``: contiguous f32 (b, h, ceil(s / 128), 2, 128), each tile's
    lse times log2(e) then D, +inf and 0 past s."""
    gen = torch.Generator().manual_seed(s)
    lse, dsum = torch.randn((2, 3, s), generator=gen), torch.randn((2, 3, s), generator=gen)
    rows = ac.bwd_rows(lse, dsum.transpose(1, 2).contiguous().transpose(1, 2))
    nq = -(-s // 128)
    assert rows.shape == (2, 3, nq, 2, 128) and rows.is_contiguous()
    want = torch.full((2, 3, 2, nq * 128), math.inf)
    want[:, :, 0, :s] = lse * math.log2(math.e)
    want[:, :, 1] = 0.0
    want[:, :, 1, :s] = dsum
    torch.testing.assert_close(rows, want.view(2, 3, 2, nq, 128).transpose(2, 3), rtol=0, atol=0)


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
        wgmma = int(ac.takes_wgmma(dtype, d))
        assert {n: ac.LAUNCHES[n] - before[n] for n in ac.LAUNCHES} == {
            "attention_fwd": 1, "attention_fwd_wgmma": wgmma, "attention_bwd_wgmma": wgmma,
            "attention_dq": 1 - wgmma, "attention_dkv": 1 - wgmma}
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


@pytest.mark.cuda
def test_wgmma_backward_matches_plain_at_ragged_s(cuda_device):
    """The Hopper backward at s shorter than one 128-key tile, at one tile,
    one past it and several tiles with a ragged last one, on the DiT's
    contiguous q and k and strided v: one launch of that kernel and none of
    the pair per call; each output within 1e-2 max and 2e-3 mean of its own
    max|ref| (bf16 P and dS). The mma.sync pair, forced, at the same limits."""
    for s in (1, 47, 64, 127, 128, 129, 300, 777):
        q, k, v, dout = _bwd_inputs(2, 3, s, 64, s, cuda_device, torch.bfloat16)
        out, lse = ac.attention_fwd(q, k, v, lse=True)
        refs = ac.attention_bwd_plain(q, k, v, dout)
        before = dict(ac.LAUNCHES)
        grads = ac.attention_bwd(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        assert {n: ac.LAUNCHES[n] - before[n] for n in ac.LAUNCHES} == {
            "attention_fwd": 0, "attention_fwd_wgmma": 0, "attention_bwd_wgmma": 1,
            "attention_dq": 0, "attention_dkv": 0}
        res = _bwd_ok(torch.bfloat16, grads, refs)
        assert all(ok for ok, _, _ in res), (s, res)
        res = _bwd_ok(torch.bfloat16, ac._attention_bwd_mma_sync(q, k, v, out, lse, dout), refs)
        assert all(ok for ok, _, _ in res), (s, "mma.sync", res)


@pytest.mark.cuda
def test_wgmma_backward_reads_strided_inputs_in_place(cuda_device):
    """q, k, v and dout all views of other layouts ((b, h, s, d) views of (b,
    s, h, d) buffers; dout a (b, s, h, d) view of a (b, h, s, d) buffer): no
    copy is made (their strides are what TMA takes). dk and dv bit for bit
    as from the same values made contiguous; dq within the bf16 limit (its
    f32 sums across key blocks come in another order)."""
    q, k, v, dout = _bwd_inputs(2, 3, 300, 64, 7, cuda_device, torch.bfloat16)
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    dout = dout.transpose(1, 2).contiguous().transpose(1, 2)
    assert all(ac._kernel_layout(x) is x for x in (q, k, v, dout.transpose(1, 2)))
    out, lse = ac.attention_fwd(q, k, v, lse=True)
    grads = ac.attention_bwd(q, k, v, out, lse, dout)
    ref = ac.attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                           dout.contiguous())
    assert torch.equal(grads[1], ref[1]) and torch.equal(grads[2], ref[2])
    res = _bwd_ok(torch.bfloat16, grads[:1], ref[:1])
    assert all(ok for ok, _, _ in res), res


@pytest.mark.cuda
def test_wgmma_backward_at_low_logits(cuda_device):
    """Every logit near -150 (q + c, k - c) at s = 65 and 129: a pad key's P
    left unmasked overflows to inf and turns dQ into NaN. Held finite and
    within 5e-2 of each output's max|ref|, the bf16 limit of that case in
    chip_smoke.py."""
    for s in (65, 129):
        q, k, v, dout = _bwd_inputs(2, 3, s, 64, s, cuda_device, torch.bfloat16,
                                    math.sqrt(150.0 / math.sqrt(64)))
        out, lse = ac.attention_fwd(q, k, v, lse=True)
        grads = ac.attention_bwd(q, k, v, out, lse, dout)
        assert all(bool(torch.isfinite(g).all()) for g in grads), s
        res = _bwd_ok(torch.bfloat16, grads, ac.attention_bwd_plain(q, k, v, dout), 5e-2)
        assert all(ok for ok, _, _ in res), (s, res)


@pytest.mark.cuda
def test_wgmma_backward_dq_of_two_runs_agree(cuda_device):
    """dQ is summed in f32 across key blocks in an order that changes from
    run to run: two runs agree within the bf16 limit (1e-2 of max|dq|), not
    necessarily bit for bit; dk and dv, summed in registers, bit for bit."""
    q, k, v, dout = _bwd_inputs(2, 3, 777, 64, 11, cuda_device, torch.bfloat16)
    out, lse = ac.attention_fwd(q, k, v, lse=True)
    first = ac.attention_bwd(q, k, v, out, lse, dout)
    second = ac.attention_bwd(q, k, v, out, lse, dout)
    diff = float((first[0].float() - second[0].float()).abs().max())
    assert diff <= 1e-2 * float(first[0].float().abs().max()), diff
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
