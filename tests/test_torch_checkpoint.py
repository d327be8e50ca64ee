"""The port's ``load_params`` on the orbax directories that the JAX
package's ``save_params`` writes (its default where orbax imports, as here):
a tree like ``train_video``'s (a LoRA DiT; its ``--quant_base`` form with
int8 kernels; the same in bf16) and one like ``train_novel_view``'s, each
with its ``_ema`` sibling, read back bit for bit, dtypes included, without
orbax or JAX (``tensorstore`` reads them), and loaded into the port's
modules. The flat-npz branch, with orbax blocked, is held in
``tests/test_torch_sample_video.py`` and ``tests/test_torch_novel_view.py``."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidnexus_torch.convert import novel_view_from_numpy, video_dit_from_numpy
from fluidnexus_torch.core import checkpoint as tck
from fluidnexus_torch.diffusion.ldm import autoencoder as ta
from fluidnexus_torch.diffusion.ldm import clip as tc
from fluidnexus_torch.diffusion.ldm import unet as tu
from fluidnexus_tpu.core import checkpoint as jck
from fluidnexus_tpu.diffusion.video import dit as jdit
from tests.test_torch_ldm import CLI_CLIP, CLI_UNET, TINY_VAE, tiny_models
from tests.test_torch_video_dit import TINY, dit_params, jax_and_torch_cfg
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)


def _video_tree(kind):
    jcfg, tcfg = jax_and_torch_cfg(**TINY, lora_rank=2)
    _, params = dit_params(jcfg, seed=4)
    params = jax.tree.map(lambda x: np.asarray(getattr(x, "value", x)), params,
                          is_leaf=lambda x: hasattr(x, "value"))
    if kind == "quant":
        params = jax.tree.map(np.asarray, jdit.quantize_dit_params(params))
    elif kind == "bf16":
        params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)
    return params, tcfg


def _assert_same_tree(got, ref):
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(jax.tree_util.tree_leaves(got)) == len(flat)
    for path, want in flat:
        node = got
        for k in path:
            node = node[k.key]
        want = np.asarray(want)
        assert isinstance(node, np.ndarray) and node.dtype == want.dtype, (path, node.dtype)
        assert node.shape == want.shape, path
        np.testing.assert_array_equal(node.view(np.uint8), want.view(np.uint8), err_msg=str(path))


@pytest.mark.parametrize("kind", ["float", "quant", "bf16", "novel_view"])
def test_load_params_reads_the_jax_orbax_directory(tmp_path, kind):
    if kind == "novel_view":
        _, params, _ = tiny_models(seed=2)
        ema = jax.tree.map(lambda x: x * np.float32(0.5), params)
    else:
        params, tcfg = _video_tree(kind)
        ema = jax.tree.map(lambda x: x + x if x.dtype != np.int8 else x, params)
    it = str(tmp_path / "iter_0000002")
    jck.save_params(it, params)
    jck.save_params(it + "_ema", ema)
    assert (tmp_path / "iter_0000002" / "_METADATA").is_file()
    assert not (tmp_path / "iter_0000002.npz").exists()
    got = tck.load_params(it)
    _assert_same_tree(got, jck.load_params(it))
    _assert_same_tree(got, params)
    _assert_same_tree(tck.load_params_prefer_ema(it), jck.load_params_prefer_ema(it))
    _assert_same_tree(tck.load_params_prefer_ema(it + "/"), ema)
    if kind == "novel_view":
        configs = dict(unet_config=tu.UNetConfig(**CLI_UNET),
                       vae_config=ta.KLVAEConfig(**TINY_VAE),
                       clip_config=tc.CLIPVisionConfig(**CLI_CLIP))
        model = novel_view_from_numpy(got, configs, "cpu")
        w = dict(model.named_parameters())["cc.weight"].detach().numpy()
        np.testing.assert_array_equal(w, got["cc"]["kernel"].T)
    else:
        model = video_dit_from_numpy(got, dataclasses.replace(tcfg, base_quant=kind == "quant"),
                                     "cpu")
        p = dict(model.named_parameters())
        qkv = got["block_0"]["attn"]["qkv"]
        if kind == "quant":
            np.testing.assert_array_equal(p["block_0.attn.qkv.kernel_q"].detach().numpy(),
                                          qkv["kernel_q"])
        else:
            np.testing.assert_array_equal(p["block_0.attn.qkv.weight"].detach().numpy(),
                                          qkv["kernel"].astype(np.float32).T)


def test_orbax_zarr3_and_what_is_not_a_checkpoint(tmp_path, monkeypatch):
    """A tree that newer orbax writes as zarr v3 arrays reads the same; a
    directory without ``_METADATA`` is no orbax checkpoint; without
    tensorstore an orbax directory raises naming it and the npz format."""
    import orbax.checkpoint as ocp

    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "q": np.arange(-3, 3, dtype=np.int8)}
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
        str(tmp_path / "z3"), args=ocp.args.PyTreeSave(tree))
    _assert_same_tree(tck.load_params(str(tmp_path / "z3")), tree)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="orbax"):
        tck.load_params(str(tmp_path / "empty"))
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore.*npz"):
        tck.load_params(str(tmp_path / "z3"))
