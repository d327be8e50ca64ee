"""State carried across from the JAX package.

``*_from_numpy`` turn the JAX package's states, given as numpy arrays
(``jax.tree.map(np.asarray, x)``), into the port's tensors on a device;
``*_to_numpy`` go the other way. Field names and order are the same in both
packages, so a state converts field by field.
"""
from __future__ import annotations

import numpy as np
import torch

from fluidnexus_torch.core.optim import AdamState
from fluidnexus_torch.diffusion.video.dit import VideoDiT
from fluidnexus_torch.diffusion.video.vae3d import VideoVAE
from fluidnexus_torch.ops.neighbors import DenseGrid
from fluidnexus_torch.sim.state import ParticleState, VisualState
from fluidnexus_torch.splat.background import BackgroundModel
from fluidnexus_torch.splat.dynamics import BackgroundSplats, VisualAttrs


def as_torch(x) -> torch.Tensor:
    """A numpy leaf as a tensor; a bfloat16 leaf (``ml_dtypes``, as
    tensorstore reads one from an orbax checkpoint) as ``torch.bfloat16``."""
    x = np.asarray(x)
    if not x.flags.c_contiguous:
        x = x.copy()
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(x)


def float_tensors(params, device):
    """A flat dict of weights (numpy arrays or tensors) as f32 tensors on
    ``device``."""
    return {k: as_torch(v).to(device, torch.float32) if not torch.is_tensor(v)
            else v.to(device, torch.float32) for k, v in params.items()}


def _t(x, device):
    return torch.as_tensor(np.array(x), device=device)


def _n(x):
    return x.detach().cpu().numpy()


def visual_state_from_numpy(v, device="cuda") -> VisualState:
    return VisualState(xyz=_t(v.xyz, device).to(torch.float32), alive=_t(v.alive, device).bool())


def visual_state_to_numpy(v: VisualState):
    return VisualState(xyz=_n(v.xyz), alive=_n(v.alive))


_INT_FIELDS = ("particle_id", "next_id")


def particle_state_from_numpy(s, device="cuda") -> ParticleState:
    def field(name):
        t = _t(getattr(s, name), device)
        if name == "alive":
            return t.bool()
        return t.to(torch.int32 if name in _INT_FIELDS else torch.float32)

    return ParticleState(**{name: field(name) for name in ParticleState._fields})


def particle_state_to_numpy(s: ParticleState) -> ParticleState:
    return ParticleState(*(_n(x) for x in s))


def dense_grid_from_numpy(g, device="cuda") -> DenseGrid:
    """The JAX package's ``DenseGrid`` (numpy fields) as the port's, so its
    tables can feed the port's pair passes."""
    def field(name):
        t = _t(getattr(g, name), device)
        if name == "bxyz":
            return t.to(torch.float32)
        return t.bool() if name == "bmask" else t.to(torch.int32)

    return DenseGrid(**{name: field(name) for name in DenseGrid._fields})


def visual_attrs_from_numpy(a, device="cuda") -> VisualAttrs:
    return VisualAttrs(*(_t(x, device).to(torch.float32) for x in a))


def visual_attrs_to_numpy(a: VisualAttrs):
    return VisualAttrs(*(_n(x) for x in a))


def background_from_numpy(b, device="cuda") -> BackgroundSplats:
    return BackgroundSplats(**{k: _t(getattr(b, k), device).to(torch.float32)
                               for k in ("xyz", "color", "scaling", "rotation", "opacity")})


def background_to_numpy(b: BackgroundSplats) -> dict:
    return {k: _n(getattr(b, k)) for k in ("xyz", "color", "scaling", "rotation", "opacity")}


def adam_state_from_numpy(s, device="cuda") -> AdamState:
    return AdamState(mu={k: _t(v, device) for k, v in s.mu.items()},
                     nu={k: _t(v, device) for k, v in s.nu.items()},
                     count=_t(s.count, device).to(torch.int32))


def adam_state_to_numpy(s: AdamState) -> AdamState:
    return AdamState(mu={k: _n(v) for k, v in s.mu.items()},
                     nu={k: _n(v) for k, v in s.nu.items()}, count=_n(s.count))


def background_model_from_numpy(model, opt=None, device="cuda"):
    """The JAX package's stage-1 ``BackgroundModel`` (and, if given, its Adam
    state), as numpy arrays, as the port's ``splat.background``
    ``BackgroundModel`` (and ``AdamState``): (model, opt)."""
    def field(name):
        t = _t(getattr(model, name), device)
        return t.bool() if name == "alive" else t.to(torch.float32)

    out = BackgroundModel(**{name: field(name) for name in BackgroundModel._fields})
    return out, (adam_state_from_numpy(opt, device) if opt is not None else None)


# ------------------------- flax parameter trees -------------------------


def _flatten_flax(tree, prefix=""):
    """{dotted path: numpy array} of a flax param tree. Boxed leaves (flax
    ``Partitioned``, as the DiT's LoRADense kernels are) are unboxed by
    their ``value``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flatten_flax(v, key))
        else:
            out[key] = np.asarray(getattr(v, "value", v))
    return out


def _torch_layout(name, x):
    """A flax leaf in the port's layout: a Dense kernel (in, out) becomes a
    weight (out, in), a Conv kernel (*k, in, out) a weight (out, in, *k)."""
    if name.split(".")[-1] != "kernel":
        return name, x
    nd = x.ndim
    return name[:-len("kernel")] + "weight", np.transpose(x, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def flax_param_names(params):
    """The module parameter names that ``load_flax_params`` fills from the
    flax tree ``params``."""
    return {_torch_layout(k, v)[0] for k, v in _flatten_flax(params).items()}


def load_flax_params(module, params, device="cuda", keep_missing=False):
    """Copy a flax param tree (numpy leaves) into ``module``'s parameters,
    each cast to the parameter's dtype; the two sets of names must be the
    same, except that with ``keep_missing`` a parameter the tree lacks keeps
    the module's value. Returns the module on ``device``."""
    flat = dict(_torch_layout(k, v) for k, v in _flatten_flax(params).items())
    own = dict(module.named_parameters())
    if set(flat) - set(own) or (set(own) - set(flat) and not keep_missing):
        raise ValueError(f"flax tree and module differ: only in the tree "
                         f"{sorted(set(flat) - set(own))[:8]}, only in the module "
                         f"{sorted(set(own) - set(flat))[:8]}")
    module = module.to(device)
    with torch.no_grad():
        for name, prm in module.named_parameters():
            if name not in flat:
                continue
            src = flat[name]
            if tuple(src.shape) != tuple(prm.shape):
                raise ValueError(f"{name}: tree {src.shape}, module {tuple(prm.shape)}")
            prm.copy_(as_torch(src).to(prm.dtype))
    return module


def flax_params_to_numpy(named):
    """The inverse of ``load_flax_params``: {dotted name: tensor} (a
    module's ``named_parameters()``, or such a dict with some leaves
    replaced, as the EMA of the trainables) as a nested flax tree of numpy.
    A ``weight`` (out, in, *k) goes back to a ``kernel`` (*k, in, out) (a
    1-d ``weight``, as T5's layer norms name theirs in flax too, stays);
    float leaves are saved as f32, the JAX package's parameter type, and
    int8 leaves as they are."""
    tree: dict = {}
    for name, x in named.items():
        x = x.detach()
        arr = (x.float() if x.is_floating_point() else x).cpu().numpy()
        if name.split(".")[-1] == "weight" and arr.ndim >= 2:
            name = name[:-len("weight")] + "kernel"
            arr = np.transpose(arr, tuple(range(2, arr.ndim)) + (1, 0))
        *parents, leaf = name.split(".")
        d = tree
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = np.ascontiguousarray(arr)
    return tree


def video_dit_from_numpy(params, cfg, device="cuda"):
    """The JAX ``VideoDiT`` param tree (numpy) as the port's ``VideoDiT``."""
    with torch.device(device):
        model = VideoDiT(cfg)
    return load_flax_params(model, params, device)


def vae3d_from_numpy(params, cfg, device="cuda"):
    """The JAX ``VideoVAE`` param tree (numpy) as the port's ``VideoVAE``."""
    with torch.device(device):
        vae = VideoVAE(cfg)
    return load_flax_params(vae, params, device)


def t5_encoder_from_numpy(params, cfg, device="cuda"):
    """A Flax T5 parameter tree (numpy; ``utils/flax_msgpack``) as the port's
    ``T5Encoder`` on ``device``, in f32. Of a whole T5's tree (decoder, LM
    head) only ``shared`` and ``encoder`` are taken, as
    ``FlaxT5EncoderModel`` takes them."""
    from fluidnexus_torch.diffusion.video.t5 import T5Encoder

    with torch.device("meta"):
        model = T5Encoder(cfg)
    tree = {"shared": params["shared"], "encoder": params["encoder"]}
    return load_flax_params(model.to_empty(device=device), tree, device)


def novel_view_from_numpy(params, configs=None, device="cuda"):
    """The JAX ``NovelViewModel`` param tree ({"unet", "vae", "clip", "cc"},
    numpy) as the port's ``NovelViewModel``; ``configs`` are its keyword
    arguments (``unet_config``, ``vae_config``, ``clip_config``), the full
    geometry when None. ``flax_params_to_numpy(model.named_parameters())``
    gives the tree back."""
    from fluidnexus_torch.diffusion.ldm.model import build_novel_view

    return load_flax_params(build_novel_view(device, **(configs or {})), params, device)
