"""One stage-1 (background Gaussians) iteration on the card against the same
iteration on the CPU, where the rasterizer's wrappers take their plain
versions: the loss, and the gradients of the five trainables and of the
screen-space means (through the first Adam moments, 0.1 x the gradient, and
the densification accumulator); and one ``densify_and_prune`` on the card
against the CPU with the same noise (its stable argsorts, masked writes and
zeroed Adam moments). Marked `cuda`; skips where there is no card. The file
imports no JAX and no Pillow:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_background_kernels.py
"""
import numpy as np
import pytest
import torch

from fluidnexus_torch.core.optim import adam_init
from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.ops import rasterizer_cuda as tc
from fluidnexus_torch.ops.rasterizer import RasterizerConfig, rasterize
from fluidnexus_torch.pipelines import train_background as tbg
from fluidnexus_torch.splat import background as tback
from tests.torch_helpers import cuda_device  # noqa: F401
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda


def _scene(width=96, height=64, n=3000, seed=0):
    """A camera, its target (a render of 60 seeded Gaussians) and ``n``
    initial points in front of it."""
    rng = np.random.default_rng(seed)
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
    cam = Camera(uid=0, R=R, T=-R.T @ np.array([0.0, 0.0, 3.0]), fovx=0.7, fovy=0.5,
                 width=width, height=height)
    with torch.no_grad():
        out = rasterize(
            torch.as_tensor(rng.uniform(-0.5, 0.5, (60, 3)), dtype=torch.float32),
            torch.as_tensor(rng.uniform(0.1, 0.9, (60, 3)), dtype=torch.float32),
            torch.as_tensor(rng.uniform(0.5, 0.95, 60), dtype=torch.float32),
            torch.as_tensor(np.exp(rng.uniform(-2.6, -1.8, (60, 3))), dtype=torch.float32),
            torch.tensor([[1.0, 0, 0, 0]]).repeat(60, 1),
            view_matrix=torch.as_tensor(cam.world_view), proj_matrix=torch.as_tensor(
                cam.full_proj), tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=width,
            height=height, bg_color=torch.zeros(3), config=RasterizerConfig())
    points = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    return cam, out.color, points


def _one_step(device, cam, gt, points, raster_cfg):
    bp = tback.BackgroundParams(capacity=4096)
    model = tback.create_from_points(points, bp, device=device)
    # anisotropic, rotated Gaussians so every trainable has a gradient
    rng = np.random.default_rng(1)
    model = model._replace(
        scaling=model.scaling + torch.as_tensor(rng.uniform(-0.5, 1.5, (4096, 3)),
                                                dtype=torch.float32, device=device),
        rotation=torch.as_tensor(rng.normal(size=(4096, 4)), dtype=torch.float32, device=device),
        opacity=model.opacity + 2.0)
    step = tbg.make_train_step(cam.width, cam.height, raster_cfg, 0.2, 0.01, 2.0)
    lrs = dict(xyz=1e-3, color=2.5e-3, scaling=5e-3, rotation=1e-3, opacity=5e-2)
    fovs = torch.tensor([cam.tan_fovx, cam.tan_fovy], device=device)
    model, opt, loss, l1 = step(model, adam_init(tbg._trainable(model)),
                                torch.as_tensor(cam.world_view, device=device),
                                torch.as_tensor(cam.full_proj, device=device), fovs,
                                gt.to(device), torch.zeros(3, device=device), lrs)
    return model, opt, loss, l1


@pytest.mark.parametrize("tile", [(16, 16), (12, 12)])
def test_stage1_step_on_the_card_matches_the_cpu(cuda_device, tile):
    cam, gt, points = _scene()
    rc = RasterizerConfig(tile_x=tile[0], tile_y=tile[1], dup_x=8, dup_y=8, tile_capacity=512)
    tc.reset_launches()
    m_d, opt_d, loss_d, l1_d = _one_step(cuda_device, cam, gt, points, rc)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == {"composite_fwd": 1, "composite_bwd": 1, "combine_rows": 1}
    m_c, opt_c, loss_c, l1_c = _one_step(torch.device("cpu"), cam, gt, points, rc)
    torch.testing.assert_close(loss_d.cpu(), loss_c, rtol=1e-5, atol=0)
    torch.testing.assert_close(l1_d.cpu(), l1_c, rtol=1e-5, atol=0)
    for name in tbg.TRAINABLE:
        g_d, g_c = opt_d.mu[name].cpu(), opt_c.mu[name]
        scale = g_c.abs().max().item()
        assert scale > 0, name
        assert (g_d - g_c).abs().max().item() <= 1e-4 * scale, name
    acc_d, acc_c = m_d.xyz_gradient_accum.cpu(), m_c.xyz_gradient_accum
    assert (acc_d - acc_c).abs().max().item() <= 1e-4 * acc_c.abs().max().item()
    assert torch.equal(m_d.denom.cpu(), m_c.denom) and torch.equal(m_d.max_radii2d.cpu(),
                                                                   m_c.max_radii2d)


def _densify_state(cap, n_alive, seed):
    """Random fields as a densify meets them: scales below and above the
    clone/split limit, opacities around min_opacity, big screen radii, and
    mean gradients with ties among the candidates (and zero denominators)."""
    rng = np.random.default_rng(seed)
    alive = np.zeros(cap, bool)
    alive[rng.choice(cap, n_alive, replace=False)] = True
    grads = rng.choice([1e-4, 3e-4, 5e-4, 5e-4, 8e-4], cap).astype(np.float32)
    denom = rng.integers(0, 4, cap).astype(np.float32)
    f = {"xyz": rng.uniform(-1, 1, (cap, 3)), "color": rng.uniform(0, 1, (cap, 3)),
         "scaling": rng.uniform(-6.0, -2.0, (cap, 3)), "rotation": rng.normal(size=(cap, 4)),
         "opacity": rng.normal(-3.0, 2.0, (cap, 1)), "alive": alive,
         "max_radii2d": rng.uniform(0, 30, cap), "xyz_gradient_accum": grads * denom,
         "denom": denom}
    f = {k: v if v.dtype == bool else v.astype(np.float32) for k, v in f.items()}
    mu = {k: rng.normal(size=f[k].shape).astype(np.float32) for k in tbg.TRAINABLE}
    nu = {k: rng.uniform(0, 1, f[k].shape).astype(np.float32) for k in tbg.TRAINABLE}
    noise = rng.normal(size=(2, min(tback.MAX_NEW, cap), 3)).astype(np.float32)
    return f, mu, nu, noise


@pytest.mark.parametrize("cap,n_alive", [
    (120_000, 100_000),   # stage 1's capacity: every candidate finds a dead slot
    (4096, 4000),         # more candidates than dead slots: the rest are dropped
])
def test_densify_and_prune_on_the_card_matches_the_cpu(cuda_device, cap, n_alive):
    f, mu, nu, noise = _densify_state(cap, n_alive, seed=cap)

    def run(device):
        def on(d):
            return {k: torch.as_tensor(v, device=device) for k, v in d.items()}
        return tback.densify_and_prune(tback.BackgroundModel(**on(f)), on(mu), on(nu),
                                       torch.as_tensor(noise, device=device),
                                       2e-4, 0.005, 3.0, 20.0, 0.01)

    got, mu_d, nu_d, st_d = run(cuda_device)
    torch.cuda.synchronize()
    ref, mu_c, nu_c, st_c = run(torch.device("cpu"))
    assert {k: int(v) for k, v in st_d.items()} == {k: int(v) for k, v in st_c.items()}
    assert int(st_c["cloned"]) > 0 and int(st_c["split"]) > 0 and int(st_c["pruned"]) > 0
    assert (int(st_c["dropped"]) > 0) == (cap == 4096)
    assert torch.equal(got.alive.cpu(), ref.alive)
    for name in ("xyz", "scaling"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(ref, name), rtol=1e-6,
                                   atol=1e-6, msg=name)
    for name in ("color", "rotation", "opacity", "max_radii2d", "xyz_gradient_accum", "denom"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name)), name
    for k in tbg.TRAINABLE:
        assert torch.equal(mu_d[k].cpu(), mu_c[k]) and torch.equal(nu_d[k].cpu(), nu_c[k]), k


def test_densify_noise_from_a_card_generator(cuda_device):
    """The noise stage 1 draws on the card: the shape densify takes, finite,
    and the same draws again from a generator seeded alike."""
    draws = [tback.densify_noise(torch.Generator(cuda_device).manual_seed(3), tback.MAX_NEW,
                                 cuda_device) for _ in range(2)]
    assert draws[0].shape == (2, tback.MAX_NEW, 3) and draws[0].device.type == "cuda"
    assert bool(torch.isfinite(draws[0]).all()) and torch.equal(draws[0], draws[1])
