"""End-to-end demo on the card: a differentiable 3DGS fit, then a PBF
rollout (counterpart of the repository's ``examples/fit_gaussians_demo.py``).

Drives the port through its public API only:
  1. renders a target image from a "ground-truth" Gaussian scene,
  2. recovers perturbed Gaussian positions and colours by gradient descent
     through the tile rasterizer (the core loop of ``train_background``),
  3. runs emit -> guess -> solve -> confirm -> advect (the core loop of
     ``train_physical_particle``'s phases B and C).

Prints the PSNR trajectory and the solver's diagnostics. Usage:
  python -m fluidnexus_torch.examples.fit_gaussians_demo
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.ops.rasterizer import RasterizerConfig, rasterize
from fluidnexus_torch.sim.pbf import (
    PBFParams, confirm_guess, guess_hidden, solver_loop, update_visual,
)
from fluidnexus_torch.sim.state import make_particle_state, make_visual_state
from fluidnexus_torch.utils.losses import psnr, ssim

FIT_ITERS = 201
TICKS = 5
# the reference's smoke regime (configs/fluid_nexus_smoke_dynamics.json): H 2.0
# in scaled (x100) space, particle spacing 0.9, p0 1.5, k 3, secs 0.033
DEMO_PBF = PBFParams(h=2.0, p0=1.5, k=3.0, secs=0.033, alpha=0.0, knn_k=64)


def pbf_inputs():
    """The rollout's start: an 8^3 lattice of spacing 0.9 rising at 100, and
    a visual particle at every fourth lattice point, offset by half a
    spacing. (hidden points (512, 3) float32, visual points (128, 3))."""
    grid = np.stack(np.meshgrid(*[np.arange(8) * 0.9] * 3, indexing="ij"), -1).reshape(-1, 3)
    return grid.astype(np.float32), (grid[::4] + 0.45).astype(np.float32)


def fit(device, iters=FIT_ITERS):
    """The Gaussian fit at 128 x 96: Adam (lr 2e-3, eps 1e-8) on the means
    and colours of 256 perturbed Gaussians against the render of the true
    ones, loss 0.8 L1 + 0.2 (1 - SSIM). Returns the PSNRs printed."""
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
    cam = Camera(uid=0, R=R, T=-R.T @ np.array([0.0, 0.0, 3.0]), fovx=0.8, fovy=0.6,
                 width=128, height=96)
    rng = np.random.default_rng(0)
    n = 256

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    gt = dict(means=t(rng.uniform(-0.7, 0.7, (n, 3))), cols=t(rng.uniform(0, 1, (n, 3))),
              ops=t(rng.uniform(0.4, 0.9, (n,))),
              scales=t(np.exp(rng.uniform(-3.2, -2.2, (n, 3)))), rots=t(rng.normal(size=(n, 4))))
    rkw = dict(view_matrix=t(cam.world_view), proj_matrix=t(cam.full_proj),
               tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=cam.width,
               height=cam.height, bg_color=torch.zeros(3, device=device),
               config=RasterizerConfig(tile_capacity=128, chunk=32))

    def render(means, cols):
        return rasterize(means, cols, gt["ops"], gt["scales"], gt["rots"], **rkw).color

    with torch.no_grad():
        target = render(gt["means"], gt["cols"])
    means = (gt["means"] + 0.03 * t(rng.normal(size=(n, 3)))).requires_grad_(True)
    cols = torch.clamp(gt["cols"] + 0.2 * t(rng.normal(size=(n, 3))), 0, 1).requires_grad_(True)
    opt = torch.optim.Adam([means, cols], lr=2e-3, eps=1e-8)

    t0 = time.time()
    with torch.no_grad():
        p0 = float(psnr(render(means, cols), target))
    print(f"initial PSNR {p0:.2f} dB")
    psnrs = [p0]
    img = None
    for i in range(iters):
        img = render(means, cols)
        loss = 0.8 * (img - target).abs().mean() + 0.2 * (1 - ssim(img, target))
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i % 50 == 0:
            psnrs.append(float(psnr(img.detach(), target)))
            print(f"iter {i:4d} loss {float(loss.detach()):.5f} PSNR {psnrs[-1]:.2f} dB")
    final = float(psnr(img.detach(), target)) if img is not None else p0
    print(f"fit wall time {time.time() - t0:.1f}s; final PSNR {final:.2f} dB")
    return psnrs + [final]


def rollout(device, ticks=TICKS):
    """``ticks`` of guess -> ``solver_loop`` (10 Jacobi iterations) -> confirm
    -> ``update_visual`` at ``DEMO_PBF``. Returns (hidden state, visual
    state, each tick's printed numbers)."""
    hidden, vis_pts = pbf_inputs()
    st = make_particle_state(1024, hidden, init_velocity_y=100.0, device=device)
    vis = make_visual_state(256, vis_pts, device=device)
    rows = []
    for tick in range(ticks):
        st = guess_hidden(st, DEMO_PBF)
        st, diags = solver_loop(st, DEMO_PBF, iterations=10)
        st = confirm_guess(st, DEMO_PBF)
        vis = update_visual(vis, st, DEMO_PBF)
        row = dict(p_ratio=float(diags["p_ratio"][-1]), mean_v=float(st.velocity.abs().mean()),
                   alive=int(st.num_alive), vis_y=float(vis.xyz[vis.alive].mean(0)[1]))
        rows.append(row)
        print(f"tick {tick}: rho/rho0 {row['p_ratio']:.3f} mean|v| {row['mean_v']:.3f} "
              f"alive {row['alive']} vis_y_mean {row['vis_y']:.3f}")
    return st, vis, rows


def main(device="cuda", fit_iters=FIT_ITERS, ticks=TICKS):
    """The demo on ``device``; returns a dict of the fit's PSNRs
    (``psnrs``), the rollout's per-tick numbers (``ticks``) and its last
    hidden and visual states (``hidden``, ``visual``)."""
    dev = resolve_device(device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    psnrs = fit(dev, fit_iters)
    st, vis, rows = rollout(dev, ticks)
    print("demo OK")
    return dict(psnrs=psnrs, ticks=rows, hidden=st, visual=vis)


if __name__ == "__main__":
    main()
