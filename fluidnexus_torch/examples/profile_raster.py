"""Profile the rasterizer at the bench workload on the card (counterpart of
the repository's ``examples/profile_raster.py``): 32 768 Gaussians at
960 x 544, 32 x 32 tiles of 384 slots, dup 3 x 3, forward and backward.

Times 20 steps with CUDA events (mean step and frames a second), then traces
20 more with ``torch.profiler`` into ``<outdir>/trace.json`` (a Chrome trace)
and prints the device kernels by time a step. Needs the card. Usage:

  python -m fluidnexus_torch.examples.profile_raster [outdir]
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from fluidnexus_torch import resolve_device
from fluidnexus_torch.data.cameras import Camera
from fluidnexus_torch.ops.rasterizer import RasterizerConfig, rasterize

STEPS = 20
N_GAUSSIANS = 32768
WIDTH, HEIGHT = 960, 544


def workload(device):
    """(the step: the five gradients of |render - 0|.mean(), its inputs)."""
    rng = np.random.default_rng(0)
    n = N_GAUSSIANS
    R = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1.0]])
    cam = Camera(uid=0, R=R, T=-R.T @ np.array([0.0, 0.0, 3.0]), fovx=0.9, fovy=0.6,
                 width=WIDTH, height=HEIGHT)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    inputs = [t(rng.uniform(-1.2, 1.2, (n, 3))), t(rng.uniform(0, 1, (n, 3))),
              t(rng.uniform(0.05, 0.9, (n,))), t(np.exp(rng.uniform(-5.0, -3.2, (n, 3)))),
              t(rng.normal(size=(n, 4)))]
    target = torch.zeros((3, HEIGHT, WIDTH), device=device)
    rkw = dict(view_matrix=t(cam.world_view), proj_matrix=t(cam.full_proj),
               tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=WIDTH, height=HEIGHT,
               bg_color=torch.zeros(3, device=device),
               config=RasterizerConfig(tile_x=32, tile_y=32, tile_capacity=384, chunk=32,
                                       dup_x=3, dup_y=3))

    def step():
        ps = [x.detach().requires_grad_(True) for x in inputs]
        loss = (rasterize(*ps, **rkw).color - target).abs().mean()
        return torch.autograd.grad(loss, ps)

    return step, inputs


def kernel_table(prof, steps, top=30):
    """[(device ms a step, kernel name)] of the traced kernels, largest
    first; the ``fnx.*`` spans' ranges on the device timeline are left out."""
    totals = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("fnx."):
            totals[e.name] = totals.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return sorted(((us / 1e3 / steps, name) for name, us in totals.items()), reverse=True)[:top]


def main(argv=None):
    """Times and traces the step; returns (mean ms a step, the kernel table)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    out = argv[0] if argv else os.path.join(tempfile.gettempdir(), "raster_profile")
    dev = resolve_device("cuda")
    step, _ = workload(dev)
    step()
    torch.cuda.synchronize(dev)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS):
        step()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / STEPS
    print(f"mean step {ms:.3f} ms = {1e3 / ms:.1f} fps ({torch.cuda.get_device_name(dev)}, "
          f"CUDA events over {STEPS} steps)")

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize(dev)
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    table = kernel_table(prof, STEPS)
    print(f"trace -> {path}; device kernels by time a step (profiler, {STEPS} steps):")
    for k_ms, name in table:
        print(f"  {k_ms:8.3f} ms/step  {name[:110]}")
    return ms, table


if __name__ == "__main__":
    main()
