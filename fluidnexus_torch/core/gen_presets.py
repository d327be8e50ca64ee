"""Shipped generation presets: the reference's configs_gen/*.yaml pins
(counterpart of ``fluidnexus_tpu/core/gen_presets.py``).

The reference fixes every per-task sampling hyperparameter (SDEdit strength,
per-window source start indices, frame step, window length) in seven YAMLs
under CogVideoX/configs_gen/. The same numbers ship as configs/gen_*.json at
the repository root, and the refinement CLIs take them through --preset
(explicit CLI flags still win over preset values).

Name -> reference file:
  refine_smoke  -> sdedit_refine_pi2v_long_fluid_nexus_smoke.yaml
  refine_ball   -> sdedit_refine_pi2v_long_fluid_nexus_ball.yaml
  refine_scalar -> sdedit_refine_pi2v_long_scalar_real.yaml
  future_smoke  -> sdedit_future_pi2v_fluid_nexus_smoke.yaml
  future_ball   -> sdedit_future_pi2v_fluid_nexus_ball.yaml
  future_scalar -> sdedit_future_pi2v_scalar_real.yaml
  wind_smoke    -> sdedit_wind_pi2v_fluid_nexus_smoke.yaml
"""
from __future__ import annotations

import json
import os

_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs")

# keys that are reference-workflow context (data prep, output naming,
# checkpoint selection), not flags of the refinement CLIs
_INFO_KEYS = {
    "task", "dataset", "reference", "sampling_latent_frames",
    "zero123_finetune_step", "view_idx", "tgt_view_idx",
    "label_start_indices", "label_start_idx", "prefix_refined_strength",
    "prefix_start_fake", "prefix_start",
}


def load_gen_preset(name_or_path: str) -> dict:
    """A preset by bare name (``refine_smoke``) or JSON path. An unknown
    name raises FileNotFoundError listing the shipped presets."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_CONFIG_DIR, f"gen_{name_or_path}.json")
    if not os.path.exists(path):
        avail = sorted(f[4:-5] for f in os.listdir(_CONFIG_DIR)
                       if f.startswith("gen_") and f.endswith(".json"))
        raise FileNotFoundError(f"gen preset {name_or_path!r} not found (shipped: {avail})")
    with open(path) as f:
        preset = json.load(f)
    # the window length must map onto the causal VAE's 4k+1 latent grid and
    # agree with the reference's sampling_num_frames pin
    wf, lat = preset.get("window_frames"), preset.get("sampling_latent_frames")
    if wf is not None and lat is not None:
        assert (wf - 1) // 4 + 1 == lat, (wf, lat)
    return preset


def apply_preset_defaults(ap, preset: dict):
    """Install the preset's values as argparse defaults of the flags the
    parser defines: explicit CLI flags override them; the reference-context
    keys (``_INFO_KEYS``) and keys of no flag are left out. Returns the
    preset."""
    known = {a.dest for a in ap._actions}
    ap.set_defaults(**{k: v for k, v in preset.items() if k in known and k not in _INFO_KEYS})
    return preset
