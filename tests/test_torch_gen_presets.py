"""The port's generation presets (fluidnexus_torch/core/gen_presets.py)
against the JAX package's: every shipped preset loads equal, and each
refinement CLI of each package, given the preset, parses the same values
(the two-pass parse: the preset's values become defaults, explicit flags
win)."""
import argparse
import os

import pytest

from fluidnexus_torch.core import gen_presets as tgp
from fluidnexus_torch.pipelines import gen_future_video as tfut
from fluidnexus_torch.pipelines import gen_refine_video as tref
from fluidnexus_tpu.core import gen_presets as jgp
from fluidnexus_tpu.pipelines import gen_future_video as jfut
from fluidnexus_tpu.pipelines import gen_refine_video as jref
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

PRESETS = ("refine_smoke", "refine_ball", "refine_scalar", "future_smoke", "future_ball",
           "future_scalar", "wind_smoke")
REQUIRED = {"refine": ["--input_folder", "in", "--gt_prefix_folder", "gt", "--out_folder", "out"],
            "future": ["--sim_render_folder", "r", "--recon_frames_folder", "c", "--out_root", "o"]}
JAX_ONLY = set()   # every JAX flag, --tp/--dp included, is the port's too


class Parsed(Exception):
    pass


def parsed_args(main, argv, monkeypatch):
    """The namespace ``main(argv)`` parses, taken at its final
    ``parse_args`` (the run itself is stopped there)."""
    real = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise Parsed(real(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(Parsed) as e:
            main(argv)
    return vars(e.value.args[0])


def test_shipped_presets_are_the_seven():
    shipped = sorted(f[4:-5] for f in os.listdir(tgp._CONFIG_DIR)
                     if f.startswith("gen_") and f.endswith(".json"))
    assert shipped == sorted(PRESETS)
    assert tgp._CONFIG_DIR == jgp._CONFIG_DIR and tgp._INFO_KEYS == jgp._INFO_KEYS


@pytest.mark.parametrize("name", PRESETS)
def test_preset_loads_and_parses_as_in_jax(name, monkeypatch):
    preset = tgp.load_gen_preset(name)
    assert preset == jgp.load_gen_preset(name)
    assert tgp.load_gen_preset(os.path.join(tgp._CONFIG_DIR, f"gen_{name}.json")) == preset
    for kind, (tmain, jmain) in (("refine", (tref.main, jref.main)),
                                 ("future", (tfut.main, jfut.main))):
        argv = REQUIRED[kind] + ["--preset", name]
        got = parsed_args(tmain, argv, monkeypatch)
        want = parsed_args(jmain, argv, monkeypatch)
        assert set(want) - set(got) == JAX_ONLY and set(got) <= set(want), kind
        assert got == {k: v for k, v in want.items() if k not in JAX_ONLY}, kind
        # every preset key that is a flag of the CLI became its default
        for k, v in preset.items():
            if k in got and k not in tgp._INFO_KEYS:
                assert got[k] == v, (kind, k)
        # an explicit flag wins over the preset
        over = parsed_args(tmain, argv + ["--strength", "0.3", "--frame_step", "3"], monkeypatch)
        assert (over["strength"], over["frame_step"]) == (0.3, 3)


def test_apply_preset_defaults_skips_info_keys_and_unknown_flags():
    preset = tgp.load_gen_preset("refine_smoke")
    for mod in (tgp, jgp):
        ap = argparse.ArgumentParser()
        ap.add_argument("--strength", type=float, default=0.1)
        ap.add_argument("--task", default="none")          # an info key, left alone
        ap.add_argument("--window_start_indices", type=int, nargs="*", default=None)
        assert mod.apply_preset_defaults(ap, preset) is preset
        args = ap.parse_args([])
        assert (args.strength, args.task, args.window_start_indices) == (0.5, "none",
                                                                         [55, 167, 279])


def test_unknown_preset_names_the_shipped_ones(tmp_path):
    with pytest.raises(FileNotFoundError) as got:
        tgp.load_gen_preset("no_such")
    with pytest.raises(FileNotFoundError) as want:
        jgp.load_gen_preset("no_such")
    assert str(got.value) == str(want.value)
    assert "refine_smoke" in str(got.value) and "wind_smoke" in str(got.value)
    bad = tmp_path / "bad.json"
    bad.write_text('{"window_frames": 65, "sampling_latent_frames": 16}')
    with pytest.raises(AssertionError):
        tgp.load_gen_preset(str(bad))
