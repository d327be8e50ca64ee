"""The card's tile limits (``fluidnexus_torch.ops.rasterizer_cuda.check_tile``)
and the stage entries that apply them before any work. These run on the CPU:
the check needs no card, and a stage that refuses its tile raises before it
touches the card, the scene or the config's other fields."""
import pytest

from fluidnexus_torch.core.config import Config
from fluidnexus_torch.ops import rasterizer_cuda as tc
from fluidnexus_torch.pipelines import future_simulation as fs
from fluidnexus_torch.pipelines import train_physical_particle as tp

# (tile_x, tile_y), and whether the stage trains (needs the backward too)
UNSUPPORTED = [((8, 4), True),      # 32 pixels: the forward's, not the backward's
               ((24, 4), True),     # 96: likewise
               ((4, 4), False),     # 16: no multiple of 32
               ((12, 12), False),   # 144
               ((48, 32), False),   # 1 536: over 1 024
               ((64, 32), True),    # 2 048
               ((0, 16), False)]
SUPPORTED = [((16, 16), True), ((32, 32), True), ((8, 8), True), ((64, 16), True),
             ((24, 8), True), ((8, 4), False), ((24, 4), False), ((32, 32), False),
             ((16, 6), False)]


@pytest.mark.parametrize("tile,backward", UNSUPPORTED)
def test_check_tile_refuses_what_the_card_does_not_take(tile, backward):
    with pytest.raises(ValueError, match=f"got {tile[0]} x {tile[1]}"):
        tc.check_tile(*tile, "cuda", backward=backward)


@pytest.mark.parametrize("tile,backward", SUPPORTED)
def test_check_tile_accepts_what_the_card_takes(tile, backward):
    tc.check_tile(*tile, "cuda", backward=backward)
    tc.check_tile(*tile, "cuda:0", backward=backward)


@pytest.mark.parametrize("tile,backward", UNSUPPORTED)
def test_the_cpu_takes_every_tile(tile, backward):
    tc.check_tile(*tile, "cpu", backward=backward)


def test_the_limits_are_the_kernels():
    """The forward's range holds the backward's, and a training tile takes
    both."""
    assert tc.FWD_STEP == 32 and tc.MAX_FWD_P == 1024
    assert tc.BWD_STEP == 32 * tc.BWD_PPT == 64 and tc.MAX_BWD_P == 1024
    assert tc.BWD_STEP % tc.FWD_STEP == 0 and tc.MAX_BWD_P <= tc.MAX_FWD_P


class Touched(Exception):
    pass


class Untouchable:
    """A scene that raises on any use: a stage that refuses its tile first
    never reads it."""

    def __getattr__(self, name):
        raise Touched(name)


def _cfg(tile):
    cfg = Config()
    cfg.pipe.tile_x, cfg.pipe.tile_y = tile
    return cfg


@pytest.mark.parametrize("tile", [(8, 4), (12, 12), (64, 32)])
@pytest.mark.parametrize("entry", ["train", "fit_first_frame"])
def test_training_stages_refuse_before_any_work(entry, tile):
    with pytest.raises(ValueError, match=f"got {tile[0]} x {tile[1]}"):
        getattr(tp, entry)(_cfg(tile), Untouchable(), device="cuda")


@pytest.mark.parametrize("tile", [(12, 12), (48, 32)])
def test_predict_refuses_before_any_work(tile):
    with pytest.raises(ValueError, match=f"got {tile[0]} x {tile[1]}"):
        fs.predict(_cfg(tile), Untouchable(), device="cuda")


@pytest.mark.parametrize("entry", [fs.predict, tp.train])
def test_a_taken_tile_goes_on_to_the_work(entry):
    """``predict`` renders only, so it takes 8 x 4 tiles (the forward's);
    ``train`` takes 16 x 16. Past the check the stage goes on: here it stops
    at the first use of the card (none on this machine) or of the scene."""
    tile = (8, 4) if entry is fs.predict else (16, 16)
    with pytest.raises((RuntimeError, Touched)):
        entry(_cfg(tile), Untouchable(), device="cuda")
