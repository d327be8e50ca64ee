"""The card's tile limits (``fluidnexus_torch.ops.rasterizer_cuda.check_tile``)
and the stage entries that apply them before any work. These run on the CPU:
the check needs no card. The card's kernels take every tile of at least one
pixel, as the JAX package renders it; only a side of 0 or less is refused,
and a stage that refuses its tile raises before it touches the card, the
scene or the config's other fields."""
import pytest

from fluidnexus_torch.core.config import Config
from fluidnexus_torch.ops import rasterizer_cuda as tc
from fluidnexus_torch.pipelines import future_simulation as fs
from fluidnexus_torch.pipelines import train_physical_particle as tp
from tests.torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

# (tile_x, tile_y)
UNSUPPORTED = [(0, 16), (16, 0), (16, -4), (-8, 8), (0, 0)]
# what the card's kernels took before chunks and ragged tiles, and what they
# take now: no multiple of 32 or 64, over 1 024 pixels, odd pixel counts
TAKEN_BEFORE = [(16, 16), (32, 32), (8, 8), (64, 16), (24, 8), (16, 6)]
TAKEN_NOW = [(8, 4), (24, 4), (4, 4), (12, 12), (48, 32), (64, 32), (5, 5), (1, 1), (3, 7),
             (1920, 1080)]
SUPPORTED = TAKEN_BEFORE + TAKEN_NOW


@pytest.mark.parametrize("tile", UNSUPPORTED)
def test_check_tile_refuses_what_the_card_does_not_take(tile):
    with pytest.raises(ValueError, match=f"got {tile[0]} x {tile[1]}"):
        tc.check_tile(*tile, "cuda")


@pytest.mark.parametrize("tile", SUPPORTED)
def test_check_tile_accepts_what_the_card_takes(tile):
    tc.check_tile(*tile, "cuda")
    tc.check_tile(*tile, "cuda:0")


@pytest.mark.parametrize("tile", UNSUPPORTED + TAKEN_NOW)
def test_the_cpu_takes_every_tile(tile):
    tc.check_tile(*tile, "cpu")


def test_the_limits_are_the_kernels():
    """A block takes at most BLOCK_P pixels, a thread two adjacent ones; a
    larger tile runs as chunks of BLOCK_P, the last one ragged."""
    assert tc.BLOCK_P == 1024 and tc.BWD_PPT == 2
    assert [tc.chunks(p) for p in (1, 25, 1024, 1025, 2048, 2049, 1920 * 1080)] == \
        [1, 1, 1, 2, 2, 3, 2025]


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


NO_CARD = "torch.cuda.is_available\\(\\) is False"


@pytest.mark.parametrize("tile", [(8, 4), (12, 12), (64, 32)])
@pytest.mark.parametrize("entry", ["train", "fit_first_frame"])
def test_training_stages_refuse_before_any_work(entry, tile):
    """What the training stages refuse before any work is a tile with no
    pixel (``test_a_tile_with_no_pixel_is_refused_before_any_work``), not
    these, which the card takes: the stage goes past its tile check to
    ``resolve_device``, which raises here, where there is no card (not the
    tile's ValueError)."""
    with pytest.raises(RuntimeError, match=NO_CARD):
        getattr(tp, entry)(_cfg(tile), Untouchable(), device="cuda")


@pytest.mark.parametrize("tile", [(12, 12), (48, 32)])
def test_predict_refuses_before_any_work(tile):
    """As ``test_training_stages_refuse_before_any_work``, for ``predict``."""
    with pytest.raises(RuntimeError, match=NO_CARD):
        fs.predict(_cfg(tile), Untouchable(), device="cuda")


@pytest.mark.parametrize("entry", [fs.predict, tp.train])
def test_a_taken_tile_goes_on_to_the_work(entry):
    """``predict`` renders only, ``train`` also runs the backward; both take
    8 x 4 and 16 x 16 tiles. Past the check the stage goes on: here it stops
    at the first use of the card (none on this machine) or of the scene."""
    tile = (8, 4) if entry is fs.predict else (16, 16)
    with pytest.raises((RuntimeError, Touched)):
        entry(_cfg(tile), Untouchable(), device="cuda")


@pytest.mark.parametrize("entry", [fs.predict, tp.train, tp.fit_first_frame])
def test_a_tile_with_no_pixel_is_refused_before_any_work(entry):
    with pytest.raises(ValueError, match="got 0 x 16"):
        entry(_cfg((0, 16)), Untouchable(), device="cuda")
