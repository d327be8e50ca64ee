"""Stage runner (counterpart of ``fluidnexus_tpu/__main__.py``):
``python -m fluidnexus_torch <stage> [args...]`` for the stages the port has.
Each stage's ``main`` runs on the card (``device="cuda"``); ``convert`` (the
DataProcessing format conversions) runs on the host."""
from __future__ import annotations

import importlib
import sys

STAGES = {
    "train_background": "fluidnexus_torch.pipelines.train_background",
    "train_physical_particle": "fluidnexus_torch.pipelines.train_physical_particle",
    "train_visual_particle": "fluidnexus_torch.pipelines.train_visual_particle",
    "future_simulation": "fluidnexus_torch.pipelines.future_simulation",
    "train_video": "fluidnexus_torch.pipelines.train_video",
    "sample_video": "fluidnexus_torch.pipelines.sample_video",
    "gen_refine_video": "fluidnexus_torch.pipelines.gen_refine_video",
    "gen_future_video": "fluidnexus_torch.pipelines.gen_future_video",
    "train_novel_view": "fluidnexus_torch.pipelines.train_novel_view",
    "infer_novel_view": "fluidnexus_torch.pipelines.infer_novel_view",
    "convert": "fluidnexus_torch.data.conversions",
    "port": "fluidnexus_torch.pipelines.port_drill",
    "evaluate_adm": "fluidnexus_torch.utils.adm_metrics",
}


def usage() -> str:
    return "usage: python -m fluidnexus_torch <stage> [args...]\nstages:\n" + "".join(
        f"  {s}\n" for s in STAGES)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in STAGES:
        print(usage(), end="")
        sys.exit(0 if argv and argv[0] in ("-h", "--help") else 1)
    importlib.import_module(STAGES[argv[0]]).main(argv[1:])


if __name__ == "__main__":
    main()
