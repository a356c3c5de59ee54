"""A cell cut to a size the CPU runs in seconds, for the tests: one residual
block a stage, 4 classes, 64 x 64 input, batches of 2 small scenes.  The
random network's rounding
errors do not shrink with its size, so a toy run is judged against the
cell's limits widened to twice what a sound toy run of the same seed reads
where that is more: a fault has to stand out of that.  Nothing here is a
device number."""

import torch

from portbench import core

SEED = 2 ** 33 + 5


class Args:
    seed = SEED
    seconds = 2.0
    trace = 0


def manifest() -> dict:
    return core.load_json(core.ROOT / "BENCHMARK.json")


def cells(generator: str):
    m = manifest()
    return [w["name"] for w in m["workloads"]
            if core.load_json(core.BENCH_DIR / "traffic" / f"{w['traffic']}.json")["generator"]
            == generator]


def toy_cell(name: str) -> core.Cell:
    cell = core.Cell(name, manifest())
    cell.cfg = dict(cell.cfg, blocks=[1, 1, 1, 1, 1], classes=4, input_size=64)
    cell.mix = dict(cell.mix, batch=2, pool=6, sizes_wh=[[80, 60], [60, 80], [96, 64]],
                    calib_images=2, warmup_calls=1, sample_calls=2, trace_skip=1, trace_calls=2)
    return cell


def context(cell: core.Cell, seed: int = SEED, trace: int = 0, seconds: float = 2.0):
    from portbench import run

    args = Args()
    args.seed, args.trace, args.seconds = seed, trace, seconds
    return run.Context(cell, args, torch.device("cpu"))


def toy_limits(cell: core.Cell, sound: dict) -> dict:
    return {k: max(lim, 2 * sound["checks"][k]) for k, lim in cell.limits.items()}
