"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
checkout's root. They run on the CPU at small sizes; those marked `cuda` run
the cells at their own sizes on the card and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the cells cut to a size a CPU test holds (widths too: only the harness's
# plumbing and the checks' faults are under test here)
TINY_SERVE = {"image_hw": [24, 32],
              "serve": {"nerf": {"kwargs": {
                  "encoder_conf": {"kwargs": {"image_padding": 8}},
                  "mlp_fine_conf": {"kwargs": {"d_hidden": 32}}}},
                  "renderer": {"kwargs": {
                      "n_depth_candidates": 64, "n_prior_anchors": 16,
                      "eval_chunk_rays": 256, "n_samples": 8,
                      "n_gaussian": 3}}}}
TINY_TRAIN = {"train": {"data": {"downsample": 0.0625},
                        "nerf": {"kwargs": {
                            "encoder_conf": {"kwargs": {"image_padding": 8}},
                            "mlp_fine_conf": {"kwargs": {"d_hidden": 32}}}},
                        "renderer": {"kwargs": {"n_depth_candidates": 64,
                                                "n_samples": 8,
                                                "n_gaussian": 3}},
                        "optimizer": {"kwargs": {"vgg_spatch": 8}}}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where none is present")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def dtu_tree(tmp_path_factory):
    """The training mix's DTU tree, written once into a temporary cache."""
    from lib import scenes

    cache = tmp_path_factory.mktemp("bench_cache")
    old = scenes.CACHE
    scenes.CACHE = cache
    yield cache
    scenes.CACHE = old
