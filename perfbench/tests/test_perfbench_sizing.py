"""A learn cell fits its card: the forest states that the timed window
holds at once, and the pool, stay under 90 % of the H100's 80 GB, the
rest left to the reference's judging after the window.  Worked out on
the CPU from the configuration's and the traffic's sizes, before any
chip time is spent."""
import json

import torch

import pytest

from conftest import LEARN, T64_CELL

LIMIT = 0.9 * 80e9
# window_checks draws its offsets from the seed; over these the most
# steps any seed keeps comes up
SEEDS = [*range(32), 2 ** 31 + 17, 3_000_000_019]


def _nbytes(x):
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return x.nbytes if isinstance(x, torch.Tensor) else 0


def state_bytes(cfg):
    """One forest state's bytes at the configuration's sizes.  Every
    array but the generator's carries the tree axis, so the state built
    on the CPU with one tree and with two gives it for ``n_trees``."""
    from harness import port

    def built(T):
        mask = torch.zeros((T, cfg["n_features"]), dtype=torch.bool)
        return _nbytes(port.init(port.forest_config(dict(cfg, n_trees=T)), 0, mask, "cpu"))
    one, two = built(1), built(2)
    return one + (cfg["n_trees"] - 1) * (two - one)


def pool_bytes(cfg, traffic):
    """The learn pool's bytes, drawn on the CPU with one batch and with
    two and extended to ``pool_batches``."""
    from harness import streams
    one, two = (_nbytes(streams.learn_pool(cfg, traffic, 0, "cpu", n_batches=n))
                for n in (1, 2))
    return one + (traffic["pool_batches"] - 1) * (two - one)


def held_states(traffic):
    """Forest states alive at once in the untraced window: the live one,
    the start copy, the copies before and after each kept step (as many
    as any seed keeps), and a swap's fresh forest and its ``torch.where``
    result."""
    from harness import learn
    kept = max(len(learn.window_checks(traffic, s)) for s in SEEDS)
    return 2 * kept + 2 + 2


def cell_bytes(cfg, traffic):
    return held_states(traffic) * state_bytes(cfg) + pool_bytes(cfg, traffic)


@pytest.mark.parametrize("workload", LEARN)
def test_learn_cell_fits_its_card(workload):
    from harness import spec
    c = spec.load(workload)
    assert cell_bytes(c.config, c.traffic) < LIMIT


def test_t64_cell_fits_only_with_fewer_kept_steps(grown):
    """64 trees of 4,095 nodes: 4.3 GB a state.  Under friedman_gra's
    6 + 4 kept steps the window would hold 24 states; under
    friedman_gra_4checks' 2 + 2 it holds 12."""
    from harness import spec
    c = spec.load(T64_CELL, grown)
    cfg = c.config
    assert state_bytes(cfg) >= cfg["n_trees"] * cfg["max_nodes"] * cfg["n_features"] \
        * cfg["n_bins"] * 16
    gra = json.loads((grown / "perfbench" / "traffic" / "friedman_gra.json").read_text())
    assert (held_states(gra), held_states(c.traffic)) == (24, 12)
    assert cell_bytes(cfg, c.traffic) < LIMIT < cell_bytes(cfg, gra)
