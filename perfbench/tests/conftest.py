"""Put the benchmark's packages and the program on the path, and give the
tests a small cell: the published widths stay, the scale is cut (T = 2,
M = 63, C = 16, B = 256) so that the port's plain CPU path runs it."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "perfbench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SMALL = dict(n_trees=2, max_nodes=63, max_depth=5, n_bins=16, batch_rows=256)
LEARN = ("arf_qo_t10_m1023_f16_c64.friedman_gra",
         "arf_sketch_t10_m1023_f16_k16.friedman_gra_cauchy",
         "arf_qo_t10_m1023_f16_c64.friedman_stable")
SERVE = "arf_qo_t10_m1023_f16_c64.serve_loguniform"


def small_cell(workload):
    from harness import spec
    c = spec.load(workload)
    c.config.update(SMALL)
    t = c.traffic
    if t["kind"] == "learn":
        t.update(pool_batches=40, warm_batches=min(t["warm_batches"], 10),
                 check_every=4, max_checks=2, carry_steps=14, change_checks=1)
    else:
        t.update(pool_batches=10, warm_batches=10, carry_steps=10, request_rows_max=512,
                 sizes=64, pool_rows=4096, check_every=8)
    return c


def run_small(workload, seed=2 ** 31 + 17, seconds=0.5, control=None):
    """The cell's result dict, run on the CPU at the small size."""
    import run as bench
    return bench.run_cell(small_cell(workload), seed, seconds, False, "cpu",
                          time.time(), bench.limits_of(workload))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return "cuda"
