"""One jigsaw train step against ``vince_tpu.solvers.vince_step`` on a 1x1
mesh, both sides (the solver's warm-up step): two permutations a step, the
key's drawn first. ResNet18, one source of 4 videos x 2 frames at 33x33
(11-px patches), queue 64, embeddings 32, float32 on the CPU, with the
runner and the checks of ``test_torch_port_step_heads.py`` (imported with
its tests, which take this file's ``runs``)."""

import pytest

from tests.test_torch_port_step_heads import (  # noqa: F401
    JIGSAW, JIGSAW_SOURCES, test_step_metrics, test_step_momentum_buffers,
    test_step_queue_and_k1_calls, test_step_weights_and_batch_stats, variant_runs)
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)


@pytest.fixture(scope="module")
def runs():
    return variant_runs(JIGSAW_SOURCES, JIGSAW, "both", 1, 2, set(), 1)
