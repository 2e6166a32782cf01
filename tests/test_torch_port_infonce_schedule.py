"""The schedule of the streamed queue log-sum-exp kernel (K1:
``infonce_kernel._chunking``), held on the CPU to its contract: every tile of
the queue (64 keys) in exactly one chunk, no chunk
empty, every row of q in exactly one row block, about one CTA per SM, and
shared memory within what a block may use on the H100. The kernel itself is
held on the card by ``chip_smoke.py``, which compares its (m, S, W) with the
plain version at the step's and at ragged shapes, and holds ``_smem_bytes``
equal to the source's count (the C entry ``vince_queue_logsumexp_smem_bytes``)."""

import math

import numpy as np
import pytest

from vince_tpu_torch.ops.kernels import H100_SMS
from vince_tpu_torch.ops.kernels import infonce_kernel as k1
from torch_port_threads import one_intra_op_thread  # noqa: F401  (a module fixture)

SMEM_LIMIT = 232448  # bytes of shared memory a block can use on the H100


@pytest.mark.parametrize("d", [64, 72, 128, 256])
@pytest.mark.parametrize("k", [1, 65, 1000, 65536, 262144])
@pytest.mark.parametrize("b", [1, 37, 128, 200, 1024])
def test_chunking_covers_every_tile_and_row_once(b, k, d):
    row_blocks, nchunks, per_chunk = k1._chunking(b, k, d)
    tiles = math.ceil(k / k1._BLOCK_KEYS)
    count = np.zeros(tiles, np.int32)
    for c in range(nchunks):
        first, end = c * per_chunk, min(tiles, (c + 1) * per_chunk)
        assert end > first  # no empty chunk: the first tile of each holds a valid key
        count[first:end] += 1
    assert (count == 1).all()
    rows = k1._block_rows(d)
    assert row_blocks == math.ceil(b / rows) and (row_blocks - 1) * rows < b
    # about one CTA per SM: no more than the SMs unless one chunk per row block
    assert row_blocks * nchunks <= H100_SMS or nchunks == 1
    assert k1._smem_bytes(d) <= SMEM_LIMIT
