"""Launch shape of the port's phase-1 stab kernels (kernels 1 and 2):
``kernels/interval_stab.py::launch_shape`` sizes the lane groups and the
grid that ``csrc/interval_stab.cu`` takes, so its rules are checked here
on the CPU. The kernels themselves are held against their plain versions
on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

from repro_torch.kernels.interval_stab import (MAX_GRID, launch_shape,
                                               vector_width)

MAX_BATCH = 16_384       # IndexSpec.max_batch: the serving path's call


@pytest.mark.parametrize("w", range(4))
@pytest.mark.parametrize("k", range(1, 33))
@pytest.mark.parametrize("q", [1, 255, MAX_BATCH, 2**20 + 3])
def test_launch_shape_covers_every_query_once(q, k, w):
    threads, lanes, blocks = launch_shape(q, k, w)
    assert 32 <= threads <= 1024 and threads % 32 == 0
    assert 32 % lanes == 0                 # a group never straddles a warp
    assert 1 <= blocks <= MAX_GRID
    # a lane for each vector piece of the slots and each seed word, up to 32
    assert lanes >= min(32, max(k // vector_width(k), w))
    assert lanes == 1 or lanes < 2 * max(k // vector_width(k), w)
    # thread tid serves query tid // lanes as lane tid % lanes; lane 0
    # writes the verdict: every query exactly once, no block left idle
    writers = np.arange(0, blocks * threads, lanes, dtype=np.int64) // lanes
    writers = writers[writers < q]
    np.testing.assert_array_equal(writers, np.arange(q))
    assert (blocks - 1) * threads < q * lanes


@pytest.mark.parametrize("k", range(1, 33))
def test_vector_width_keeps_every_load_aligned(k):
    v = vector_width(k)
    assert v in (1, 2, 4) and k % v == 0
    assert v == 4 or k % (2 * v)           # the widest that divides K
    # kernel 1's slab row is 2K int32 with the ends at K: 4V-byte aligned
    # for every row s; kernel 2's rows of K the same
    for s in range(8):
        assert (s * 2 * k * 4) % (4 * v) == 0
        assert (s * 2 * k * 4 + k * 4) % (4 * v) == 0
        assert (s * k * 4) % (4 * v) == 0


@pytest.mark.parametrize("sms", [132, 114])     # H100 SXM, H100 PCIe
@pytest.mark.parametrize("k,w", [(2, 0), (8, 0), (1, 2), (8, 2)])
def test_launch_shape_spreads_the_serving_call_over_every_sm(k, w, sms):
    threads, lanes, blocks = launch_shape(MAX_BATCH, k, w, sms)
    assert blocks >= sms


@pytest.mark.parametrize("args", [(-1, 8, 0), (16, -1, 0), (16, 8, -1),
                                  (2**40, 32, 0)])
def test_launch_shape_refuses_what_the_kernels_cannot_take(args):
    with pytest.raises(ValueError):
        launch_shape(*args)
