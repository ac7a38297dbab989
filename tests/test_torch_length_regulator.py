"""The port's length regulator (gather form) against the JAX package's
(selection-matrix form). Exact: every output frame copies one token."""

import numpy as np
import pytest
import torch
from torch_cpu import torch_one_thread  # noqa: F401 (an autouse fixture)

from forwardtacotron_torch.ops import length_regulator as lr


def test_round_durations_half_rounds_up_like_jax():
    from forwardtacotron_tpu.ops.length_regulator import round_durations

    d = np.array([[0.5, 1.5, 2.5, -0.5, -1.2, 2.4999, 3.5001, 0.0]],
                 np.float32)
    got = lr.round_durations(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(round_durations(d)))
    np.testing.assert_array_equal(got[0], [1, 2, 3, 0, 0, 2, 4, 0])
    # torch.round would give 0, 2, 2 for the first three ties
    assert torch.round(torch.from_numpy(d))[0, 0] == 0


@pytest.mark.parametrize('max_len', [8, 40])
def test_length_regulator_matches_jax(max_len):
    """max_len 8 crops the longer item; 40 pads both with zero frames."""
    from forwardtacotron_tpu.ops.length_regulator import (expanded_lengths,
                                                          length_regulator)

    rs = np.random.RandomState(max_len)
    x = rs.randn(2, 6, 3).astype(np.float32)
    dur = rs.uniform(-0.5, 4.0, (2, 6)).astype(np.float32)
    dur[1, 2] = 0.5                    # a tie that rounds up to one frame
    got = lr.length_regulator(torch.from_numpy(x), torch.from_numpy(dur),
                              max_len)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(length_regulator(x, dur, max_len)))
    np.testing.assert_array_equal(
        lr.expanded_lengths(torch.from_numpy(dur)).numpy(),
        np.asarray(expanded_lengths(dur)))
