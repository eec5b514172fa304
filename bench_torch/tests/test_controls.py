"""The comparison that decides ``correct``, driven on the CPU through the
rest of a run (the look for a card skipped) at sizes a test run holds: a
sound run passes; the control (the program in the configuration's lower
precision) and every fault a cell can have, planted in the timed path,
come out not correct.

The faults: an answer altered where the program produces it (serving, the
camera loop); a train step that leaves its state unchanged; half of each
batch left out, the loss the mean over the rest.  The cells run on one
card, so no exchange between cards can be left out.
"""

import pytest
import torch

from bench_torch.lib.harness import run_cell

SMALL = {
    "poseregnet_nyu.serve_open": dict(rate_per_s=100.0, pool_frames=8, check_requests=16,
                                      warm_batches=1, max_batch=8),
    "poseregnet_nyu.camera_b1": dict(sequence_frames=4, warm_frames=1, check_frames=3),
    "poseregnet_nyu.train_b128": dict(batch_size=16, train_frames=100, pool_frames=8),
}
CASES = [
    ("poseregnet_nyu.serve_open", None, None, True),
    ("poseregnet_nyu.serve_open", "bfloat16", None, False),
    ("poseregnet_nyu.serve_open", None, "answer_altered", False),
    ("poseregnet_nyu.camera_b1", None, None, True),
    ("poseregnet_nyu.camera_b1", "bfloat16", None, False),
    ("poseregnet_nyu.camera_b1", None, "answer_altered", False),
    ("poseregnet_nyu.train_b128", None, None, True),
    ("poseregnet_nyu.train_b128", "bfloat16", None, False),
    ("poseregnet_nyu.train_b128", None, "state_unchanged", False),
    ("poseregnet_nyu.train_b128", None, "half_batch", False),
]


@pytest.mark.parametrize("cell,precision,fault,expect", CASES)
def test_correct_separates_sound_runs_from_the_control_and_faults(cell, precision, fault,
                                                                   expect):
    r = run_cell(cell, 3_000_000_123, 0.5, False, torch.device("cpu"), precision=precision,
                 fault=fault, overrides=SMALL[cell])
    assert r["checks"], r
    assert r["correct"] is expect, r["checks"]
