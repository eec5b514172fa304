"""Streamed training on the CPU: ``train/prefetch.py::macro_chunks`` against
the JAX package's (the same index streams), ``DevicePrefetcher``'s
contract (errors re-raised on the consumer side, ``close()`` stops the
worker, StopIteration after exhaustion, no chunk aliases a reused buffer),
and ``Trainer.fit_streamed``: its loss trace bit-identical for every
chunk_steps and prefetch_depth and equal to ``fit``'s, with ``fit``'s
history structure, sub-epoch observers and NaN guard."""

import threading
import time

import numpy as np
import pytest
import torch

from deepprior_tpu.train import prefetch as jprefetch

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_sequence
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.train.prefetch import DevicePrefetcher, index_chunks, macro_chunks
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These CPU runs are small: one intra-op thread runs them as fast and
    keeps them from contending for the cores with parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,batch,chunk,start,seg", [
    (40, 8, 2, 0, 0), (37, 8, 3, 1, 0), (37, 8, 4, 0, 3), (64, 16, 8, 2, 1),
    (19, 4, 5, 3, 2), (16, 16, 1, 0, 0)])
def test_macro_chunks_match_jax(n, batch, chunk, start, seg):
    """The same (k, batch, ...) stacks in the same order as the JAX
    package's macro_chunks, resume and segment boundaries included."""
    arrays = {"crops": np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32),
              "com": np.arange(n * 3, dtype=np.float32).reshape(n, 3)}
    kw = dict(seed=11, start_epoch=start, segment_steps=seg)
    got = list(macro_chunks(arrays, batch, 4, chunk, **kw))
    want = list(jprefetch.macro_chunks(arrays, batch, 4, chunk, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    steps = -(-n // batch)
    assert sum(c["crops"].shape[0] for c in got) == (4 - start) * steps
    if seg:  # no chunk straddles a segment boundary
        pos = 0
        for c in got:
            k = c["crops"].shape[0]
            assert pos // seg == (pos + k - 1) // seg
            pos = (pos + k) % steps


def _index_chunks(n, fail_at=None):
    """(1, 2) index chunks of a 2n-row source, raising at ``fail_at``."""
    for i in range(n):
        if i == fail_at:
            raise MemoryError("host ran out")
        yield np.array([[2 * i, 2 * i + 1]])


def _source(n):
    return {"x": np.repeat(np.arange(n, dtype=np.float32), 2)[:, None] * np.ones((1, 3),
                                                                              np.float32)}


def test_prefetcher_streams_reraises_and_stops():
    it = DevicePrefetcher(_index_chunks(6), _source(6), depth=2, device="cpu")
    got = [int(c["x"][0, 0, 0]) for c in it]
    assert got == list(range(6)) and len(it.stage_s) == 6
    with pytest.raises(StopIteration):  # iterated again after exhaustion
        next(it)
    it.close()
    it = DevicePrefetcher(_index_chunks(6, fail_at=3), _source(6), depth=1, device="cpu")
    with pytest.raises(RuntimeError, match="worker failed") as err:
        for _ in it:
            pass
    assert isinstance(err.value.__cause__, MemoryError)
    with pytest.raises(StopIteration):
        next(it)
    it.close()


def test_prefetcher_close_stops_a_blocked_worker():
    """An abandoned iteration: the worker waits on a full queue; close()
    releases it and drops the staged chunks, and a later next() stops."""
    it = DevicePrefetcher(_index_chunks(1000), _source(1000), depth=2, device="cpu")
    next(it)
    time.sleep(0.2)
    assert it._thread.is_alive() and it._q.full()
    it.close()
    assert not it._thread.is_alive() and it._q.empty()
    with pytest.raises(StopIteration):
        next(it)
    it.close()  # idempotent


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_gathers_from_a_source(depth):
    """The prefetcher takes index_chunks' (k, B) indices and stages
    macro_chunks' chunks."""
    rng = np.random.default_rng(3)
    arrays = {"crops": rng.normal(size=(21, 4, 5)).astype(np.float32),
              "com": rng.normal(size=(21, 3)).astype(np.float32)}
    want = list(macro_chunks(arrays, 4, 3, 2, seed=5, segment_steps=3))
    it = DevicePrefetcher(index_chunks(21, 4, 3, 2, seed=5, segment_steps=3), arrays,
                          depth=depth, device="cpu")
    got = list(it)
    assert len(got) == len(want) and len(it.stage_s) == len(want)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_prefetcher_chunks_do_not_alias():
    """Chunks kept by the consumer while the worker runs ahead keep their
    values: a staged chunk is a copy, never a buffer the worker reuses nor
    a view of the source."""
    src = _source(12)
    kept = list(DevicePrefetcher(_index_chunks(12), src, depth=1, device="cpu"))
    src["x"][:] = -1.0
    assert [float(c["x"].min()) for c in kept] == [float(c["x"].max()) for c in kept] \
        == list(range(12))


@pytest.fixture(scope="module")
def setup():
    seq = make_sequence(NYU_CAMERA, 37, seed=21)
    val = make_sequence(NYU_CAMERA, 9, seed=22, name="val")
    data, vdata = TrainData.from_sequence(seq), TrainData.from_sequence(val)
    arrays = {k: np.asarray(getattr(data, k)) for k in TrainData._fields}
    return data, vdata, arrays


def _trainer(**cfg):
    cfg = TrainConfig(batch_size=8, learning_rate=0.002, n_epochs=2, **cfg)
    tr = Trainer(PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3, hidden=32)), cfg,
                 NYU_CAMERA, device="cpu")
    return tr, tr.init_state()


@pytest.fixture(scope="module")
def resident(setup):
    data, vdata, _ = setup
    tr, st = _trainer(validation_frequency=2)
    st, hist = tr.fit(st, data, val_data=vdata, log=lambda m: None)
    return {k: list(v) for k, v in hist.items()}, st


@pytest.mark.parametrize("chunk_steps,depth", [(1, 1), (2, 2), (3, 1), (3, 2), (8, 2)])
def test_fit_streamed_trace_is_fits(setup, resident, chunk_steps, depth):
    """The loss trace, the sub-epoch observers and the final parameters
    equal fit's whatever chunk_steps and prefetch_depth: the same batches
    and draws in the same order."""
    data, vdata, arrays = setup
    hist, st = resident
    tr, st2 = _trainer(validation_frequency=2)
    lines = []
    st2, hist2 = tr.fit_streamed(st2, arrays, val_data=vdata, chunk_steps=chunk_steps,
                                 prefetch_depth=depth, log=lines.append)
    assert set(hist2) == set(hist) == {"train_cost", "val_error_mm"}
    assert hist2["train_cost"] == hist["train_cost"] and len(hist["train_cost"]) == 10
    assert hist2["val_error_mm"] == hist["val_error_mm"] and len(hist["val_error_mm"]) == 6
    assert st2.step == st.step == 10
    for k, v in st.model.state_dict().items():
        assert torch.equal(st2.model.state_dict()[k], v), k
    assert lines[0].startswith("epoch 0: lr 2.00e-04") and "val_mm" in lines[0]
    assert lines[-1].startswith("best params at epoch")
    assert not tr.prefetcher._thread.is_alive()


def test_fit_streamed_nan_guard_stops_the_worker(setup):
    """A non-finite cost raises at the epoch's end, and the prefetcher's
    worker does not outlive fit_streamed."""
    _, _, arrays = setup
    bad = dict(arrays, crops=np.full_like(arrays["crops"], np.nan))
    tr, st = _trainer(aug_modes=None)
    before = threading.active_count()
    with pytest.raises(FloatingPointError, match="non-finite training cost at epoch 0"):
        tr.fit_streamed(st, bad, n_epochs=50, chunk_steps=1, log=lambda m: None)
    assert not tr.prefetcher._thread.is_alive()
    assert threading.active_count() <= before
    assert len(tr.history["train_cost"]) == 5
    with pytest.raises(ValueError, match="smaller than one batch"):
        tr.fit_streamed(st, {k: v[:4] for k, v in arrays.items()})


def test_prof_streamed_needs_a_card(monkeypatch):
    """The measuring script has no CPU fallback: without a card it raises
    before it writes or imports anything."""
    from deepprior_tpu_torch.prof import prof_streamed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="prof_streamed"):
        prof_streamed.main([])
