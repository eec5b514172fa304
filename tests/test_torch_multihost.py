"""parallel/multihost.py for real: processes launched as torchrun launches
them (the counterpart of tests/test_multihost.py:98-188).

- ``torchrun --nproc-per-node 2`` starts two processes that initialize a
  gloo group from torchrun's environment, build the global mesh, feed their
  ``process_local_batch_slice`` of one global batch and take a
  DistributedTrainer step: the global loss equals a single-device step on
  the whole batch within rtol 1e-5, the updated weights agree within 1e-6.
  In the same group they then run the training main with --dp 2
  --sharded-snapshots, which writes a sharded snapshot.
- ``torchrun --nproc-per-node 2 -m
  deepprior_tpu_torch.mains.main_nyu_posereg_embedding --device cpu
  --synthetic --dp 2 --sharded-snapshots --resume`` continues from it.
"""

import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.mains import main_nyu_posereg_embedding
from deepprior_tpu_torch.data.synthetic import make_sequence
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.parallel import DistributedTrainer, multihost
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

multihost.initialize(device="cpu")
multihost.initialize(device="cpu")  # idempotent
rank = dist.get_rank()
assert dist.get_world_size() == 2
mesh = multihost.global_mesh()
assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"dp": 2, "tp": 1}

B = 16
data = TrainData.from_sequence(make_sequence(NYU_CAMERA, B, num_joints=14, seed=4)).to("cpu")
sl = multihost.process_local_batch_slice(B, mesh)
assert (sl.start, sl.stop) == (8 * rank, 8 * rank + 8), sl
try:
    multihost.process_local_batch_slice(15, mesh)
    raise AssertionError("a batch of 15 split over 2 processes")
except ValueError:
    pass

cfg = TrainConfig(batch_size=B, aug_modes=None)
def model():
    return PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3, hidden=64, dropout=False))
tr = DistributedTrainer(model(), cfg, NYU_CAMERA, mesh, device="cpu")
st = tr.init_state()
local = {k: v[sl] for k, v in data.take(torch.arange(B)).items()}
st, loss = tr._train_step_core(st, local, None, None, 1e-3)
loss = float(tr._epoch_costs([loss])[0])

ref = Trainer(model(), cfg, NYU_CAMERA, device="cpu")
rst, rloss = ref._train_step_core(ref.init_state(), data.take(torch.arange(B)), None, None, 1e-3)
np.testing.assert_allclose(loss, float(rloss), rtol=1e-5)
for k, v in rst.model.state_dict().items():
    np.testing.assert_allclose(st.model.state_dict()[k].numpy(), v.numpy(), rtol=0, atol=1e-6)
print(f"MULTIHOST_OK rank={rank} loss={loss} single={float(rloss)}", flush=True)
# the training main in the same group (its main_device finds it initialized)
main_nyu_posereg_embedding.main(sys.argv[1:])
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _torchrun(program, out, *flags):
    """torchrun --nproc-per-node 2 of ``program`` (a script, or ['-m',
    module]) with the training main's flags."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), *program,
         "--device", "cpu", "--synthetic", "--dp", "2", "--sharded-snapshots",
         "--nmax", "32", "--batch-size", "16", "--out", out, *flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(), cwd=ROOT)


def _wait(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("processes timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The worker under torchrun: the step, then the first training."""
    tmp = tmp_path_factory.mktemp("multihost")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    out = str(tmp / "eval")
    return _wait([_torchrun([str(worker)], out, "--epochs", "2")])[0], out


def test_two_process_mesh_and_step(launched):
    log, _ = launched
    for rank in range(2):
        assert f"MULTIHOST_OK rank={rank}" in log, log


def test_torchrun_main_writes_and_resumes_a_sharded_snapshot(launched):
    from deepprior_tpu_torch.train.checkpoint_sharded import is_sharded_checkpoint

    log, out = launched
    run = os.path.join(out, "train_EMB_PCA30")
    snap = os.path.join(run, "net_last.ckpt")
    assert is_sharded_checkpoint(snap), log
    assert sorted(os.listdir(os.path.join(snap, "tree"))) == [
        ".metadata", "__0_0.distcp", "__1_0.distcp"]
    assert os.path.isfile(os.path.join(run, "network_prior.ckpt"))
    assert os.path.isfile(os.path.join(run, "results.json"))
    assert log.count("epoch 0:") == 1  # rank 0 logs, rank 1 does not
    resumed = _wait([_torchrun(["-m", "deepprior_tpu_torch.mains.main_nyu_posereg_embedding"],
                               out, "--epochs", "3", "--resume")])[0]
    assert f"resuming from {snap} at epoch 1" in resumed, resumed
    assert "epoch 2:" in resumed and "epoch 0:" not in resumed


def test_initialize_without_a_card_raises(monkeypatch):
    """initialize() with no device takes the card; on a machine without one
    it raises naming device="cpu" instead of making a gloo group on the CPU."""
    import torch
    import torch.distributed as dist

    from deepprior_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        multihost.initialize(num_processes=1, process_id=0,
                             store=dist.HashStore())


def test_initialize_passes_its_timeout(monkeypatch):
    """initialize(timeout=s) bounds the group's collectives by s seconds;
    without it torch's default stands."""
    import datetime

    import torch.distributed as dist

    from deepprior_tpu_torch.parallel import multihost

    seen = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: seen.append(kw))
    store = dist.HashStore()
    multihost.initialize(num_processes=1, process_id=0, store=store, device="cpu",
                         timeout=90)
    multihost.initialize(num_processes=1, process_id=0, store=store, device="cpu")
    assert seen[0]["timeout"] == datetime.timedelta(seconds=90)
    assert "timeout" not in seen[1]
