"""The port's training path against the JAX package, on the CPU.

- numpy pieces copied from the JAX package (epoch indexing, synthetic
  sequences, pose sampling and the PCA fit, TrainData) equal to it: arrays
  bit-exact, but for the crop transform T (float32 here, float64 rounded
  in the numpy oracle: rtol 1e-6) and what derives from it;
- ``Trainer._train_step_core`` for 3 steps from the same flax-converted
  weights of a dropout-free PoseRegNet (hidden 64), B=8, float32, with the
  augmentation draws made by JAX's sample_augment_params from the keys the
  JAX step uses: loss trace within rtol 1e-4; parameters within
  2 * lr * steps (Adam's first steps are sign-like, so a gradient near 0
  may flip a step), and 99.9% of them within rtol 1e-4;
- ``evaluate`` and ``predict`` on the same weights with a tail batch,
  rtol 1e-5;
- dropout masks from a seeded generator, ``fit`` and the entry point.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepprior_tpu import prior as jprior
from deepprior_tpu.camera import NYU_CAMERA as J_NYU
from deepprior_tpu.data.synthetic import make_sequence as j_make_sequence
from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig
from deepprior_tpu.ops.augment import sample_augment_params
from deepprior_tpu.train import prefetch as jprefetch
from deepprior_tpu.train import trainer as jtrainer

from deepprior_tpu_torch import prior as tprior
from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_depth_frame, make_sequence
from deepprior_tpu_torch.device import float32_compute
from deepprior_tpu_torch.mains import main_nyu_posereg_embedding
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.train import prefetch as tprefetch
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer
from deepprior_tpu_torch.utils.convert import train_state_from_flax

B = 8
N_FRAMES = 13  # not a multiple of B: the tail paths run


@pytest.fixture(scope="module", autouse=True)
def no_synth_cache():
    """The JAX make_sequence caches large sequences on disk; these are
    small, but keep it off all the same."""
    old = os.environ.get("DEEPPRIOR_NO_SYNTH_CACHE")
    os.environ["DEEPPRIOR_NO_SYNTH_CACHE"] = "1"
    yield
    if old is None:
        del os.environ["DEEPPRIOR_NO_SYNTH_CACHE"]


@pytest.fixture(scope="module")
def seqs():
    return (j_make_sequence(J_NYU, N_FRAMES, seed=7),
            make_sequence(NYU_CAMERA, N_FRAMES, seed=7))


def test_aligned_epoch_indices_match_jax():
    for n, b in ((13, 8), (16, 8), (100, 32), (5, 16)):
        ja, ta = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(3):
            np.testing.assert_array_equal(
                tprefetch.aligned_epoch_indices(ta, n, b),
                jprefetch.aligned_epoch_indices(ja, n, b))
    arrays = {"x": np.arange(13), "y": np.arange(13) * 2}
    for got, want in zip(tprefetch.chunked_epochs(arrays, 8, 2, seed=1),
                         jprefetch.chunked_epochs(arrays, 8, 2, seed=1)):
        for k in arrays:
            np.testing.assert_array_equal(got[k], want[k])


def test_make_sequence_matches_jax(seqs):
    jseq, tseq = seqs
    assert tseq.name == jseq.name and tseq.config == jseq.config
    assert len(tseq.data) == len(jseq.data)
    for jf, tf in zip(jseq.data, tseq.data):
        for field in ("dpt", "gtorig", "gt3Dorig", "com"):
            np.testing.assert_array_equal(getattr(tf, field), getattr(jf, field),
                                          err_msg=field)
        np.testing.assert_allclose(tf.T, jf.T, rtol=1e-6)
        np.testing.assert_allclose(tf.gtcrop, jf.gtcrop, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(tf.gt3Dcrop, jf.gt3Dcrop, atol=1e-5)
        assert tf.extraData is None


def test_train_data_from_sequence_matches_jax(seqs):
    jseq, tseq = seqs
    for zero_one in (False, True):
        jd = jtrainer.TrainData.from_sequence(jseq, norm_zero_one=zero_one)
        td = TrainData.from_sequence(tseq, norm_zero_one=zero_one)
        for name in ("crops", "com", "cube"):
            np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
        np.testing.assert_allclose(td.m, jd.m, rtol=1e-6)
        np.testing.assert_allclose(td.gt3d_crop, jd.gt3d_crop, atol=1e-5)
    assert td.n == N_FRAMES
    dev = td.to("cpu")
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32 for t in dev)
    batch = dev.take(torch.tensor([3, 0]))
    np.testing.assert_array_equal(batch["com"].numpy(), td.com[[3, 0]])


@pytest.mark.parametrize("rot3d", [False, True])
def test_pose_prior_matches_jax(seqs, rot3d):
    jseq, _ = seqs
    d = jtrainer.TrainData.from_sequence(jseq)
    for modes in (("com", "rot", "none"), ("sc", "rot+com", "com+rot+sc"), ("none",)):
        args = (d.gt3d_crop, d.com, d.cube, 3000, modes)
        want = jprior.sample_random_poses(J_NYU, np.random.default_rng(1), *args,
                                          rot3d=rot3d, return_all=True)
        got = tprior.sample_random_poses(NYU_CAMERA, np.random.default_rng(1), *args,
                                         rot3d=rot3d, return_all=True)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
    want = jprior.fit_pose_prior(J_NYU, np.random.default_rng(2), d.gt3d_crop, d.com,
                                 d.cube, n_components=30, num_poses=3000, rot3d=rot3d)
    got = tprior.fit_pose_prior(NYU_CAMERA, np.random.default_rng(2), d.gt3d_crop,
                                d.com, d.cube, n_components=30, num_poses=3000,
                                rot3d=rot3d)
    np.testing.assert_array_equal(got.components.numpy(), want.components)
    np.testing.assert_array_equal(got.mean.numpy(), want.mean)
    assert got.n_components == 30
    poses = np.random.default_rng(3).standard_normal((5, 42)).astype(np.float32)
    np.testing.assert_allclose(got.transform(torch.from_numpy(poses)).numpy(),
                               np.asarray(want.transform(poses)), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pair(seqs):
    """(JAX trainer, JAX state, port trainer, data, prior) on the same
    weights: a dropout-free PoseRegNet with hidden 64."""
    jseq, _ = seqs
    data = jtrainer.TrainData.from_sequence(jseq)
    jp = jprior.fit_pose_prior(J_NYU, np.random.default_rng(2), data.gt3d_crop,
                               data.com, data.cube, num_poses=3000)
    flax_model = FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30, hidden=64,
                                           dropout=False))
    cfg = dict(batch_size=B, aug_modes=("com", "rot", "sc", "none"),
               model_has_dropout=False)
    jt = jtrainer.Trainer(flax_model, jtrainer.TrainConfig(**cfg), J_NYU, prior=jp)
    jstate = jt.init_state(data.crops[:B])
    tt = Trainer(PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64,
                                             dropout=False)),
                 TrainConfig(**cfg), NYU_CAMERA,
                 prior=tprior.PCAPrior(jp.components, jp.mean), device="cpu")
    return jt, jstate, tt, data


def test_train_step_matches_jax(pair):
    jt, jstate, tt, data = pair
    tstate = train_state_from_flax(tt, jax.tree.map(np.asarray, jstate.params))
    lr = float(np.float32(1e-4))
    tdata = TrainData(*data).to("cpu")
    jstep = jax.jit(jt._train_step_core)  # eager JAX takes seconds per step
    jl, tl = [], []
    for step in range(3):
        idx = np.arange(step, step + B) % data.n
        jbatch = {k: jnp.asarray(getattr(data, k)[idx])
                  for k in ("crops", "gt3d_crop", "com", "cube", "m")}
        aug_key = jax.random.key(100 + step)
        params = [np.array(a) for a in sample_augment_params(aug_key, B, 4)]
        jstate, jloss = jstep(jstate, jbatch, aug_key, jax.random.key(7), lr)
        tstate, tloss = tt._train_step_core(tstate, tdata.take(torch.from_numpy(idx)),
                                            params, None, lr)
        jl.append(float(jloss))
        tl.append(float(tloss))
    print("loss trace JAX", jl, "port", tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tstate.step == 3 and int(jstate.step) == 3
    want = tt.model.state_dict()
    got = train_state_from_flax(tt, jax.tree.map(np.asarray, jstate.params)).model.state_dict()
    ours = {k: v.clone() for k, v in want.items()}
    n_tot = n_close = 0
    for k in got:
        a, b = ours[k].numpy(), got[k].numpy()
        np.testing.assert_allclose(a, b, atol=2 * lr * 3, rtol=0, err_msg=k)
        n_tot += a.size
        n_close += int(np.isclose(a, b, rtol=1e-4, atol=1e-7).sum())
    print(f"{n_close} of {n_tot} params within rtol 1e-4")
    assert n_close >= 0.999 * n_tot


def test_l2_penalty_matches_jax(pair):
    """Weight decay's sum covers the conv and dense kernels only."""
    from deepprior_tpu_torch.train.trainer import _l2_penalty

    jt, jstate, tt, _ = pair
    tstate = train_state_from_flax(tt, jax.tree.map(np.asarray, jstate.params))
    want = float(jtrainer._l2_penalty(jstate.params))
    with torch.no_grad():
        got = float(_l2_penalty(tstate.model))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_evaluate_and_predict_match_jax(pair):
    jt, jstate, tt, data = pair
    tstate = train_state_from_flax(tt, jax.tree.map(np.asarray, jstate.params))
    want = jt.evaluate(jstate, data)
    got = tt.evaluate(tstate, TrainData(*data))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    pw = jt.predict(jstate, data.crops, batch_size=5)  # 13 = 5 + 5 + 3
    pg = tt.predict(tstate, data.crops, batch_size=5)
    assert pg.shape == pw.shape == (N_FRAMES, 30)
    # atol: near-zero outputs carry the conv sums' order (test_torch_models)
    np.testing.assert_allclose(pg, pw, rtol=1e-5, atol=1e-5)


def test_dropout_masks_follow_the_generator():
    cfg = PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64)
    model = PoseRegNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (4, 1, 128, 128)).astype(np.float32))
    model.train()
    outs = [model(x, generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    # the kept units are scaled by 1 / (1 - 0.3): the mean activation holds
    head_in = torch.ones((20000, 64))
    lin = model.head
    drop = lin._drop(head_in, torch.Generator().manual_seed(1))
    assert abs(float((drop == 0).float().mean()) - 0.3) < 0.01
    torch.testing.assert_close(drop[drop != 0], torch.full_like(drop[drop != 0],
                                                                1.0 / 0.7))
    model.eval()
    a = model(x, generator=torch.Generator().manual_seed(5))
    b = model(x)
    assert torch.equal(a, b)


def test_fit_runs_and_keeps_the_history_structure(tmp_path):
    seq = make_sequence(NYU_CAMERA, 48, seed=3)
    val = make_sequence(NYU_CAMERA, 16, seed=4, name="val")
    data, vdata = TrainData.from_sequence(seq), TrainData.from_sequence(val)
    pri = tprior.fit_pose_prior(NYU_CAMERA, np.random.default_rng(0), data.gt3d_crop,
                                data.com, data.cube, num_poses=2000)
    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64))
    cfg = TrainConfig(batch_size=16, n_epochs=2, validation_frequency=2)
    trainer = Trainer(model, cfg, NYU_CAMERA, prior=pri, device="cpu")
    state = trainer.init_state()
    lines = []
    state, hist = trainer.fit(state, data, val_data=vdata, log=lines.append)
    assert set(hist) == {"train_cost", "val_error_mm"}
    assert len(hist["train_cost"]) == 2 * 3  # 2 epochs of ceil(48 / 16) steps
    assert len(hist["val_error_mm"]) == 2 * 2  # after steps 2 and 3 of each
    assert np.isfinite(hist["train_cost"]).all()
    assert np.isfinite(hist["val_error_mm"]).all()
    assert state.step == 6
    assert lines[0].startswith("epoch 0: lr 1.00e-04") and "val_mm" in lines[0]
    assert lines[-1].startswith("best params at epoch")
    assert trainer.check_nans(state) == []
    # a snapshot and streamed training are ported (tests/test_torch_resume.py,
    # tests/test_torch_streamed.py): one more epoch of each runs here
    snap = str(tmp_path / "net")
    state, hist = trainer.fit(state, data, n_epochs=1, snapshot_path=snap, log=lines.append)
    assert os.path.isfile(snap + "_last.ckpt") and len(hist["train_cost"]) == 3 * 3
    arrays = {k: np.asarray(getattr(data, k)) for k in TrainData._fields}
    state, hist = trainer.fit_streamed(state, arrays, n_epochs=1, log=lines.append)
    assert len(hist["train_cost"]) == 4 * 3 and state.step == 12
    with pytest.raises(ValueError, match="nearest-only"):
        Trainer(model, cfg._replace(aug_resize="linear", aug_fuse_norm=True),
                NYU_CAMERA)


def test_main_entry_writes_results(tmp_path, capsys):
    main_nyu_posereg_embedding.main([
        "--synthetic", "--epochs", "1", "--batch-size", "16", "--nmax", "32",
        "--out", str(tmp_path), "--device", "cpu",
    ])
    with open(tmp_path / "train_EMB_PCA30" / "results.json") as fh:
        res = json.load(fh)
    assert set(res) == {"test_1", "test_2"}
    for rec in res.values():
        assert set(rec) == {"mean_mm", "max_mm", "median_mm", "joint_median_mm",
                            "frames_within_40mm", "per_joint_mean_mm"}
        assert np.isfinite(rec["mean_mm"]) and len(rec["per_joint_mean_mm"]) == 14
    assert "test_1: mean" in capsys.readouterr().out


def test_main_trains_resnet_on_cpu(tmp_path):
    """--model resnet trains ResNet-47 (type 2, the dropout head) and writes
    a network_prior.ckpt that names its family and carries the BatchNorm
    statistics the steps updated; load_serving_net restores every tensor,
    and refuses the checkpoint as a PoseRegNet."""
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.models import ResNet
    from deepprior_tpu_torch.train.checkpoint import checkpoint_config

    state, results, hist = main_nyu_posereg_embedding.main([
        "--model", "resnet", "--synthetic", "--epochs", "1", "--batch-size", "8",
        "--nmax", "16", "--out", str(tmp_path), "--device", "cpu",
    ])
    assert isinstance(state.model, ResNet) and state.model.cfg.dropout
    assert state.step == 2 and np.isfinite(hist["train_cost"]).all()
    assert set(results) == {"test_1", "test_2"}
    ckpt = str(tmp_path / "train_EMB_PCA30" / "network_prior.ckpt")
    stored = checkpoint_config(ckpt)
    assert stored["model"] == "resnet" and stored["resnet_type"] == 2
    assert stored["model_has_dropout"]
    trained = state.model.state_dict()
    assert not torch.equal(trained["bn.running_var"], torch.ones(256))
    model, prior = load_serving_net("resnet", checkpoint=ckpt, device="cpu")
    assert set(model.state_dict()) == set(trained)
    for k, v in model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    assert prior.components.shape == (30, 42)
    with pytest.raises(ValueError, match="holds a resnet"):
        load_serving_net("poseregnet", checkpoint=ckpt, device="cpu")


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--accept"], ["--sp", "2"]])
def test_main_unported_flags_raise(tmp_path, flag):
    """--dp 2 and --sp 2 without a process group raise naming the launcher
    (--sharded-snapshots is ported: tests/test_torch_checkpoint_sharded.py;
    --sp under torchrun: tests/test_torch_spatial.py); --accept is ported
    (tests/test_torch_accept.py) and a missed threshold raises SystemExit."""
    if flag[0] in ("--dp", "--sp"):
        with pytest.raises(RuntimeError, match="torchrun"):
            main_nyu_posereg_embedding.main(["--synthetic", "--out", str(tmp_path),
                                             "--device", "cpu"] + flag)
        return
    with pytest.raises(SystemExit, match="acceptance FAILED"):
        main_nyu_posereg_embedding.main(
            ["--synthetic", "--out", str(tmp_path), "--device", "cpu", "--epochs", "1",
             "--nmax", "32", "--batch-size", "16", "--accept-mm", "0.0001"] + flag)


def _tf32_state():
    """The TF32 switches of cuDNN's convs and cuBLAS's matmuls, read through
    ``fp32_precision`` where this torch has it: after that API wrote a
    value, reading the legacy ``allow_tf32`` flags can raise."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if hasattr(matmul, "fp32_precision"):
        return cudnn.conv.fp32_precision, matmul.fp32_precision
    return cudnn.allow_tf32, matmul.allow_tf32


_TF32_OFF = (("ieee", "ieee") if hasattr(torch.backends.cuda.matmul, "fp32_precision")
             else (False, False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float32_compute_is_scoped_to_the_trainer(dtype):
    """A float32 model's step, evaluation and prediction run with TF32 off;
    the caller's settings hold outside them, and a bf16 model leaves them
    alone."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    seen = []
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        caller = _tf32_state()
        model = PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3, hidden=64,
                                            dtype=dtype))
        model.register_forward_pre_hook(lambda mod, args: seen.append(_tf32_state()))
        data = TrainData.from_sequence(make_sequence(NYU_CAMERA, 4, seed=7))
        trainer = Trainer(model, TrainConfig(batch_size=4, aug_modes=None),
                          NYU_CAMERA, device="cpu")
        state = trainer.init_state()
        batch = data.to("cpu").take(torch.arange(4))
        state, loss = trainer._train_step_core(state, batch, None, None, 1e-4)
        trainer.evaluate(state, data)
        trainer.predict(state, data.crops)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert np.isfinite(float(loss)) and len(seen) == 3
    want = _TF32_OFF if dtype == torch.float32 else caller
    assert caller != _TF32_OFF and all(s == want for s in seen), seen


@pytest.mark.parametrize("flag", [["--packed-conv"], ["--no-packed-conv"],
                                  ["--aug-block-k", "4"]])
def test_main_rejects_tpu_only_flags(tmp_path, flag, capsys):
    """The TPU kernels' layout knobs have no counterpart on the card: the
    port's main does not accept them."""
    with pytest.raises(SystemExit):
        main_nyu_posereg_embedding.main(["--synthetic", "--out", str(tmp_path)] + flag)
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("api", ["allow_tf32", "fp32_precision"])
def test_pca_prior_computes_in_float32_with_tf32_on(api):
    """With TF32 turned on for the process, in either of PyTorch's two
    spellings of the switch, PCAPrior's products run no matmul (the op the
    switch governs) and match a float64 product to float32 round-off; a
    bf16 Trainer step with the prior (no float32 scope of its own) leaves
    the caller's settings as they were."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if api == "allow_tf32":
        flags, on = ((cudnn, "allow_tf32"), (matmul, "allow_tf32")), True
    else:
        flags, on = ((cudnn.conv, "fp32_precision"), (matmul, "fp32_precision")), "tf32"
    saved = [getattr(obj, attr) for obj, attr in flags]
    rng = np.random.default_rng(4)
    comps = rng.standard_normal((30, 42)).astype(np.float32)
    mean = rng.standard_normal(42).astype(np.float32)
    emb = rng.standard_normal((9, 30)).astype(np.float32)
    poses = rng.standard_normal((9, 42)).astype(np.float32)
    prior = tprior.PCAPrior(comps, mean)
    try:
        for obj, attr in flags:
            setattr(obj, attr, on)
        with Ops() as ops:
            dec = prior.inverse_transform(torch.from_numpy(emb))
            enc = prior.transform(torch.from_numpy(poses))
        assert not ops.seen & {"mm", "addmm", "bmm", "baddbmm", "matmul", "linear"}, ops.seen
        c64 = comps.astype(np.float64)
        np.testing.assert_allclose(dec.numpy(), emb @ c64 + mean, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(enc.numpy(), (poses - mean.astype(np.float64)) @ c64.T,
                                   rtol=1e-5, atol=1e-5)
        model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64,
                                            dtype=torch.bfloat16))
        data = TrainData.from_sequence(make_sequence(NYU_CAMERA, 4, seed=7)).to("cpu")
        trainer = Trainer(model, TrainConfig(batch_size=4), NYU_CAMERA, prior=prior,
                          device="cpu")
        state, loss = trainer._train_step_core(
            trainer.init_state(), data.take(torch.arange(4)),
            torch.Generator().manual_seed(0), torch.Generator().manual_seed(1), 1e-4)
        assert np.isfinite(float(loss))
        assert [getattr(obj, attr) for obj, attr in flags] == [on, on]
    finally:
        for (obj, attr), value in zip(flags, saved):
            setattr(obj, attr, value)


@pytest.mark.parametrize("api", ["allow_tf32", "fp32_precision"])
def test_float32_compute_under_both_tf32_apis(api):
    """The caller turns TF32 on through either of PyTorch's two APIs; a
    float32 Trainer step, and a ``float32_compute`` block of the caller's
    own, then run with TF32 off inside them (read through
    ``fp32_precision``: after the new API set a value, reading a legacy
    flag can raise, which made this step raise before) and the caller's
    settings read back unchanged through the caller's own API."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if api == "allow_tf32":
        flags, on = ((cudnn, "allow_tf32"), (matmul, "allow_tf32")), True
    else:
        flags, on = ((cudnn.conv, "fp32_precision"), (matmul, "fp32_precision")), "tf32"
    saved = [getattr(obj, attr) for obj, attr in flags]
    seen = []
    try:
        for obj, attr in flags:
            setattr(obj, attr, on)
        model = PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3, hidden=64))
        model.register_forward_pre_hook(lambda mod, args: seen.append(_tf32_state()))
        data = TrainData.from_sequence(make_sequence(NYU_CAMERA, 4, seed=7)).to("cpu")
        trainer = Trainer(model, TrainConfig(batch_size=4, aug_modes=None), NYU_CAMERA,
                          device="cpu")
        state, loss = trainer._train_step_core(trainer.init_state(),
                                               data.take(torch.arange(4)), None, None, 1e-4)
        trainer.evaluate(state, data)
        with float32_compute():
            seen.append(_tf32_state())
        assert [getattr(obj, attr) for obj, attr in flags] == [on, on]
    finally:
        for (obj, attr), value in zip(flags, saved):
            setattr(obj, attr, value)
    assert np.isfinite(float(loss)) and len(seen) == 3
    assert all(s == _TF32_OFF for s in seen), seen


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One run of the flagship main on the CPU; the PCA prior it fitted is
    kept from its call of fit_pose_prior."""
    out = tmp_path_factory.mktemp("main")
    fitted = []

    def fit(*args, **kwargs):
        fitted.append(real_fit(*args, **kwargs))
        return fitted[-1]

    real_fit = tprior.fit_pose_prior
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tprior, "fit_pose_prior", fit)
        state, _, _ = main_nyu_posereg_embedding.main([
            "--synthetic", "--epochs", "1", "--batch-size", "16", "--nmax", "24",
            "--out", str(out), "--device", "cpu"])
    return out / "train_EMB_PCA30" / "network_prior.ckpt", state, fitted[0]


def test_main_writes_network_prior_ckpt(trained):
    """The flagship main writes network_prior.ckpt: the model's state dict
    and the PCA prior, fingerprinted with its TrainConfig and the model
    family."""
    from deepprior_tpu_torch.train import checkpoint as tckpt

    path, state, prior = trained
    assert tckpt.checkpoint_keys(str(path)) == {"params", "pca_components", "pca_mean"}
    want = {"params": state.model.state_dict(), "pca_components": prior.components,
            "pca_mean": prior.mean}
    cfg = TrainConfig(batch_size=16, n_epochs=1, aug_modes=("com", "rot", "none"),
                      seed=23455, model_has_dropout=True)
    tree, exact = tckpt.load_checkpoint(str(path), want,
                                        config=dict(cfg._asdict(), model="poseregnet"),
                                        strict=True)
    assert exact
    for k, v in state.model.state_dict().items():
        assert torch.equal(tree["params"][k], v), k
    assert torch.equal(tree["pca_components"], prior.components)
    assert torch.equal(tree["pca_mean"], prior.mean)


def test_load_serving_net_restores_the_checkpoint(trained):
    """load_serving_net(checkpoint=...) gives the trained weights and prior
    exactly: its estimator's joints equal those of one built from the
    trained model; a missing file raises FileNotFoundError."""
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    path, state, prior = trained
    model, loaded = load_serving_net(checkpoint=str(path), device="cpu")
    trained_sd = state.model.state_dict()
    assert set(model.state_dict()) == set(trained_sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, trained_sd[k]), k
    assert torch.equal(loaded.components, prior.components)
    assert torch.equal(loaded.mean, prior.mean)
    rng = np.random.default_rng(9)
    depth, com = (np.stack(a) for a in zip(*[make_depth_frame(NYU_CAMERA, rng)
                                             for _ in range(3)]))
    got = FusedEstimator(model, NYU_CAMERA, prior=loaded, device="cpu")(depth, com)
    want = FusedEstimator(state.model, NYU_CAMERA, prior=prior, device="cpu")(depth, com)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(FileNotFoundError):
        load_serving_net(checkpoint=str(path) + ".missing", device="cpu")
