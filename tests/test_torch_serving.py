"""The port's serving surfaces on the CPU (counterpart of
tests/test_serving.py): the micro-batcher, the HTTP front-end, the frozen
artifacts, ``FusedEstimator.aot_compile`` and the registered crop operator.

The port's FusedEstimator (PoseRegNet hidden 64, a (30, 42) PCA prior,
the weights converted from a flax model) is the reference: the batcher,
both artifact kinds, ``aot_compile`` and the HTTP server give its
``_pipeline`` joints bit for bit; the port's artifact agrees with the JAX
package's artifact of the same weights within 1e-3 mm (the joints gate
of PERF.md section 2).  On the CPU the server runs the pipeline eagerly
and ``aot_compile`` checks shapes and runs it; the CUDA graphs they replay
on a card are held to the eager call by chip_smoke.py.
"""

import http.client
import io
import json
import pickle
import threading
import time
from concurrent.futures import Future
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepprior_tpu.camera import NYU_CAMERA as JAX_NYU
from deepprior_tpu.data.synthetic import make_frame
from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig
from deepprior_tpu.prior import PCAPrior as JaxPCAPrior
from deepprior_tpu.realtime import export as jxp
from deepprior_tpu.realtime.fused import FusedEstimator as JaxFusedEstimator

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.mains import serve_http
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
from deepprior_tpu_torch.models.layers import calibrate_batchnorm
from deepprior_tpu_torch.ops import hopper_crop
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.realtime import export as xp
from deepprior_tpu_torch.realtime.batcher import MicroBatchServer, _Request
from deepprior_tpu_torch.realtime.export import ArtifactEstimator
from deepprior_tpu_torch.realtime.fused import Captured, FusedEstimator, replay_fn
from deepprior_tpu_torch.train.checkpoint import save_checkpoint
from deepprior_tpu_torch.train.trainer import _tf32_switches
from deepprior_tpu_torch.utils.convert import poseregnet_state_dict_from_flax
from deepprior_tpu_torch.utils.refweights import reference_pickle_from_state_dict

N = 13


@pytest.fixture(scope="module")
def setup():
    flax_model = FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30, hidden=64))
    variables = flax_model.init(jax.random.key(0), jnp.zeros((1, 128, 128, 1)))
    rng = np.random.default_rng(0)
    comps = (rng.standard_normal((30, 42)) * 0.05).astype(np.float32)
    mean = rng.uniform(-0.1, 0.1, 42).astype(np.float32)
    jax_est = JaxFusedEstimator(flax_model, JAX_NYU, prior=JaxPCAPrior(comps, mean))

    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64))
    model.load_state_dict(poseregnet_state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"])))
    est = FusedEstimator(model, NYU_CAMERA, prior=PCAPrior(comps, mean), device="cpu")

    rng = np.random.default_rng(7)
    frames = [make_frame(JAX_NYU, rng, num_joints=14) for _ in range(N)]
    depth = np.stack([f.extraData["dpt_full"] for f in frames])
    com = np.stack([f.com for f in frames])
    return est, depth, com, (jax_est, variables)


def _reference_joints(est, depth, com, max_batch):
    """What the batcher must give: the pipeline at the max_batch shape,
    tail-padded by repeating the last sample."""
    n = depth.shape[0]
    pad = max_batch - n
    dp = np.concatenate([depth, np.repeat(depth[-1:], pad, 0)])
    cp = np.concatenate([com, np.repeat(com[-1:], pad, 0)])
    with torch.inference_mode():
        joints, _, _ = est._pipeline(torch.from_numpy(dp), torch.from_numpy(cp))
    return joints.numpy()[:n]


def test_batcher_matches_direct_pipeline(setup):
    """Concurrent submissions return the joints of one padded pipeline call
    at the same batch shape, bit for bit."""
    est, depth, com, _ = setup
    want = _reference_joints(est, depth, com, max_batch=16)
    with MicroBatchServer(est, max_batch=16, max_wait_ms=200.0) as srv:
        assert not srv.graph  # a CPU estimator runs eagerly
        futs = [srv.submit(depth[i], com[i]) for i in range(N)]
        got = np.stack([f.result(timeout=120) for f in futs])
    np.testing.assert_array_equal(got, want)
    assert srv.stats["frames"] == N
    assert srv.stats["batches"] == 1  # all 13 within the 200 ms window
    assert 0.0 < srv.occupancy() <= 1.0


def test_batcher_single_request_tail_pad(setup):
    est, depth, com, _ = setup
    want = _reference_joints(est, depth[:1], com[:1], max_batch=8)
    with MicroBatchServer(est, max_batch=8, max_wait_ms=1.0) as srv:
        got = srv.submit(depth[0], com[0]).result(timeout=120)
    np.testing.assert_array_equal(got[None], want)


def test_batcher_per_request_cube_and_mirror(setup):
    """Mixed per-request cube/mirror ride the per-sample config: the joints
    of a direct call with the same (B,) config arrays, bit for bit."""
    est, depth, com, _ = setup
    n, mb = 4, 8
    cube = np.array([300.0, 300.0, 300.0], np.float32)
    dp = np.concatenate([depth[:n], np.repeat(depth[n - 1:n], mb - n, 0)])
    cp = np.concatenate([com[:n], np.repeat(com[n - 1:n], mb - n, 0)])
    cubes = np.tile(est.cube.numpy(), (mb, 1))
    cubes[1] = cube
    mirrors = np.zeros(mb, bool)
    mirrors[2] = True
    joints, _, _ = est(dp, cp, cube=cubes, mirror=mirrors)
    want = joints.numpy()[:n]
    with MicroBatchServer(est, max_batch=mb, max_wait_ms=200.0) as srv:
        futs = [
            srv.submit(depth[0], com[0]),
            srv.submit(depth[1], com[1], cube=cube),
            srv.submit(depth[2], com[2], mirror=True),
            srv.submit(depth[3], com[3]),
        ]
        got = np.stack([f.result(timeout=120) for f in futs])
    np.testing.assert_array_equal(got, want)


def test_batcher_error_isolation(setup):
    """A malformed request fails at submit (its caller alone); the server
    keeps serving."""
    est, depth, com, _ = setup
    with MicroBatchServer(est, max_batch=4, max_wait_ms=1.0) as srv:
        with pytest.raises(ValueError):
            srv.submit(np.zeros((9,), np.float32), com[0])
        assert srv.submit(depth[0], com[0]).result(timeout=120).shape == (14, 3)
        with pytest.raises(ValueError):
            srv.submit(np.zeros((32, 48), np.float32), com[0])
        assert srv.submit(depth[0], com[0]).result(timeout=120).shape == (14, 3)
        assert srv.stats["errors"] == 0


def test_batcher_mixed_shape_groups_are_isolated(setup):
    """Requests of different frame shapes never share one np.stack batch: a
    stray shape that slips past submit settles in its own group."""
    est, depth, com, _ = setup
    with MicroBatchServer(est, max_batch=8, max_wait_ms=50.0) as srv:
        stray = _Request(depth=np.zeros((32, 48), np.float32),
                         com=np.asarray(com[0], np.float32), cube=None,
                         mirror=False, future=Future())
        f_ok = srv.submit(depth[0], com[0])
        srv._q.put(stray)  # bypasses submit's validation
        assert f_ok.result(timeout=120).shape == (14, 3)
        stray.future.exception(timeout=120)  # settled (either outcome)


def test_batcher_close_rejects_new_work(setup):
    est, depth, com, _ = setup
    srv = MicroBatchServer(est, max_batch=4, max_wait_ms=1.0)
    srv.close()
    with pytest.raises(RuntimeError):
        srv.submit(depth[0], com[0])
    srv.close()  # a second close is a no-op
    assert not srv._thread.is_alive()


def test_batcher_concurrent_threads(setup):
    """Many submitter threads: every caller gets its own frame's joints,
    whichever requests shared its batch, and batching happens."""
    est, depth, com, _ = setup
    want = np.concatenate([
        _reference_joints(est, depth[i:i + 1], com[i:i + 1], max_batch=8)
        for i in range(N)
    ])
    results = {}
    with MicroBatchServer(est, max_batch=8, max_wait_ms=50.0) as srv:
        def worker(i):
            results[i] = srv.submit(depth[i], com[i]).result(timeout=120)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        batches = srv.stats["batches"]
    for i in range(N):
        np.testing.assert_array_equal(results[i], want[i])
    assert batches < N


def test_batcher_pins_resolution_from_camera(setup):
    """A wrong-resolution first request fails its own caller: the pin comes
    from the estimator's camera, not from whoever submits first."""
    est, depth, com, _ = setup
    with MicroBatchServer(est, max_batch=8, max_wait_ms=1.0) as srv:
        with pytest.raises(ValueError, match="does not match"):
            srv.submit(np.zeros((64, 64), np.float32), com[0])
        assert srv.submit(depth[0], com[0]).result(timeout=120).shape[-1] == 3


def test_batcher_graph_needs_a_cuda_estimator(setup):
    """graph=True replays a graph only where the estimator captures: a CPU
    estimator, or one that holds a frozen program, is served eagerly."""
    est, depth, com, _ = setup
    assert not est.captures
    with MicroBatchServer(est, max_batch=4, max_wait_ms=1.0, graph=True) as srv:
        assert srv.graph is False
        want = _reference_joints(est, depth[:1], com[:1], max_batch=4)
        np.testing.assert_array_equal(srv.submit(depth[0], com[0]).result(timeout=120)[None],
                                      want)


# ----------------------------------------------------------------------
def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/predict", body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_http_server_roundtrip(setup):
    """The port's serve_http handler in-process: /predict micro-batches
    concurrent POSTs (joints of the pipeline, bit for bit through JSON's
    float64), /healthz reports stats, malformed bodies get 400."""
    est, depth, com, _ = setup
    want = _reference_joints(est, depth[:4], com[:4], max_batch=8)
    srv = MicroBatchServer(est, max_batch=8, max_wait_ms=50.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_http.make_handler(srv))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        results = {}

        def post(i):
            results[i] = _post(port, _npz(depth=depth[i], com=com[i]))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        for i in range(4):
            status, out = results[i]
            assert status == 200, out
            np.testing.assert_array_equal(np.asarray(out["joints"], np.float32), want[i])
            assert out["batch"] == 8

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["ok"] and health["stats"]["frames"] >= 4

        assert _post(port, b"not an npz")[0] == 400
        assert _post(port, _npz(depth=np.zeros((64, 64), np.float32), com=com[0]))[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["stablehlo", "compiled"])
def test_artifact_roundtrip_matches_pipeline(setup, tmp_path, kind):
    """Both artifact kinds reproduce est._pipeline bit for bit, and the
    ArtifactEstimator serves through the micro-batcher's fixed-config mode,
    which rejects per-request cube/mirror."""
    est, depth, com, _ = setup
    b, hw = 8, depth.shape[1:]
    path = str(tmp_path / f"serve_{kind}.dpx")
    write = xp.precompile_serving if kind == "compiled" else xp.export_serving
    meta = write(est, b, hw, path)
    assert meta["kind"] == kind and meta["batch"] == b and tuple(meta["hw"]) == hw
    with torch.inference_mode():
        ref = est._pipeline(torch.from_numpy(depth[:b]), torch.from_numpy(com[:b]))
    art = ArtifactEstimator(path)
    assert art.batch == b and art.hw == hw and art.device.type == "cpu"
    for got, want in zip(art(depth[:b], com[:b]), ref):
        assert torch.equal(got, want)

    with MicroBatchServer(art, max_batch=art.batch, max_wait_ms=1.0,
                          frame_shape=art.hw) as srv:
        assert not srv.graph
        futs = [srv.submit(depth[i], com[i]) for i in range(b)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=60), ref[0][i].numpy())
        with pytest.raises(ValueError, match="fixed-config"):
            srv.submit(depth[0], com[0], cube=np.array([300.0] * 3))
        with pytest.raises(ValueError, match="fixed-config"):
            srv.submit(depth[0], com[0], mirror=True)


def test_artifact_matches_jax_artifact(setup, tmp_path):
    """The port's exported program and the JAX package's StableHLO artifact
    of the same weights agree within 1e-3 mm."""
    est, depth, com, (jax_est, variables) = setup
    b, hw = 4, depth.shape[1:]
    jpath, tpath = str(tmp_path / "jax.dpx"), str(tmp_path / "torch.dpx")
    jxp.export_serving(jax_est, variables, b, hw, jpath, platforms=("cpu",))
    xp.export_serving(est, b, hw, tpath)
    jfn, _ = jxp.load_serving(jpath)
    tfn, _ = xp.load_serving(tpath, device="cpu")
    j_want, c_want, cr_want = (np.asarray(a) for a in jfn(depth[:b], com[:b]))
    j_got, c_got, cr_got = (t.numpy() for t in tfn(depth[:b], com[:b]))
    assert j_got.shape == (b, 14, 3)
    np.testing.assert_allclose(j_got, j_want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(c_got, c_want, rtol=1e-6)
    np.testing.assert_allclose(cr_got, cr_want, rtol=0, atol=1e-4)


def test_artifact_kind_mismatch_and_jax_artifact_rejected(setup, tmp_path):
    """Loaders refuse the wrong kind and the other package's artifacts with
    a message; load_artifact dispatches on the kind."""
    est, depth, com, (jax_est, variables) = setup
    path = str(tmp_path / "serve.dpx")
    xp.export_serving(est, 4, depth.shape[1:], path)
    with pytest.raises(ValueError, match="stablehlo"):
        xp.load_precompiled(path)
    _, meta = xp.load_artifact(path)
    assert meta["kind"] == "stablehlo"
    cpath = str(tmp_path / "serve_c.dpx")
    xp.precompile_serving(est, 4, depth.shape[1:], cpath)
    with pytest.raises(ValueError, match="compiled artifact"):
        xp.load_serving(cpath)
    with pytest.raises(ValueError, match="compiled for 'cpu'"):
        xp.load_precompiled(cpath, device="cuda")
    jpath = str(tmp_path / "jax.dpx")
    jxp.export_serving(jax_est, variables, 4, depth.shape[1:], jpath, platforms=("cpu",))
    with pytest.raises(ValueError, match="JAX"):
        xp.load_artifact(jpath)
    with pytest.raises(ValueError, match="not a deepprior_tpu serving artifact"):
        jxp.load_artifact(path)


def test_serve_http_checkpoint_and_artifact(setup, tmp_path):
    """serve_http on the CPU: --checkpoint serves the checkpoint's weights
    (the estimator's joints); --export-artifact writes an artifact that
    --artifact serves with the same joints; --dp must divide --max-batch
    and serves the estimator only."""
    _, depth, com, _ = setup
    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30),
                       generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    comps = (rng.standard_normal((30, 42)) * 0.05).astype(np.float32)
    mean = rng.uniform(-0.1, 0.1, 42).astype(np.float32)
    ckpt = str(tmp_path / "network_prior.ckpt")
    save_checkpoint(ckpt, {"params": model.state_dict(), "pca_components": comps,
                           "pca_mean": mean})
    est = FusedEstimator(model, NYU_CAMERA, prior=PCAPrior(comps, mean), device="cpu")
    want = _reference_joints(est, depth[:3], com[:3], max_batch=4)

    parser = serve_http.build_parser()
    args = parser.parse_args(["--checkpoint", ckpt, "--device", "cpu", "--max-batch", "4",
                              "--max-wait-ms", "50"])
    srv = serve_http.build_server(args)
    try:
        futs = [srv.submit(depth[i], com[i]) for i in range(3)]
        np.testing.assert_array_equal(np.stack([f.result(timeout=120) for f in futs]), want)
    finally:
        srv.close()

    art = str(tmp_path / "serve.dpx")
    assert serve_http.main(["--checkpoint", ckpt, "--device", "cpu", "--max-batch", "4",
                            "--export-artifact", art]) is None
    srv = serve_http.build_server(parser.parse_args(["--artifact", art, "--device", "cpu",
                                                     "--max-wait-ms", "50"]))
    try:
        assert srv.max_batch == 4
        futs = [srv.submit(depth[i], com[i]) for i in range(3)]
        np.testing.assert_array_equal(np.stack([f.result(timeout=120) for f in futs]), want)
    finally:
        srv.close()

    with pytest.raises(SystemExit, match="multiple of --dp 3"):
        serve_http.main(["--dp", "3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="artifact"):
        serve_http.main(["--dp", "2", "--device", "cpu", "--artifact", art])
    # the checkpoint names its family: a PoseRegNet's is refused as a ResNet
    with pytest.raises(ValueError, match="poseregnet"):
        serve_http.build_server(parser.parse_args(["--model", "resnet", "--checkpoint", ckpt,
                                                   "--device", "cpu"]))


def test_serve_http_resnet_checkpoint_and_ref_pickle(setup, tmp_path):
    """serve_http --model resnet on the CPU: --checkpoint serves a ResNet-47
    network_prior.ckpt (its BatchNorm statistics included) with the
    estimator's joints bit for bit, and --ref-pickle serves the reference
    pickle of the same weights, its PCA decode appended, within 1e-3 mm."""
    _, depth, com, _ = setup
    model = ResNet(ResNetConfig(num_joints=1, n_dims=30),
                   generator=torch.Generator().manual_seed(6))
    rng = np.random.default_rng(6)
    prior = PCAPrior((rng.standard_normal((30, 42)) * 0.05).astype(np.float32),
                     rng.uniform(-0.1, 0.1, 42).astype(np.float32))
    est = FusedEstimator(model, NYU_CAMERA, prior=prior, device="cpu")
    calibrate_batchnorm(model, est(depth[:4], com[:4])[2][:, None])  # poses of mm scale
    ckpt = str(tmp_path / "network_prior.ckpt")
    save_checkpoint(ckpt, {"params": model.state_dict(), "pca_components": prior.components,
                           "pca_mean": prior.mean}, config={"model": "resnet"})
    want = _reference_joints(est, depth[:3], com[:3], max_batch=4)
    pkl = str(tmp_path / "network_prior.pkl")
    with open(pkl, "wb") as fh:
        pickle.dump(reference_pickle_from_state_dict(model.state_dict(), "resnet",
                                                     decode=prior), fh, 2)
    parser = serve_http.build_parser()
    for flags, exact in ((["--checkpoint", ckpt], True), (["--ref-pickle", pkl], False)):
        srv = serve_http.build_server(parser.parse_args(
            ["--model", "resnet", "--device", "cpu", "--max-batch", "4", "--max-wait-ms",
             "50"] + flags))
        try:
            assert isinstance(srv.est.model, ResNet) and not srv.est.model.training
            futs = [srv.submit(depth[i], com[i]) for i in range(3)]
            got = np.stack([f.result(timeout=120) for f in futs])
        finally:
            srv.close()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="resnet"):
        serve_http.build_server(parser.parse_args(["--checkpoint", ckpt, "--device", "cpu"]))


def test_resnet_artifacts_match_eager(tmp_path):
    """A ResNet with BatchNorm buffers, in eval mode, traces through
    torch.export into both artifact kinds, which give the eager
    _pipeline's outputs bit for bit."""
    model = ResNet(ResNetConfig(num_joints=1, n_dims=30, depth=11,
                                stages=(8, 8, 16, 32, 32), hidden=32),
                   generator=torch.Generator().manual_seed(2))
    calibrate_batchnorm(model, torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (4, 1, 128, 128)).astype(np.float32)))
    rng = np.random.default_rng(2)
    prior = PCAPrior((rng.standard_normal((30, 42)) * 0.05).astype(np.float32),
                     np.zeros(42, np.float32))
    est = FusedEstimator(model, NYU_CAMERA, prior=prior, device="cpu")
    frames = [make_frame(JAX_NYU, np.random.default_rng(9), num_joints=14) for _ in range(2)]
    depth = torch.from_numpy(np.stack([f.extraData["dpt_full"] for f in frames]))
    com = torch.from_numpy(np.stack([f.com for f in frames]))
    with torch.inference_mode():
        want = est._pipeline(depth, com)
    for write in (xp.export_serving, xp.precompile_serving):
        path = str(tmp_path / f"{write.__name__}.dpx")
        write(est, 2, tuple(depth.shape[1:]), path)
        fn, _ = xp.load_artifact(path)
        got = fn(depth, com)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), write.__name__


# ----------------------------------------------------------------------
def test_aot_compile_on_cpu_matches_eager(setup):
    """On a CPU estimator aot_compile's callable checks the fixed shapes and
    gives the eager call's outputs, in every mode: detection, refinement and
    'nd_bilinear' compile too (the CUDA graph of each is held to the eager
    pipeline in chip_smoke.py)."""
    est, depth, com, _ = setup
    fn = est.aot_compile(4, depth.shape[1:])
    got = fn(depth[:4], com[:4])
    want = est(depth[:4], com[:4])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="compiled for"):
        fn(depth[:3], com[:3])
    assert not est.captures
    for kw in (dict(detect=True), dict(refine_iters=2), dict(resize="nd_bilinear")):
        other = FusedEstimator(est.model, NYU_CAMERA, prior=est.prior, device="cpu", **kw)
        got = other.aot_compile(2, depth.shape[1:])(depth[:2], com[:2])
        want = other(depth[:2], com[:2])
        assert all(torch.equal(g, w) for g, w in zip(got, want)), kw


@pytest.mark.parametrize("linear", [False, True])
def test_crop_op_opcheck(setup, linear):
    """The registered operator passes torch.library.opcheck (schema, fake
    version, dispatch) in both resize modes, and equals the plain crop."""
    _, depth, com, _ = setup
    d, c = torch.from_numpy(depth[:2]), torch.from_numpy(com[:2])
    cube = torch.tensor([250.0, 250.0, 250.0])
    for fuse_clamp in (False, True):
        args = (d, c, cube, float(NYU_CAMERA.fx), float(NYU_CAMERA.fy), 128, 128,
                False, fuse_clamp, linear)
        torch.library.opcheck(hopper_crop.normalized_crop_op, args)
    got = torch.ops.deepprior_tpu_torch.normalized_crop(*args)
    want = hopper_crop.hopper_normalized_crop(d, c, cube, NYU_CAMERA.fx, NYU_CAMERA.fy,
                                              fuse_clamp=True, use_bilinear=linear)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_artifact_moves_to_another_device(setup, tmp_path):
    """load_serving(device=...) moves the exported program with
    torch.export.passes.move_to_device_pass: on the meta device it runs the
    crop operator's fake version and gives the outputs' shapes there."""
    est, depth, com, _ = setup
    path = str(tmp_path / "serve.dpx")
    xp.export_serving(est, 2, depth.shape[1:], path)
    fn, meta = xp.load_serving(path, device="meta")
    assert meta["device"] == "meta"
    joints, com3d, crops = fn(depth[:2], com[:2])
    assert joints.device.type == "meta" and joints.shape == (2, 14, 3)
    assert com3d.shape == (2, 3) and crops.shape == (2, 128, 128)


def test_serve_http_artifact_runs_on_the_card_unless_asked(setup, tmp_path, monkeypatch):
    """--artifact takes the entry points' default device, the card: without
    one it raises naming --device cpu, as --checkpoint does, instead of
    serving on the device the artifact was exported on."""
    est, depth, _, _ = setup
    path = str(tmp_path / "serve.dpx")
    xp.export_serving(est, 2, depth.shape[1:], path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parser = serve_http.build_parser()
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_http.build_server(parser.parse_args(["--artifact", path]))
    srv = serve_http.build_server(parser.parse_args(["--artifact", path, "--device", "cpu"]))
    try:
        assert srv.est.device.type == "cpu" and srv.max_batch == 2
    finally:
        srv.close()


class _SlowGraph:
    """Stands in for a CUDA graph on the CPU: a replay writes the outputs
    from the static inputs, slowly enough that callers not taking turns
    would see each other's inputs."""

    def __init__(self, depth, com, outputs):
        self.depth, self.com, self.outputs = depth, com, outputs

    def replay(self):
        time.sleep(0.001)
        self.outputs[0].copy_(self.depth[:, :1, :3])
        time.sleep(0.001)
        self.outputs[1].copy_(self.com)


def test_replay_fn_serves_concurrent_threads():
    """replay_fn's callable writes shared static buffers: calls from several
    threads take turns, and each gets the outputs of its own inputs."""
    b, hw = 2, (4, 5)
    depth, com = torch.zeros((b, *hw)), torch.zeros((b, 3))
    outputs = (torch.zeros((b, 1, 3)), torch.zeros((b, 3)), torch.zeros((b, *hw)))
    fn = replay_fn(Captured(_SlowGraph(depth, com, outputs), depth, com, None, None,
                            outputs, None))
    wrong = []

    def client(k):
        for _ in range(10):
            joints, com3d, _ = fn(np.full((b, *hw), k, np.float32), np.full((b, 3), k, np.float32))
            if not (bool((joints == k).all()) and bool((com3d == k).all())):
                wrong.append(k)

    pool = [threading.Thread(target=client, args=(k,)) for k in range(6)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=60)
    assert not wrong


@pytest.mark.parametrize("api", ["allow_tf32", "fp32_precision"])
def test_estimator_runs_the_model_with_tf32_off(setup, api):
    """The caller turns TF32 on through either API: the estimator's model
    still runs with TF32 off (eager, aot_compile's callable and the server),
    and the caller's settings come back unchanged."""
    est, depth, com, _ = setup
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if api == "allow_tf32":
        flags, on = ((cudnn, "allow_tf32"), (matmul, "allow_tf32")), True
    else:
        flags, on = ((cudnn.conv, "fp32_precision"), (matmul, "fp32_precision")), "tf32"
    switches, off = _tf32_switches()
    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64))
    model.load_state_dict(est.model.state_dict())
    seen = []
    model.register_forward_pre_hook(
        lambda mod, args: seen.append([getattr(obj, attr) for obj, attr in switches]))
    f32 = FusedEstimator(model, NYU_CAMERA, prior=est.prior, device="cpu")
    saved = [getattr(obj, attr) for obj, attr in flags]
    try:
        for obj, attr in flags:
            setattr(obj, attr, on)
        got = f32(depth[:2], com[:2])
        f32.aot_compile(2, depth.shape[1:])(depth[:2], com[:2])
        with MicroBatchServer(f32, max_batch=2, max_wait_ms=1.0) as srv:
            srv.submit(depth[0], com[0]).result(timeout=120)
        assert [getattr(obj, attr) for obj, attr in flags] == [on, on]
    finally:
        for (obj, attr), value in zip(flags, saved):
            setattr(obj, attr, value)
    assert len(seen) == 3 and all(s == [off, off] for s in seen), seen
    assert all(torch.equal(g, w) for g, w in zip(got, est(depth[:2], com[:2])))
