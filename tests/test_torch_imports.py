"""Guards for the port: it imports no jax and nothing of the JAX package,
its layers import one way (entry points above serving and training above
ops, with the device and precision rules at the bottom), and a request for
a CUDA device on a machine without one raises instead of running on the
CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import deepprior_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "flax" or m == "msgpack"
             or m == "deepprior_tpu" or m.startswith("deepprior_tpu."))
print(len(names), bad)
print(" ".join(names))
print("matplotlib" in sys.modules)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    first, names, mpl = proc.stdout.strip().splitlines()
    # plots import matplotlib when they draw, never at import: the card's
    # machine may lack it
    assert mpl == "False"
    n, bad = first.split(" ", 1)
    assert int(n) >= 40, proc.stdout  # every module of the package was imported
    assert bad == "[]", f"the port pulled in {bad}"
    for mod in ("geometry", "data.basetypes", "ops.augment", "ops.hopper_warp",
                "train.optimizer", "train.prefetch", "train.trainer",
                "eval.metrics", "mains.common", "mains.main_nyu_posereg_embedding",
                "ops.resize", "ops.com", "ops.refine_cnn", "models.scalenet",
                "data.detector_np", "realtime.camera", "realtime.pipeline",
                "mains.demo_realtime", "utils.profiling", "utils.flops",
                "ops.hopper_probes", "prof.prof_bench", "prof.prof_warp_bf16",
                "train.checkpoint", "realtime.export", "mains.serve_http",
                "models.resnet", "utils.refweights", "data.importers", "data.dataset",
                "data.trees", "eval.datasets", "mains.main_icvl_posereg_embedding",
                "mains.main_msra15_posereg_embedding_crossval", "mains.main_nyu_com_refine",
                "mains.main_icvl_com_refine", "mains.main_msra15_com_refine",
                "parallel", "parallel.mesh", "parallel.collectives", "parallel.multihost",
                "parallel.train_dist", "parallel.serve", "train.checkpoint_sharded",
                "mains.dryrun", "prof.sweeps", "eval.plots", "utils.helpers", "utils.text",
                "utils.pointcloud", "ops._build", "parallel.spatial",
                "train.jax_checkpoint", "prof.prof_graph_gc", "device", "models.family"):
        assert f"deepprior_tpu_torch.{mod}" in names.split(), mod


def _imports(path):
    """The modules the file at ``path`` imports anywhere in it, at the top
    or inside a function: ``import a.b`` names a.b, ``from a.b import c``
    names a.b and a.b.c (c may be a module).  The package imports
    absolutely, so a relative import fails here."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}:{node.lineno}: a relative import"
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_layers_import_downward():
    """No module outside mains/ imports the entry points; no module of the
    ops, serving, data or model layers imports the trainer; the models
    import no serving module; device.py, the rules they share, imports
    nothing of the package.  The estimator and the trainer reach a model
    through one seam below both, models/family.py."""
    pkg = os.path.join(ROOT, "deepprior_tpu_torch")
    seen = {}
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                seen[os.path.relpath(path, pkg)] = _imports(path)

    def under(names, module):
        return sorted(n for n in names if n == module or n.startswith(module + "."))

    layer = {rel: rel.split(os.sep)[0] for rel in seen}
    assert {"mains", "ops", "realtime", "data", "train"} <= set(layer.values())
    for rel, names in seen.items():
        if layer[rel] != "mains":
            assert not under(names, "deepprior_tpu_torch.mains"), rel
        if layer[rel] in ("ops", "realtime", "data", "models"):
            assert not under(names, "deepprior_tpu_torch.train.trainer"), rel
        if layer[rel] == "models":
            assert not under(names, "deepprior_tpu_torch.realtime"), rel
    assert not under(seen["device.py"], "deepprior_tpu_torch")
    # the walk sees the imports the rules are about
    assert under(seen[os.path.join("mains", "serve_http.py")], "deepprior_tpu_torch.mains")
    assert "deepprior_tpu_torch.device.float32_compute" in seen[
        os.path.join("realtime", "fused.py")]
    for rel in (os.path.join("realtime", "fused.py"), os.path.join("train", "trainer.py")):
        assert "deepprior_tpu_torch.models.family.family_of" in seen[rel], rel


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.ops.hopper_crop import hopper_normalized_crop
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=16))
    with pytest.raises(RuntimeError, match="cuda"):
        FusedEstimator(model, NYU_CAMERA, device="cuda")
    # the model stayed where it was: nothing carried on on the CPU
    assert next(model.parameters()).device.type == "cpu"

    depth = np.zeros((1, 480, 640), np.float32)
    com = np.array([[320.0, 240.0, 600.0]], np.float32)
    for bilinear in (False, True):
        with pytest.raises((RuntimeError, AssertionError)):
            hopper_normalized_crop(torch.as_tensor(depth, device="cuda"), com,
                                   (250.0,) * 3, NYU_CAMERA.fx, NYU_CAMERA.fy,
                                   use_bilinear=bilinear)
    from deepprior_tpu_torch.ops.hopper_warp import hopper_warp_patch

    with pytest.raises((RuntimeError, AssertionError)):
        hopper_warp_patch(torch.zeros((1, 32, 32), device="cuda"),
                          torch.eye(3)[None])
    from deepprior_tpu_torch.ops import hopper_probes

    with pytest.raises((RuntimeError, AssertionError)):
        hopper_probes.band_probe(torch.zeros((1, 136, 256), device="cuda"),
                                 np.zeros((1, 2)), (128, 128))
    with pytest.raises((RuntimeError, AssertionError)):
        hopper_probes.warp_general(torch.zeros((1, 32, 32), device="cuda"),
                                   torch.eye(3)[None])
    # a device the wrapper has no path for raises too
    with pytest.raises(ValueError, match="cpu or cuda"):
        hopper_normalized_crop(torch.zeros((1, 480, 640), device="meta"), com,
                               (250.0,) * 3, NYU_CAMERA.fx, NYU_CAMERA.fy)
