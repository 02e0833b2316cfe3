"""Package hygiene of otslam_tpu_torch: no jax, explicit devices, kernels
built from source or an error, and CPU runs that never touch a kernel."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import otslam_tpu_torch
from otslam_tpu_torch.config import TSDFConfig
from otslam_tpu_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "otslam_tpu_torch"
SMALL = {"camera": {"width": 160, "height": 120, "fx": 141.400225,
                    "fy": 141.400225, "cx": 80.5, "cy": 60.5},
         "reconstruction": {
             "surface_samples": 5000,
             "camera": {"width": 160, "height": 120, "fx": 141.400225,
                        "fy": 141.400225, "cx": 80.5, "cy": 60.5},
             "tsdf": {"voxel_size": 0.02, "sdf_trunc": 0.08,
                      "dims": [64, 64, 64]}}}


def run_py(code: str, *args: str, cwd=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=240)


# runs the CLI in-process, then reports the modules and the launches of
# each kernel entry point
CLI = """
import json, runpy, sys
sys.argv = ["otslam_tpu_torch.cli"] + sys.argv[1:]
try:
    runpy.run_module("otslam_tpu_torch.cli", run_name="__main__")
finally:
    from otslam_tpu_torch.kernels._build import SIGNATURES
    from otslam_tpu_torch.utils.profiling import COUNTS
    print("REPORT " + json.dumps({
        "jax": "jax" in sys.modules,
        "otslam_tpu": "otslam_tpu" in sys.modules,
        "launches": [COUNTS["launches." + name] for name in SIGNATURES]}))
"""


def report(proc) -> dict:
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPORT ")]
    assert line, proc.stdout + proc.stderr
    return json.loads(line[-1][len("REPORT "):])


def test_sources_never_import_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|otslam_tpu|bench|"
                     r"bench_icp)\b", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if bad.search(p.read_text())]
    assert not offenders


def test_sources_never_import_scipy():
    """The port declares no scipy (pyproject's torch extra is torch alone):
    StaticWallFilter computes its mask in numpy."""
    bad = re.compile(r"^\s*(from|import)\s+scipy\b", re.M)
    assert not [str(p) for p in PKG.rglob("*.py") if bad.search(p.read_text())]
    proc = run_py("import sys\n"
                  "from otslam_tpu_torch.mapping.object_filter import "
                  "StaticWallFilter\n"
                  "from otslam_tpu_torch.sim.world import full_room\n"
                  "StaticWallFilter(full_room().occupancy_grid(0.05))\n"
                  "print('scipy' in sys.modules)")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_import_and_cli_help_stay_off_jax():
    mods = sorted("otslam_tpu_torch." + ".".join(p.relative_to(PKG)
                                                 .with_suffix("").parts)
                  for p in PKG.rglob("*.py") if p.name != "__init__.py")
    assert {"otslam_tpu_torch.sim.runner",
            "otslam_tpu_torch.mapping.perception",
            "otslam_tpu_torch.kernels.raycast",
            "otslam_tpu_torch.mission.tracker",
            "otslam_tpu_torch.kernels.marching",
            "otslam_tpu_torch.kernels.voxel",
            "otslam_tpu_torch.mapping.hybrid",
            "otslam_tpu_torch.utils.profiling",
            "otslam_tpu_torch.kernels.cluster",
            "otslam_tpu_torch.mapping.initial_mapping",
            "otslam_tpu_torch.mapping.grid_mapper",
            "otslam_tpu_torch.eval.baseline",
            "otslam_tpu_torch.eval.report",
            "otslam_tpu_torch.eval.headline",
            "otslam_tpu_torch.adapters.native",
            "otslam_tpu_torch.adapters.native_mission",
            "otslam_tpu_torch.adapters.bus",
            "otslam_tpu_torch.pipeline.online",
            "otslam_tpu_torch.distributed.mesh",
            "otslam_tpu_torch.distributed.comm",
            "otslam_tpu_torch.distributed.launch",
            "otslam_tpu_torch.distributed.sharding",
            "otslam_tpu_torch.distributed.sparse",
            "otslam_tpu_torch.distributed.dryrun"} <= set(mods)
    assert "otslam_tpu_torch.bench" in mods
    proc = run_py("import importlib, sys\n"
                  f"for m in {mods!r}: importlib.import_module(m)\n"
                  "print(sorted(m for m in sys.modules if m.split('.')[0] "
                  "in ('jax', 'otslam_tpu', 'bench', 'bench_icp')))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for sub in ([], ["reconstruct"], ["eval"], ["mission"], ["capture"],
                ["report"], ["headline"], ["bench"]):
        proc = run_py(CLI, *sub, "--help")
        assert "usage:" in proc.stdout
        assert not report(proc)["jax"]


def test_native_sources_are_the_ports_own():
    """The port builds its own copies of the host C++ sources (under
    otslam_tpu_torch/native/, into build/), never the JAX package's
    native/ directory or its libraries."""
    from otslam_tpu_torch.adapters import native, native_mission
    assert {p.name for p in (PKG / "native").glob("*.cpp")} == {
        "otslam_native.cpp", "otslam_mission.cpp"}
    assert native.NATIVE_SRC == PKG / "native"
    assert native.BUILD_ROOT == ROOT / "build" / "otslam_tpu_torch_native"
    assert not list((PKG / "csrc").glob("*.cpp"))
    # no path into the repository's native/ directory, in any source
    outside = re.compile(r"(?<!otslam_tpu_torch/)\bnative/|"
                         r"libotslam_(native|mission)\.so|_REPO_ROOT")
    offenders = [str(p) for p in PKG.rglob("*")
                 if p.suffix in (".py", ".cpp", ".cu")
                 and outside.search(p.read_text())]
    assert not offenders
    assert native_mission.load_mission_native.__module__ == \
        "otslam_tpu_torch.adapters.native_mission"


KERNEL_SOURCES = {f"otslam_tpu_torch/csrc/{p.name}"
                  for p in (PKG / "csrc").glob("*.cu")} | {
    f"otslam_tpu_torch/native/{p.name}" for p in (PKG / "native").glob("*.cpp")}


def test_wheel_carries_every_kernel_and_host_source(tmp_path):
    """A wheel built offline from the tree (MANIFEST.in) holds the seven
    CUDA sources and the two host C++ sources that the installed package
    builds from."""
    import shutil
    import zipfile
    assert len(KERNEL_SOURCES) == 9
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "MANIFEST.in", "README.md"):
        shutil.copy(ROOT / name, src / name)
    shutil.copytree(PKG, src / "otslam_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", str(src), "--no-deps",
         "--no-build-isolation", "--no-index", "-q", "-w",
         str(tmp_path / "dist")], capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    assert KERNEL_SOURCES <= names


# imports the package from a copy outside any checkout and reports where
# both libraries would build
BUILD_ROOTS = """
import json, sys
from otslam_tpu_torch.adapters import native
from otslam_tpu_torch.kernels import _build
from otslam_tpu_torch.build_dirs import make_build_dir
make_build_dir(_build.BUILD_ROOT)
print(json.dumps({"kernels": str(_build.BUILD_ROOT),
                  "native": str(native.BUILD_ROOT),
                  "csrc": str(_build.CSRC), "src": str(native.NATIVE_SRC),
                  "jax": sorted(m for m in sys.modules if m.split(".")[0]
                                in ("jax", "otslam_tpu"))}))
"""


@pytest.mark.parametrize("cache", ["xdg", "home"])
def test_installed_copy_builds_in_the_user_cache(cache, tmp_path):
    """Outside a checkout both build roots resolve to the user's cache
    directory ($XDG_CACHE_HOME, else ~/.cache), which is created and
    writable; the sources stay the package's own."""
    import shutil
    site = tmp_path / "site"
    shutil.copytree(PKG, site / "otslam_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(site), HOME=str(tmp_path / "home"))
    env.pop("XDG_CACHE_HOME", None)
    if cache == "xdg":
        env["XDG_CACHE_HOME"] = str(tmp_path / "xdg")
    proc = subprocess.run([sys.executable, "-c", BUILD_ROOTS], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    roots = json.loads(proc.stdout)
    base = (tmp_path / "xdg" if cache == "xdg"
            else tmp_path / "home" / ".cache") / "otslam_tpu_torch"
    assert roots["kernels"] == str(base / "otslam_tpu_torch")
    assert roots["native"] == str(base / "otslam_tpu_torch_native")
    assert (base / "otslam_tpu_torch").is_dir()
    pkg = site / "otslam_tpu_torch"
    assert roots["csrc"] == str(pkg / "csrc")
    assert roots["src"] == str(pkg / "native")
    assert roots["jax"] == []


def test_unwritable_build_root_raises_naming_it(tmp_path):
    from otslam_tpu_torch.build_dirs import build_root, make_build_dir
    assert build_root() == ROOT / "build"          # this checkout
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(RuntimeError, match=re.escape(str(blocker / "b"))):
        make_build_dir(blocker / "b")


def test_examples_never_import_jax_or_the_jax_package():
    """The example ports import only otslam_tpu_torch, and loading each
    imports neither jax nor otslam_tpu."""
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|otslam_tpu)\b", re.M)
    ports = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [p.name for p in ports] == ["full_workflow_torch.py",
                                       "production_mission_torch.py"]
    for path in ports:
        assert not bad.search(path.read_text()), path
        proc = run_py(
            "import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "import inspect\n"
            "print(inspect.signature(m.main).parameters['device'].default)\n"
            "print(sorted(x for x in sys.modules if x.split('.')[0] in "
            "('jax', 'otslam_tpu')))")
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == ["cuda", "[]"]


def test_precision_is_pinned():
    assert otslam_tpu_torch.__version__
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cpu_reconstruct_and_eval_through_the_cli(tmp_path):
    """A dataset written by the port, reconstructed and scored through the
    CLI on the CPU: no jax, and no kernel launch."""
    root = tmp_path / "ds"
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(SMALL))
    make = run_py(f"""
import numpy as np
from otslam_tpu_torch.config import OTSLAMConfig
from otslam_tpu_torch.core.camera import PinholeIntrinsics
from otslam_tpu_torch.core.se3 import T_FIX_OPTICAL
from otslam_tpu_torch.pipeline.dataset import CaptureDataset
from otslam_tpu_torch.sim.sensors import look_at_pose, render_rgbd
from otslam_tpu_torch.sim.world import cardboard_room
cfg = OTSLAMConfig.from_json(open({str(cfg_path)!r}).read())
intr = PinholeIntrinsics.from_config(cfg.camera)
ds = CaptureDataset({str(root)!r}, cfg.camera)
for i in range(8):
    a = 2 * np.pi * i / 8
    pose = look_at_pose([1.5 + np.cos(a), 0.5 + np.sin(a), 0.5],
                        [1.5, 0.5, 0.15])
    d, c = render_rgbd(cardboard_room(), pose, intr, far=5.0, device="cpu")
    ds.save_frame("Object_0", c.numpy().astype(np.uint8), d.numpy(),
                  pose @ T_FIX_OPTICAL.T)
""")
    assert make.returncode == 0, make.stderr
    rec = run_py(CLI, "reconstruct", "--dataset", str(root), "--config",
                 str(cfg_path), "--auto-origin", "--device", "cpu")
    assert rec.returncode == 0, rec.stderr
    assert "Object_0: " in rec.stdout and "from 8 frames" in rec.stdout
    r = report(rec)
    assert not r["jax"] and not r["otslam_tpu"]
    assert r["launches"] == [0] * len(_build.SIGNATURES)
    ply = root / "3d_reconst" / "Object_0.ply"
    ev = run_py(CLI, "eval", "--map", str(ply), "--gt-samples", "5000",
                "--device", "cpu")
    assert ev.returncode == 0, ev.stderr
    metrics = json.loads(ev.stdout.splitlines()[0])
    assert 0 < metrics["accuracy_cm"] < 2.0
    r = report(ev)
    assert not r["jax"] and r["launches"] == [0] * len(_build.SIGNATURES)


def test_unported_options_raise(monkeypatch):
    from otslam_tpu_torch import bench, cli
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.pipeline.reconstruct import (fuse_frames,
                                                       reconstruct_frames)
    with pytest.raises(ValueError, match="backend"):
        fuse_frames([], [], [], None, ReconstructionConfig(), backend="xla",
                    device="cpu")
    # the benchmark command reaches bench.main with its device and returns
    # its exit code
    seen = []
    monkeypatch.setattr(bench, "main", lambda device: seen.append(device) or 7)
    assert cli.main(["bench", "--device", "cpu"]) == 7
    assert seen == ["cpu"]
    with pytest.raises(ValueError, match="output"):
        reconstruct_frames(None, None, output="voxels", device="cpu")
    with pytest.raises(ValueError, match="refine"):
        reconstruct_frames(None, None, refine="slam", device="cpu")


def test_missing_cuda_raises_instead_of_running_on_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_block_volume(TSDFConfig(dims=(8, 8, 8)), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_map([[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]], device="cuda")
    # the CLI's default device is CUDA: it fails rather than use the CPU
    from otslam_tpu_torch.core.io import write_ply
    ply = str(tmp_path / "map.ply")
    write_ply(ply, [[1.5, 0.5, 0.3], [1.6, 0.5, 0.3]])
    proc = run_py(CLI, "eval", "--map", ply, "--gt-samples", "10")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_without_a_card_or_package_exits_2(where, tmp_path):
    """chip_smoke.py cannot start without a CUDA GPU (this machine) or
    without the package beside it (a directory holding only the script):
    exit code 2, a reason on stderr and no result on stdout. Code 1 is
    left to a failed check."""
    if torch.cuda.is_available() and where == "repo":
        pytest.skip("this machine has CUDA: the script would run")
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=""),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == "" and "chip_smoke:" in proc.stderr


def test_build_without_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    if _build.nvcc_path() is not None:
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert not list(tmp_path.iterdir())


# Every public entry point of the port that takes a device, by module.
ENTRY_POINTS = {
    "otslam_tpu_torch.pipeline.reconstruct": [
        "fuse_frames", "reconstruct_frames", "reconstruct_object"],
    "otslam_tpu_torch.kernels.backproject": ["backproject_pointcloud"],
    "otslam_tpu_torch.eval.metrics": ["evaluate_map"],
    "otslam_tpu_torch.pipeline.refine": [
        "refine_trajectory", "refine_trajectory_f2m", "detect_loop_closures",
        "refine_trajectory_pgo"],
    "otslam_tpu_torch.mapping.localize": ["ScanLocalizer"],
    "otslam_tpu_torch.sim.sensors": ["render_rgbd", "render_lidar",
                                     "render_lidar_path"],
    "otslam_tpu_torch.kernels.tsdf": ["make_volume"],
    "otslam_tpu_torch.kernels.tsdf_block": ["make_block_volume"],
    "otslam_tpu_torch.core.volume_io": ["load_volume"],
    "otslam_tpu_torch.mapping.virtual_scan": ["VirtualScanner"],
    "otslam_tpu_torch.mapping.change_detect": ["ChangeDetector"],
    "otslam_tpu_torch.mapping.object_filter": ["WallProximityFilter"],
    "otslam_tpu_torch.sim.runner": ["MissionRunner"],
    "otslam_tpu_torch.mapping.grid_mapper": ["GridMapper"],
    "otslam_tpu_torch.mapping.initial_mapping": ["LidarClusterClassifier"],
    "otslam_tpu_torch.eval.baseline": ["dense_room_reconstruction"],
    "otslam_tpu_torch.eval.headline": ["headline_report"],
    "otslam_tpu_torch.pipeline.online": ["OnlineFusion"],
    "otslam_tpu_torch.adapters.bus": ["OTSLAMSystem"],
    "otslam_tpu_torch.bench": ["main", "measure_fusion", "measure_icp",
                               "measure_perception_ticks", "measure_mesh"],
}


def test_entry_points_default_to_the_card():
    import importlib
    import inspect

    from otslam_tpu_torch.device import resolve_device
    from otslam_tpu_torch.core.pointcloud import PointCloud
    from otslam_tpu_torch.kernels.tsdf import TSDFVolume
    from otslam_tpu_torch.kernels.tsdf_block import BlockTSDFVolume
    fns = [getattr(importlib.import_module(mod), name)
           for mod, names in ENTRY_POINTS.items() for name in names]
    fns += [TSDFVolume.from_numpy, BlockTSDFVolume.from_numpy,
            PointCloud.from_numpy]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__qualname__
    # every device parameter in the package defaults to the card
    defaults = set()
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef):
                a = node.args
                pos = a.posonlyargs + a.args
                pairs = list(zip(pos[len(pos) - len(a.defaults):],
                                 a.defaults))
                pairs += [(k, d) for k, d in zip(a.kwonlyargs, a.kw_defaults)
                          if d is not None]
                defaults |= {(path.name, node.name, ast.literal_eval(d))
                             for k, d in pairs if k.arg == "device"}
    assert len(defaults) >= len(fns)
    assert {d for *_, d in defaults} == {"cuda"}, defaults
    # the distributed paths take their device from the mesh: a CUDA mesh
    # unless the caller asks for another
    from otslam_tpu_torch.distributed.mesh import make_mesh
    assert inspect.signature(make_mesh).parameters[
        "device_type"].default == "cuda"
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_without_cuda_the_defaults_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    import numpy as np

    from otslam_tpu_torch import cli
    from otslam_tpu_torch.adapters.bus import OTSLAMSystem
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.core.pointcloud import PointCloud
    from otslam_tpu_torch.device import resolve_device
    from otslam_tpu_torch.eval.baseline import dense_room_reconstruction
    from otslam_tpu_torch.eval.headline import headline_report
    from otslam_tpu_torch.kernels.backproject import backproject_pointcloud
    from otslam_tpu_torch.mapping.grid_mapper import GridMapper
    from otslam_tpu_torch.mapping.initial_mapping import \
        LidarClusterClassifier
    from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner
    from otslam_tpu_torch.pipeline.online import OnlineFusion
    from otslam_tpu_torch.sim.runner import MissionRunner
    from otslam_tpu_torch.sim.sensors import render_lidar
    from otslam_tpu_torch.sim.world import cardboard_room
    with pytest.raises(RuntimeError, match="'cuda:0' requested but CUDA"):
        resolve_device(None)
    intr = PinholeIntrinsics(4, 3, 2.0, 2.0, 2.0, 1.5)
    for call in (lambda: render_lidar(cardboard_room(), 0.0, 0.0, 0.0,
                                      np.zeros(4, np.float32)),
                 lambda: VirtualScanner(),
                 lambda: MissionRunner(cardboard_room(), cardboard_room(),
                                       "unused"),
                 lambda: backproject_pointcloud(np.ones((3, 4)), None, intr),
                 lambda: PointCloud.from_numpy(np.zeros((2, 3))),
                 lambda: GridMapper(),
                 lambda: LidarClusterClassifier(),
                 lambda: dense_room_reconstruction(
                     np.ones((1, 3, 4)), np.ones((1, 3, 4, 3)),
                     np.eye(4)[None], intr, (0, 1, 0, 1, 0, 1)),
                 lambda: headline_report(str(tmp_path / "headline")),
                 lambda: OnlineFusion(ReconstructionConfig(), intr),
                 lambda: OTSLAMSystem(),
                 # the CLI commands' default device is the card too
                 lambda: cli.main(["check-frame", "--depth", "unused.png",
                                   "--out", "unused.ply"]),
                 lambda: cli.main(["capture", "--workdir",
                                   str(tmp_path / "ds"), "--pose", "0,0,0"]),
                 lambda: cli.main(["headline", "--workdir",
                                   str(tmp_path / "headline")]),
                 lambda: cli.main(["bench"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not list(tmp_path.iterdir())
