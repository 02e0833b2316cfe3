#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (otslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Exit code 0 when every phase passed; 1 when a check failed (its message on
stderr, after `chip_smoke: FAILED:`); 2 when the run cannot start: no CUDA
GPU, or no otslam_tpu_torch package beside the script. Only a run that
passed prints results. Phases, each of which fails the run when it goes
wrong:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the CUDA kernels from otslam_tpu_torch/csrc/ with nvcc;
3. each kernel against its plain PyTorch version at the main path's shapes
   (64 VGA frames, 1 cm voxels, a 256^3 volume = 32768 blocks, and
   100k x 50k points), with CUDA-event times for both:
   the fusion schedule's passes before K1 (the depth-mip pass's table and
   bounds, K2 block classification, the colour pack; each with
   torch.equal) at the reconstruction's 64-frame batch and at
   frame-to-model tracking's one frame (frame 32), K1 block fusion (tsdf,
   weight and colour bit-identical) at the reconstruction's 64-frame batch
   and at frame-to-model tracking's one frame (frame 32 into the volume of
   frames 0-31, capped at max_active = 2048 blocks), K3 nearest neighbour
   (d^2 and index
   bit-identical) at the eval's 100k x 50k and 50k x 100k and at the
   localizer's 1440-beam scan against the cardboard room's 0.05 m grid
   cloud (the operands of the first K3 call of a real
   ScanLocalizer.localize), each with the split S of its launch;
4. main path: a 64-frame VGA capture circle of the cardboard room, rendered
   on the card, goes through reconstruct_frames (the body of
   reconstruct_object after dataset loading) with the default
   ReconstructionConfig and auto_volume_config, then write_ply -> read_ply
   -> evaluate_map against the 50k-point scenario GT; every kernel of the
   path (mips, K2, pack, K1, K3) must have launched and the accuracy must
   be < 1 cm;
4b. mesh path: the same capture through reconstruct_frames(output="mesh")
   -> write_ply(faces=...) -> read_ply; the faces must index the vertices,
   everything be finite, the vertices at z >= z_filter_threshold score an
   accuracy < 1 cm against the phase-4 GT (K3), and the mips, K2, the
   pack, K1 and K3 have launched. Then on the fused block volume:
   extract_mesh_soup_block on the card equals its run on the CPU (masks
   equal, vertices and colours within 1e-6); the dense path on the
   densified 256^3 volume gives the block path's triangles as a set; and
   extract_meshes_block on two volumes with different origins equals the
   single path for each; the weld on the card gives numpy's keys,
   vertices, faces and colours (normals within 1e-5). Prints the
   triangles, welded vertices and the seconds of extraction (block path,
   dense 256^3 path) and of the weld, on the card and by numpy;
5. K4 windowed nearest neighbour against its plain version (bit-identical
   d^2 and index on every row) and against K3 (identical on every row whose
   nearest neighbour lies within the radius, >= the radius elsewhere) at
   50k x 50k with a 0.05 m radius and at the pair-ICP shape: two
   consecutive capture frames through refine._frame_points_normals, the
   source moved by the prior, the window of _pair_nn_window, radius 0.1 m;
   then that pair's annealed ICP with the fused kernels
   (refine._annealed_icp: csrc/icp_plane.cu and K4) beside the host loop
   (refine._annealed_icp_plain): transform, fitness and RMSE bit for bit,
   with each one's wall milliseconds (to a synchronize) and the fused
   kernels' and K4's device milliseconds against the fused loop's;
6. registration path: the phase-4 capture with its poses drifted by
   compounding odometry noise goes through reconstruct_frames with
   refine="icp" and refine="pgo", then write_ply -> read_ply ->
   evaluate_map(use_icp=True); then ScanLocalizer registers a 1440-beam
   scan against the cardboard room's 0.05 m grid. The fusion schedule's
   four kernels, K3 and K4 must have launched, pgo must lower the drifted trajectory's translation RMSE, and the scan
   must localize to < 4 cm and < 0.02 rad;
7. K5 ray casting against its plain version at the perception workload:
   1440 beams, range 10 m (200 steps), 64 poses in one call, on the
   cardboard room's 208^2 map and full_room's map, and the mission's 8
   poses on the cardboard map (bit-identical keys and ranges, at every
   lane count a ray), with CUDA-event times, hit
   beams and samples per second;
8. mission path: `python -m otslam_tpu_torch.cli mission` (through its
   main()) at the CLI's defaults (VGA camera, 1440 beams, 512^2 evidence
   grid, cardboard scenario) with --removed --localizer
   --perception-batch 8 for 300 ticks, then reconstruct_all (auto origin)
   over the mission's dataset and evaluate_map of Object_0 against the
   scenario GT. K5, K3 and the fusion schedule's four kernels must have
   launched, at least one stable object and 4
   missions, the removed-object check visited, every cloud non-empty and
   finite, and Object_0's accuracy < 2 cm;
9. map-building and headline path: (9a) GridMapper.add_trajectory on the
   card over 36 1440-beam scans of the cardboard room (the survey of
   tests/test_grid_mapper.py on a 5 cm grid), its log-odds equal to the
   CPU run's, the test's map checks, and a virtual scan (K5) of the map
   learned from the empty room, equal to the plain ray cast and within
   0.3 m of the real scan on >= 90 % of beams; (9b)
   LidarClusterClassifier on a 1440-beam scan with the initial-mapping
   profile, labels, classes and every statistic equal to the CPU run's,
   the OBJECT centroid within 0.5 m of the box; (9c)
   headline_report at its defaults (VGA, 12 frames an object, 48 room
   frames, 100k samples, 1 cm) on cardboard_room and table_chair_room
   with the checks of tests/test_headline.py: on cardboard_room the size
   reduction >= 99 %, the downsampled and voxel reductions >= 90 % and
   the accuracies; on table_chair_room 5 objects and the combined
   accuracy (its five 100k-sample clouds keep the size reduction below
   99 % at the defaults: printed, and held to 99 % in a third run at that
   test's 6 000 samples, 8 frames and 40 room frames), each report and
   its stage seconds printed; (9d) dense_room_reconstruction
   of the 48 room-sweep frames at 2 cm (500k finite points, max_active
   8192). The mips, K2, the pack, K1, K3 and K5 must have launched.
   After the phase's count, each kernel against its plain version at the
   phase's shapes, each shape added to its record: the mips, K2, the pack
   and K1 on one headline capture circle (12 VGA frames into the 128 x
   128 x 64 volume at 1 cm) and on 9d's 48 frames into the 59 150-block
   room volume with the 8192 cap, which must bind; there also the whole
   schedule (integrate_frames_sparse) against its plain version, tsdf,
   weight, colour and created equal; K3 at 9c's largest dense-crop calls
   (one single, one split launch); K5 on 9a's learned map;
10. online path: (10a) the phase-4 capture streamed through OnlineFusion
   (the native host library must have built: no NumPy fallback): a
   producer thread pushes the 64 frames into a 16-slot frame ring,
   waiting while it is full (nothing dropped), while this thread drains
   micro-batches of 4 through the fusion schedule (max_active 2048);
   extract -> the cloud above the floor -> evaluate_map, accuracy < 1 cm;
   (10b) OTSLAMSystem on the card over phase 8's scenario (the mission's
   world and saved map with --removed; 100 1440-beam scans, 50 at the
   mission's start, then toward the box), every /virtual_scan a K5
   launch, then its goal queue driven to exhaustion. The mips, K2, the
   pack, K1, K3 and K5 must have launched. After the count: the drained
   volume torch.equal to fuse_frames(max_active=2048, densify=False) of
   the same frames and to the plain schedule at the same cap (which must
   bind); the mips, K2, the pack and K1 against their plain versions on
   micro-batch 8 (frames 32-35) at the volume state before it with its
   capped work list, and K3 at evaluate_map's two calls, each shape added
   to its kernel's record; the system's added and removed clouds, stable
   objects and goal order equal to a CPU run's; the native tracker and
   sender fed the same points give the Python classes' stable objects
   and visit order. Prints frames/s push -> fused and the drain seconds;
11. distributed path: (11a) one rank on cuda:0 in a NCCL group:
   fuse_frames_sparse_data_parallel of the phase-4 capture at full width
   (timed twice: the first call starts NCCL) and chamfer_data_parallel
   of phase 10's cloud against the GT, then against the plain schedule
   and integrate_frames_cuda (B5's tolerances) and the serial chamfer
   with K3 and with its plain version (one rank's shard is phase 3's
   64-frame shape); (11b) two ranks on cuda:0 in a gloo group
   (distributed/launch.run_ranks, a 600 s hard timeout): dryrun_multichip
   (the dense sharded paths run at its 64x48, 64^3 shapes) before the
   count, as its serial references launch kernels too; then, counted, the
   full-width frame-sharded fusion and extract_meshes_sharded of two
   volumes (the capture and its first half-circle), held to the dry run's
   tolerances (weights and created exact, tsdf <= 1e-4, colour <= 1e-3)
   and to the single path's soups; each rank's local step (its 32 frames
   into a volume created on the earlier ranks' bands) equal to the plain
   schedule. A rank that fails or outlives its timeout fails the phase.
   The mips, K2, the pack, K1 and K3 must have launched (both ranks'
   counts added; K3 in 11a's chamfer). After the count, the mips, K2, the
   pack and K1 against their plain versions at the second rank's shard,
   each shape added to its kernel's record.
12. bench path: otslam_tpu_torch.bench.main("cuda") in this process at
   full width (384 VGA cube frames into a 256^3, 1 cm volume; ICP at 50k
   x 50k, windowed and full scan; perception at K = 64 ticks of 1440 beams
   on a 208^2 map; mesh extraction of the 16-frame volume, dense 256^3,
   block and 8 volumes batched). Its last line must say "complete", hold
   every key of the bench's record, every rate finite, > 0 and under the
   bench's ceilings, at those widths; the mips, K2, the pack, K1, K3, K4
   and K5 must have launched. After the count, each against its plain
   version at the bench's shapes, each shape added to its kernel's
   record: the mips, K2, the pack and K1 on the 384-frame cube schedule
   into the empty 256^3 volume (the fusion metric's call, every frame),
   K3 and K4 on the first ICP iteration's operands (full scan, and the
   windowed scan on the sorted clouds), K5 on the perception workload's
   64 poses x 1440 beams. Prints the bench's record and the phase's
   seconds;
13. production path: MISSION_r04.json's three commands through the port's
   CLI code at full width: cli.mission_runner on the parsed arguments of
   `mission --scenario full --perception-batch 64 --localizer --odom-noise
   0.01 --removed --start 0.5,4.5,0.0 --max-ticks 12000` (VGA, 1440
   beams, the update-pipeline tracker; run once, the kernels are warm),
   then cli.main(["reconstruct", ..., "--auto-origin"]) over its dataset
   and cli.main(["headline", "--scenario", "full", "--objects-dir", ...,
   "--room-frames", "48"]). Gates, tests/test_full_mission.py's checks and
   the report's own: >= 4 missions, >= 3 labels and frames >= labels; the
   largest stable group has >= 4 members, one label orbits a chair
   (centre within 0.7 m, radius < 1.8 m) and one the table site (radius <
   2.3 m); a removed check visited and a removed stable object within 1 m
   of (4, -4); the final pose estimate within 0.25 m of the true pose;
   every Object_* cloud non-empty and finite (a Removed_* cloud may be
   empty: its count is printed); the report holds all 8 objects, every
   scanned one associated with a cloud, and a size reduction >= 90 %. The
   mips, K2, the pack, K1, K3 and K5 must have launched (K4 recorded).
   Prints ticks, ticks/s, missions and labels, each object's frames,
   points and auto-sized volume dims, the report, and the stage seconds.
   After the count, each kernel against its plain version at the phase's
   shapes, each shape added to its kernel's record: the mips, K2, the
   pack and K1 on the capture batch of the largest auto-sized object
   volume (ties: the most frames) into that volume; K3 on the first K3
   call of the mission's
   first localization (its start pose on the saved map) and at the
   headline's largest calls; K5 on the mission's 64-tick perception batch
   with the most distinct poses, on its saved map.

Each path (phases 4, 4b, 6, 8, 9, 10, 11, 12 and 13) counts each kernel's
launches from just before it to just after (`launch_counts`). Every kernel's
record carries two times: `ms`, CUDA events around the wrapper call (its
host work included), and `kernel_ms`, the kernel alone in a
torch.profiler trace (K3/K4: the scan and, for a split launch, the
merge). It carries its bound too: the
larger of the bytes it must move over 3.35 TB/s and its f32 operations
over 67 TFLOP/s (the H100 SXM's published peaks), at this run's shapes and
data; every kernel also a `shapes` list with a record per shape (the log
gives K1's, K3's, K4's and K5's pairs or samples and the instruction floor
of the kernel's unfused arithmetic beside it, K3/K4 their split S; K5's
records hold the kernel alone at each lane count; K1's, K5's and the K2
schedule's records the registers ptxas reports). K2's `ms` times its
wrapper with the mip pass in it, its `kernel_ms` the classify kernel
alone. The line before the last two is
the kernels' JSON record, then the nvidia-smi name/power line; the last
line is {"ok": true, "device": {...}}. JAX and otslam_tpu are never
imported. Where the main path's time goes is the benchmark's traced run
(benchmark/README.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 64
CAPTURE_RADIUS = 1.0      # m, as eval/headline.py's capture circles
CAPTURE_HEIGHT = 0.5      # m
SRC_POINTS = 100_000      # the default surface_samples
GT_POINTS = 50_000        # the eval protocol's GT samples
NN_RADIUS = 0.05          # EvalConfig.icp_threshold
RAY_BEAMS = 1440          # LidarConfig.num_beams
RAY_POSES = 64            # one perception batch of K = 64 ticks
MISSION_TICKS = 300       # the mission CLI's --max-ticks default
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
SM_CLOCK_HZ = 1.98e9          # H100 SXM boost clock
# lane instructions a pair with -fmad=false, counted from csrc/nn.cu's scan
# (its shared-memory loads and loop overhead left out): 8 f32 operations,
# then K4 a compare and two selects a pair, K3 3 fminf, a compare and a
# branch a group of 4 destinations
K3_INSTRUCTIONS = 9.3
K4_INSTRUCTIONS = 11.0
# lane instructions of one IEEE f32 division (div.rn.f32) as nvcc emits it
# for sm_90a: the reciprocal estimate, 5 fused multiply-adds of the
# refinement, the range check, its branch and the reconvergence pair
# around it (the slow path, for operands near the range limits, not
# counted)
DIV_INSTRUCTIONS = 10
# K1, a (voxel, frame) pair, counted from the arithmetic of
# csrc/tsdf_fuse.cu (the SASS issues ~184, see sass_loops): projection 18
# (9 products, 9 sums), in-front test and safe z 2, each pixel coordinate
# 5 + a division (product, sum, rint, clamp, cast), the bounds test 4, the
# address 6, the two loads 2, sdf, validity and the observed tsdf 6, colour
# unpacking 9 (3 fields, 3 casts, 3 products), the weight 2 and the four
# means 3 + a division each
K1_INSTRUCTIONS = 18 + 2 + 2 * 5 + 4 + 6 + 2 + 6 + 9 + 2 + 4 * 3 \
    + 6 * DIV_INSTRUCTIONS
# K5, a sample, counted from the arithmetic of csrc/raycast.cu (the chunk
# bookkeeping of its ballots not counted): step distance 3, the two
# coordinates 2 each, each cell index a difference and a cast + a
# division, the bounds test 4, the address 2, the load and its test 2,
# loop and exit tests 4
K5_INSTRUCTIONS = 3 + 2 * 2 + 2 * 2 + 4 + 2 + 2 + 4 + 2 * DIV_INSTRUCTIONS
F2M_FRAME = N_FRAMES // 2     # phase 3's one-frame K1 shape: this frame ...
F2M_MAX_ACTIVE = 2048         # ... into the volume of the frames before it
MISSION_POSES = 8             # the mission's --perception-batch
PAIR_RADIUS = 0.1             # refine_trajectory's widest ICP threshold
GRID_EXTENT = (-5.6, 5.6, -5.6, 5.6)   # phase 9a's survey grid (m) ...
GRID_RESOLUTION = 0.05                 # ... at the grid mapper's default
BOX_XY = (1.5, 0.5)                    # cardboard_room()'s box
CLASSIFY_POSE = (0.3, 0.3, 0.2)        # phase 9b's scan, near the box
SCAN_POSE = (0.0, 0.0, 0.3)            # 9a's virtual scan of the learned map
DENSE_BOUNDS = (-5.2, 5.2, -5.2, 5.2, -0.1, 2.1)  # 9d's room volume (m) ...
DENSE_VOXEL = 0.02                                 # ... at 2 cm ...
DENSE_TRUNC = 0.08                                 # ... truncated at 8 cm
ONLINE_RING = 16              # phase 10's frame ring capacity ...
ONLINE_BATCH = 4              # ... and micro-batch
ONLINE_MAX_ACTIVE = 2048      # OnlineFusion's per-frame cap (binds here)
ONLINE_SHAPE_BATCH = 8        # the micro-batch held to the plain schedule
SYSTEM_TICKS = 100            # phase 10's OTSLAMSystem scans ...
SYSTEM_SETTLE = 50            # ... the first ones at the mission's start
SYSTEM_STEP = 0.05            # m a tick toward the box after them
RANK_TIMEOUT = 600            # s, phase 11b's two-rank group
BENCH_FRAMES = 384            # phase 12: the bench's fusion frames ...
BENCH_POINTS = 50_000         # ... its ICP clouds' points ...
BENCH_TICKS = 64              # ... and its perception ticks on the card
# phase 13: MISSION_r04.json's first command (its --workdir given here; its
# --repeat 2, a TPU compile warm-up, left out: phases 1-12 have built and
# warmed every kernel) ...
PRODUCTION_MISSION = ("mission", "--scenario", "full", "--perception-batch",
                      "64", "--localizer", "--odom-noise", "0.01",
                      "--removed", "--start", "0.5,4.5,0.0", "--max-ticks",
                      "12000")
PRODUCTION_ROOM_FRAMES = 48   # ... and its headline's --room-frames
TABLE_SITE = (-2.23, -3.31)   # full_room's table and chairs (m), as
CHAIR_SITES = ((-1.71, -2.1), (-2.72, -2.1), (-1.68, -4.7), (-2.84, -4.7))
REMOVED_SITE = (4.0, -4.0)    # tests/test_full_mission.py holds them; the
POSE_TOLERANCE = 0.25         # phantom box; the final estimate's error (m)
FULL_ROOM_OBJECTS = 8


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# each kernel wrapper's C entry point, whose launches kernels/_build.check
# counts as "launches.<entry point>" (utils/profiling.py)
ENTRY_POINTS = {"depth_mips": "otslam_depth_mips",
                "classify_blocks": "otslam_classify",
                "pack_rgb": "otslam_pack_rgb", "fuse_blocks": "otslam_fuse",
                "nn_min": "otslam_nn", "nn_min_windowed": "otslam_nn_window",
                "icp_prep": "otslam_icp_prep", "icp_terms": "otslam_icp_terms",
                "ray_keys": "otslam_raycast"}


def launch_counts(since: dict | None = None) -> dict:
    """Each kernel wrapper's launches in this process, or since the counts
    `since`."""
    from otslam_tpu_torch.utils.profiling import COUNTS
    now = {w: COUNTS["launches." + e] for w, e in ENTRY_POINTS.items()}
    return now if since is None else {w: n - since[w] for w, n in now.items()}


def cuda_ms(fn, reps: int, setup=None, warmup: int = 1) -> float:
    """Mean CUDA-event milliseconds of fn() over `reps` runs; `setup` runs
    before each call, outside the timed window."""
    import torch
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_ms(fn, reps: int, kernels):
    """Device milliseconds per fn() call of the CUDA kernels named in
    `kernels` (one name or several, summed), from a torch.profiler trace of
    `reps` calls after a warm-up: the kernels alone, without the wrapper's
    host time and the other launches that the event timing of cuda_ms
    includes. A trace that holds none of them is taken once more (one
    late in a run came back without the pack's launches, which a trace
    of the same call alone holds), and logged; None when neither does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = (kernels,) if isinstance(kernels, str) else kernels
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and any(
                  f"{k}(" in e.name or f"{k}<" in e.name for k in names)]
        if us:
            return sum(us) * 1e-3 / reps
        log(f"  kernel_ms: trace {attempt + 1} holds no {'/'.join(names)} "
            "launch")
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def instruction_floor_ms(instructions: float, work: float, dev) -> float:
    """`instructions` lane instructions for each of `work` items over
    every lane of the card (its SMs x 128) at the boost clock."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return instructions * work / (sms * 128 * SM_CLOCK_HZ) * 1e3


def ptxas_registers(kernel: str) -> dict:
    """{entry: registers} of every compiled entry whose name holds
    `kernel`, from the build's ptxas -v report (templates demangled by
    cu++filt / c++filt where one is installed); {} when this process
    found the library built."""
    import re

    from otslam_tpu_torch.kernels import _build
    out, entry = {}, None
    for line in _build.BUILD_LOG["output"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and kernel in entry:
            out[entry] = int(m.group(1))
            entry = None
    return demangled(out)


def demangled(entries: dict) -> dict:
    """`entries` keyed by kernel name and template arguments (as
    raycast_kernel<8>) instead of mangled names, where cu++filt or c++filt is
    installed; as they are elsewhere."""
    import re
    import shutil
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt or not entries:
        return entries
    names = subprocess.run([filt], input="\n".join(entries), text=True,
                           capture_output=True).stdout.split("\n")
    out = {}
    for name, value in zip(names, entries.values()):
        name = re.sub(r"\((?:unsigned )?(?:int|bool|long)\)", "", name)
        name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "",
                      name)
        out[name.split("(")[0]] = value
    return out


def sass_loops(kernel: str) -> dict:
    """{entry: (instructions, slow-path calls)} of the innermost loop that
    holds a MUFU (the per-pair or per-sample loop) of every compiled entry
    whose name holds `kernel`, from cuobjdump -sass of the built library;
    {} where cuobjdump is missing. The calls are the divisions' slow paths,
    not taken for ordinary operands, each with its argument moves."""
    import re
    import shutil

    from otslam_tpu_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool) or not _build.BUILD_LOG["path"]:
        return {}
    sass = subprocess.run([tool, "-sass", _build.BUILD_LOG["path"]],
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur:
                funcs[cur] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, ins in funcs.items():
        loops = []
        for addr, text in ins:
            m = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                if any("MUFU" in t for t in body):
                    loops.append((len(body), sum("CALL" in t for t in body)))
        if loops:
            out[name] = min(loops)
    return demangled(out)


def bound(nbytes: float, ops: float) -> dict:
    """The least time for the work: the larger of its bytes over the
    card's memory rate and its f32 operations over its peak rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def cdist_min_ms(src, dst) -> float:
    """CUDA-event ms of torch.cdist(src, dst).min(dim=1), chunked over src
    so each distance block stays near 2 GB: the library call that computes
    K3's function (timed as a yardstick; the port never calls it)."""
    import torch
    rows = max(1, (1 << 29) // dst.shape[0])

    def run():
        for s in range(0, src.shape[0], rows):
            torch.cdist(src[s:s + rows], dst).min(dim=1)
    return cuda_ms(run, 3)


def render_capture(dev):
    """The capture circle as a dataset would hand it over: host arrays in a
    FrameBatch, depth truncated as CaptureDataset.load_object does."""
    import numpy as np
    import torch

    from otslam_tpu_torch.config import CameraConfig
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.pipeline.dataset import FrameBatch
    from otslam_tpu_torch.sim.sensors import look_at_pose, render_rgbd
    from otslam_tpu_torch.sim.world import cardboard_room

    cam = CameraConfig()                      # VGA, fx = fy = 565.6009
    intr = PinholeIntrinsics.from_config(cam)
    scene = cardboard_room()
    center = np.asarray(scene.objects[0].center, np.float64)
    depths, colors, exts, poses = [], [], [], []
    for i in range(N_FRAMES):
        a = 2 * np.pi * i / N_FRAMES
        eye = np.array([center[0] + CAPTURE_RADIUS * np.cos(a),
                        center[1] + CAPTURE_RADIUS * np.sin(a),
                        CAPTURE_HEIGHT])
        pose = look_at_pose(eye, center)
        d, c = render_rgbd(scene, pose, intr, far=cam.depth_max, device=dev)
        d = torch.where((d > 0) & (d <= cam.depth_trunc), d, 0.0)
        depths.append(d)
        colors.append(c)
        exts.append(np.linalg.inv(pose).astype(np.float32))
        poses.append(pose)
    batch = FrameBatch(torch.stack(depths).cpu().numpy(),
                       torch.stack(colors).cpu().numpy(), np.stack(exts),
                       np.stack(poses), [f"Object_0_{i + 1}.jpg"
                                         for i in range(N_FRAMES)])
    return batch, intr, scene


def pass_record(label, kernel, plain, names, nbytes, ops, reps):
    """Times of one call of a K2-schedule kernel at one shape: events
    around the wrapper, the kernels `names` alone from a trace, the plain
    version, and the bound of `nbytes` and `ops` f32 operations."""
    return {"shape": label, "max_abs_err": 0.0, "ms": cuda_ms(kernel, reps),
            "kernel_ms": kernel_ms(kernel, reps, names),
            "plain_ms": cuda_ms(plain, reps), **bound(nbytes, ops),
            "library_ms": None}


def k2_shape(label, meta, d, c, e, intr, reps, shapes):
    """The fusion schedule's passes before K1 at one shape, each against
    its plain version with torch.equal: the depth-mip pass (table and
    global bounds), K2's classification (torch.bool band and visible) and
    the colour pack; their records are appended to shapes["mips"],
    shapes["k2"] and shapes["pack"]. Returns the plain (band, visible)."""
    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    table, gb, th, tw = tc.depth_mips(d)
    ptable, pgb, pth, ptw = tc.depth_mips_torch(d)
    band, vis = tc.classify_blocks(meta, d, e, intr)
    band_p, vis_p = tc.classify_blocks_torch(meta, d, e, intr)
    cpk = tc.pack_rgb(c)
    cpk_p = tc.pack_rgb_torch(c)
    torch.cuda.synchronize()
    check((th, tw) == (pth, ptw) and bool(torch.equal(table, ptable))
          and bool(torch.equal(gb, pgb)),
          f"the mip pass differs from its plain version at {label} "
          f"({int((table != ptable).sum())} table values, "
          f"{int((gb != pgb).sum())} bounds)")
    check(band.dtype == vis.dtype == torch.bool
          and bool(torch.equal(band, band_p))
          and bool(torch.equal(vis, vis_p)),
          f"K2 differs from its plain version at {label} on "
          f"{int((band != band_p).sum() + (vis != vis_p).sum())} pairs")
    check(bool(torch.equal(cpk, cpk_p)), f"the colour pack differs from "
          f"its plain version at {label} on {int((cpk != cpk_p).sum())} "
          "pixels")
    n, nb = band.shape
    # mips: the frames read once, the table and bounds written once;
    # about 4 f32 operations a pixel (its test, select, min and max)
    shapes["mips"].append(pass_record(
        label, lambda: tc.depth_mips(d), lambda: tc.depth_mips_torch(d),
        ("mips_tile_kernel", "mips_finish_kernel"),
        d.numel() * 4 + table.numel() * 4 + gb.numel() * 4,
        4.0 * d.numel(), reps))
    # K2 reads the packed (th*tw, 8) f32 mip table, the two bounds and
    # the extrinsic of each frame and writes band and visible (a byte
    # each); the block coordinates come from the thread index. About 55
    # f32 operations a (frame, block) pair (block centre, projection,
    # pixel slack, frustum and depth-bound tests). Events time the
    # wrapper with the mip pass in it, the trace the kernel alone
    shapes["k2"].append(pass_record(
        label, lambda: tc.classify_blocks(meta, d, e, intr),
        lambda: tc.classify_blocks_torch(meta, d, e, intr),
        "classify_kernel", table.numel() * 4 + gb.numel() * 4
        + e.numel() * 4 + n * nb * 2, 55.0 * n * nb, reps))
    # pack: 12 bytes read and 4 written a pixel; about 10 integer and
    # f32 operations a pixel (3 clamps of 2, 3 casts, 2 shifts, 2 ors)
    shapes["pack"].append(pass_record(
        label, lambda: tc.pack_rgb(c), lambda: tc.pack_rgb_torch(c),
        "pack_rgb_kernel", c.numel() * 4 + cpk.numel() * 4,
        10.0 * cpk.numel(), reps))
    log(f"  {label}: {n} frames x {nb} blocks, band {int(band_p.sum())} "
        f"visible {int(vis_p.sum())}, mip table {th}x{tw} tiles; mips, "
        f"K2 and pack equal to their plain versions")
    for key, name in (("mips", "mip pass"), ("k2", "K2 (wrapper incl. "
                      "mips; kernel alone)"), ("pack", "colour pack")):
        r = shapes[key][-1]
        log(f"    {name}: events {r['ms']:.4f} ms, kernel alone "
            f"{fmt_ms(r['kernel_ms'])}, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return band_p, vis_p


def phase_k2(meta, depths, colors, exts, intr):
    """k2_shape at the reconstruction's 64-frame batch and at f2m's one
    frame (F2M_FRAME). Returns the 64-frame (band, visible) and the three
    records (the 64-frame shape's times on top, every shape in
    `shapes`)."""
    shapes = {"mips": [], "k2": [], "pack": []}
    out = k2_shape(f"reconstruct {N_FRAMES} frames", meta, depths, colors,
                   exts, intr, 10, shapes)
    f = slice(F2M_FRAME, F2M_FRAME + 1)
    k2_shape(f"f2m one frame ({F2M_FRAME})", meta, depths[f], colors[f],
             exts[f], intr, 20, shapes)
    records = {}
    for key, kernel in (("mips", "mips_"), ("k2", "classify_kernel"),
                        ("pack", "pack_rgb_kernel")):
        regs = ptxas_registers(kernel)
        records[key] = {**shapes[key][0], "registers": regs,
                        "shapes": shapes[key]}
        log(f"  {key}: registers {regs}")
    log("K2 schedule: the mip pass, K2 and the colour pack bit-identical to "
        "their plain versions at both shapes")
    return (*out, records)


def k1_shape(label, base, ids, ptr, frames, depths, colors, exts, intr,
             reps=5):
    """K1 at one shape: the work list (ids, ptr, frames) fused into copies
    of the volume `base` by the kernel and by its plain version, which must
    agree bit for bit (tsdf, weight, colour); then its times, each call on a
    fresh copy of `base`, and its bound. The log adds the instruction
    floor."""
    import copy

    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    ka, pa, ref = (copy.deepcopy(base) for _ in range(3))
    cpk = tc.pack_rgb(colors)

    def reset():
        for v in (ka, pa):
            v.tsdf.copy_(base.tsdf)
            v.weight.copy_(base.weight)
            v.color.copy_(base.color)

    def fuse():
        tc.fuse_blocks(ka, ids, ptr, frames, depths, cpk, exts, intr)

    tc.fuse_blocks_torch(ref, ids, ptr, frames, depths, cpk, exts, intr)
    fuse()
    torch.cuda.synchronize()
    diff = {k: int((getattr(ka, k) != getattr(ref, k)).sum())
            for k in ("tsdf", "weight", "color")}
    check(not any(diff.values()), f"K1 differs from its plain version at "
          f"{label} (voxels per field {diff})")
    observed = int((ref.weight > 0).sum())
    del ref
    ms = cuda_ms(fuse, reps, setup=reset)
    plain_ms = cuda_ms(lambda: tc.fuse_blocks_torch(
        pa, ids, ptr, frames, depths, cpk, exts, intr), 3, setup=reset)
    dev_ms = kernel_ms(lambda: (reset(), fuse()), reps, "fuse_kernel")
    # the listed blocks' 5 floats a voxel read and written once, the frames'
    # depth and packed colour read once; about 55 f32 operations a (voxel,
    # frame) pair (projection, rounding, sdf, four running means)
    pairs = frames.shape[0]
    b = bound(ids.shape[0] * 512 * 5 * 4 * 2 + depths.numel() * 8
              + exts.numel() * 4 + (ids.numel() + ptr.numel() + pairs) * 4,
              55.0 * pairs * 512)
    floor = instruction_floor_ms(K1_INSTRUCTIONS, pairs * 512.0,
                                 depths.device)
    log(f"  {label}: {ids.shape[0]} blocks, {pairs} (block, frame) pairs, "
        f"observed voxels {observed}, tsdf, weight and colour equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, kernel alone "
        f"{fmt_ms(dev_ms)} (V={tc.VOXELS_PER_THREAD}), bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}), instruction floor at "
        f"{K1_INSTRUCTIONS} a voxel pair {floor:.4f} ms")
    return {"shape": label, "max_abs_err": 0.0, "ms": ms,
            "kernel_ms": dev_ms, "plain_ms": plain_ms, **b,
            "library_ms": None, "blocks": int(ids.shape[0]),
            "pairs": int(pairs)}


def f2m_volume(vol_cfg, depths, colors, exts, intr):
    """The f2m shape's volume: frames 0 .. F2M_FRAME - 1 fused one at a
    time with max_active = F2M_MAX_ACTIVE, as refine_trajectory_f2m fuses
    each tracked frame (here at the capture's true poses)."""
    from otslam_tpu_torch.kernels.tsdf_block import (integrate_frames_sparse,
                                                     make_block_volume)
    vol = make_block_volume(vol_cfg, depths.device)
    for i in range(F2M_FRAME):
        integrate_frames_sparse(vol, depths[i:i + 1], colors[i:i + 1],
                                exts[i:i + 1], intr,
                                max_active=F2M_MAX_ACTIVE)
    return vol


def phase_k1(vol_cfg, band, vis, depths, colors, exts, intr):
    """K1 at the paths' two shapes: the reconstruction's 64-frame batch into
    an empty volume, and f2m's one frame into the volume of the frames
    before it, capped at max_active blocks as integrate_frames_cuda caps
    it."""
    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    empty = make_block_volume(vol_cfg, depths.device)
    nb = empty.num_blocks
    _, active = tc.created_and_active(band, vis, empty.created[:nb])
    shapes = [k1_shape(f"reconstruct {N_FRAMES} frames", empty,
                       *tc.active_worklist(active), depths, colors, exts,
                       intr)]
    del empty, active
    f = slice(F2M_FRAME, F2M_FRAME + 1)
    vol = f2m_volume(vol_cfg, depths, colors, exts, intr)
    band1, vis1 = tc.classify_blocks(vol.meta, depths[f], exts[f], intr)
    _, active = tc.created_and_active(band1, vis1, vol.created[:nb])
    capped = active & (torch.cumsum(active, dim=1) <= F2M_MAX_ACTIVE)
    log(f"  f2m frame {F2M_FRAME}: {int(active.sum())} active blocks, "
        f"{int(capped.sum())} after the max_active = {F2M_MAX_ACTIVE} cap, "
        f"{int(vol.created.sum())} blocks created before it")
    shapes.append(k1_shape(f"f2m one frame, max_active {F2M_MAX_ACTIVE}",
                           vol, *tc.active_worklist(capped), depths[f],
                           colors[f], exts[f], intr, reps=20))
    regs = ptxas_registers("fuse_kernel")
    loops = sass_loops("fuse_kernel")
    log(f"K1 fuse: bit-identical to its plain version at both shapes; "
        f"registers {regs}; SASS frame loop (instructions, slow-path "
        f"calls) {loops}")
    return {**shapes[0], "registers": regs, "sass_loop": loops,
            "shapes": shapes}


def nn_record(label, kernel, plain, names, pairs, nbytes, instructions,
              splits, dev, cdist=None, reps=10):
    """Times of one NN kernel call at one shape: events around the wrapper,
    the kernel alone (its scan and merge launches) from a trace, the plain
    version, torch.cdist().min() where `cdist` gives its (src, dst), and the
    bound. The log adds the split S, the pairs and the instruction floor:
    `instructions` lane instructions a pair over every lane of the card at
    its boost clock."""
    import torch
    ms = cuda_ms(kernel, reps)
    dev_ms = kernel_ms(kernel, reps, names)
    plain_ms = cuda_ms(plain, 3)
    lib_ms = cdist_min_ms(*cdist) if cdist is not None else None
    # 8 f32 operations a pair (3 differences, 3 squares, 2 sums)
    b = bound(nbytes, 8.0 * pairs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor_ms = instructions * pairs / (sms * 128 * SM_CLOCK_HZ) * 1e3
    log(f"  {label}: split S {splits}, pairs {pairs:.0f}, kernel {ms:.4f} "
        f"ms, kernel alone {fmt_ms(dev_ms)}, plain {plain_ms:.4f} ms, "
        f"torch.cdist().min() {fmt_ms(lib_ms)}, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}), instruction floor at "
        f"{instructions} a pair {floor_ms:.4f} ms")
    return {"shape": label, "max_abs_err": 0.0, "ms": ms,
            "kernel_ms": dev_ms, "plain_ms": plain_ms, **b,
            "library_ms": lib_ms}


def localizer_case(dev):
    """Phase 6's scan localization: a ScanLocalizer on the cardboard room's
    0.05 m grid, the 1440-beam scan from the true pose, and a prior off by
    (0.08, -0.06) m and 0.07 rad. Returns (loc, scan, angles, prior,
    true)."""
    import numpy as np

    from otslam_tpu_torch.config import LidarConfig
    from otslam_tpu_torch.mapping.localize import ScanLocalizer
    from otslam_tpu_torch.sim.sensors import render_lidar
    from otslam_tpu_torch.sim.world import cardboard_room
    lidar = LidarConfig()
    scene = cardboard_room()
    angles = np.linspace(0, 2 * np.pi, lidar.num_beams,
                         endpoint=False).astype(np.float32)
    true = (0.6, -1.1, 0.8)
    scan = render_lidar(scene, *true, angles, lidar.range_min,
                        lidar.range_max, device=dev)
    prior = (true[0] + 0.08, true[1] - 0.06, true[2] + 0.07)
    loc = ScanLocalizer(scene.occupancy_grid(0.05), device=dev)
    return loc, scan, angles, prior, true


@contextlib.contextmanager
def k3_calls(keep):
    """While the block runs, every nn_min call goes ahead and keep(src,
    dst, dst_mask) sees its operands first."""
    from otslam_tpu_torch.kernels import nn
    real = nn.nn_min

    def record(src, dst, dst_mask):
        keep(src, dst, dst_mask)
        return real(src, dst, dst_mask)

    nn.nn_min = record
    try:
        yield
    finally:
        nn.nn_min = real


def k3_shape(label, src, dst, mask, dev):
    """K3 against its plain version (bit-identical d^2 and index) at one
    shape, then its record (nn_record)."""
    import torch

    from otslam_tpu_torch.kernels import nn
    d_k, i_k = nn.nn_min(src, dst, mask)
    d_p, i_p = nn.nn_min_torch(src, dst, mask)
    torch.cuda.synchronize()
    check(bool(torch.equal(d_k, d_p)) and bool(torch.equal(i_k, i_p)),
          f"K3 differs from its plain version at {label} on "
          f"{int(((d_k != d_p) | (i_k != i_p)).sum())} rows")
    n, m = src.shape[0], dst.shape[0]
    return nn_record(
        label, lambda: nn.nn_min(src, dst, mask),
        lambda: nn.nn_min_torch(src, dst, mask),
        ("nn_kernel", "nn_merge_kernel"), float(n) * m,
        n * 12 + m * 13 + n * 12, K3_INSTRUCTIONS,
        nn.split_count(n, m, nn.sm_count(dev)), dev, cdist=(src, dst))


def phase_k3(dev):
    """k3_shape at the paths' shapes: the eval's 100k x 50k and 50k x 100k
    chamfer directions and the localizer's 1440-beam scan against its grid
    cloud (the operands of the first K3 call of a real
    ScanLocalizer.localize)."""
    import numpy as np
    import torch

    from otslam_tpu_torch.eval.scenarios import scenario_gt
    gt = torch.as_tensor(scenario_gt("cardboard", GT_POINTS), device=dev)
    rng = np.random.default_rng(1)
    src_np = scenario_gt("cardboard", SRC_POINTS, seed=1) + rng.normal(
        0, 0.004, (SRC_POINTS, 3)).astype(np.float32)
    cloud = torch.as_tensor(src_np, device=dev)
    ones = torch.ones(max(GT_POINTS, SRC_POINTS), dtype=torch.bool,
                      device=dev)
    loc, scan, angles, prior, _ = localizer_case(dev)
    seen = []
    with k3_calls(lambda *ops: seen.append([x.clone() for x in ops])):
        loc.localize(scan, angles, prior)
    check(bool(seen), "the localizer made no K3 call")
    lsrc, ldst, lmask = seen[0]
    shapes = [k3_shape(label, src, dst, mask, dev)
              for label, src, dst, mask in (
                  (f"eval {SRC_POINTS} x {GT_POINTS}", cloud, gt,
                   ones[:GT_POINTS]),
                  (f"eval {GT_POINTS} x {SRC_POINTS}", gt, cloud,
                   ones[:SRC_POINTS]),
                  (f"localizer {lsrc.shape[0]} x {ldst.shape[0]}", lsrc,
                   ldst, lmask))]
    log("K3 nn: bit-identical to its plain version (d^2 and index) at "
        "every shape")
    return {**shapes[0], "shapes": shapes}


def pair_icp_clouds(batch, intr, dev):
    """K4's operands at the pair-ICP shape: frames 1 and 0 of the capture
    through refine._frame_points_normals, the source moved by the prior and
    the window sized as refine_trajectory does, both sorted as ICP sorts
    them, at the widest annealing threshold."""
    import numpy as np
    import torch

    from otslam_tpu_torch.core.se3 import invert_se3
    from otslam_tpu_torch.kernels import nn
    from otslam_tpu_torch.kernels.icp import _sorted_for_window
    from otslam_tpu_torch.pipeline import refine
    depths = torch.as_tensor(batch.depths[:2], device=dev)
    prev_pts, _, prev_valid = refine._frame_points_normals(depths[0], intr)
    cur_pts, _, cur_valid = refine._frame_points_normals(depths[1], intr)
    window, axis = refine._pair_nn_window(cur_pts, prev_pts, PAIR_RADIUS)
    ext = np.asarray(batch.extrinsics, np.float64)
    src = refine._moved(cur_pts, ext[0] @ invert_se3(ext[1]))
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    src, dst, _, dmask, _ = _sorted_for_window(src, prev_pts, cur_valid,
                                               prev_valid, eye, axis)
    check(window * nn.DST_CHUNK < dst.shape[0], f"pair-ICP window {window} "
          f"covers the {dst.shape[0]}-point cloud: ICP would take K3")
    return src, dst, dmask, axis, window


def pair_icp_loops(batch, intr, dev):
    """One pair's annealed ICP (frames 1 onto 0, as refine_trajectory
    prepares it) with the fused kernels and on the host loop: the two
    bit-identical, then each one's wall milliseconds to a synchronize, and
    the fused loop's kernels' and K4's device milliseconds."""
    import time

    import numpy as np
    import torch

    from otslam_tpu_torch.core.se3 import invert_se3
    from otslam_tpu_torch.pipeline import refine
    depths = torch.as_tensor(batch.depths[:2], device=dev)
    pp, pn, pv = refine._frame_points_normals(depths[0], intr)
    cp, _, cv = refine._frame_points_normals(depths[1], intr)
    window = refine._pair_nn_window(cp, pp, PAIR_RADIUS)
    ext = np.asarray(batch.extrinsics, np.float64)
    src = refine._moved(cp, ext[0] @ invert_se3(ext[1]))
    thresholds = (0.1, 0.05, 0.02)
    args = (src, pp, pn, pv, cv, thresholds, window)
    loops = {"fused": lambda: refine._annealed_icp(*args),
             "host": lambda: refine._annealed_icp_plain(*args)}
    got = {k: fn() for k, fn in loops.items()}
    torch.cuda.synchronize()
    a, b = got["fused"], got["host"]
    gap = float((a.transformation - b.transformation).abs().max())
    check(all(bool(torch.equal(x, y)) for x, y in zip(a[:3], b[:3]))
          and a.iterations == b.iterations,
          f"pair ICP: the fused kernels' transform is {gap} off the host "
          f"loop's, fitness {float(a.fitness)} against {float(b.fitness)}")
    wall = {}
    for k, fn in loops.items():
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        wall[k] = (time.perf_counter() - t0) * 100.0
    fused = ("icp_prep_kernel", "icp_terms_kernel", "icp_eval_kernel",
             "icp_rotation_kernel", "icp_dt_kernel")
    kernels = {"fused": kernel_ms(loops["fused"], 5, fused),
               "K4": kernel_ms(loops["fused"], 5,
                               ("nn_window_kernel", "nn_merge_kernel"))}
    log(f"  pair ICP {src.shape[0]} x {pp.shape[0]}, window {window}: "
        f"{a.iterations} iterations in the last stage, fitness "
        f"{float(a.fitness):.6f}, bit-identical to the host loop; wall "
        f"fused {wall['fused']:.4f} ms, host loop {wall['host']:.4f} ms; "
        f"device time of the fused kernels {fmt_ms(kernels['fused'])}, "
        f"of K4 {fmt_ms(kernels['K4'])}")
    return {"wall_ms": wall, "kernel_ms": kernels}


def k4_shape(nn, label, src, dst, mask, radius, axis, dev):
    """K4 at one shape: bit-identical to its plain version, equal to K3 on
    every in-radius row, >= the radius elsewhere; then its times."""
    import torch
    dstp, dmaskp, c0, c1 = nn.window_ranges(src, dst, mask, radius, axis)
    d_k, i_k = nn.nn_min_windowed(src, dstp, dmaskp, c0, c1)
    d_p, i_p = nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1)
    d_3, i_3 = nn.nn_min(src, dst, mask)
    torch.cuda.synchronize()
    check(bool(torch.equal(d_k, d_p)) and bool(torch.equal(i_k, i_p)),
          f"K4 differs from its plain version at {label} on "
          f"{int(((d_k != d_p) | (i_k != i_p)).sum())} rows")
    inl = d_3.sqrt() < radius
    check(bool(torch.equal(d_k[inl], d_3[inl]))
          and bool(torch.equal(i_k[inl], i_3[inl])),
          f"K4 differs from K3 at {label} on rows with a neighbour within "
          "the radius")
    check(bool((d_k[~inl].sqrt() >= radius).all()),
          f"K4 gives d < radius at {label} on a row whose nearest "
          "neighbour is farther")
    n, mp = src.shape[0], dstp.shape[0]
    # the pairs this data needs: each 256-row tile against its chunk range
    tile_rows = torch.full_like(c0, nn.SRC_TILE)
    tile_rows[-1] = n - nn.SRC_TILE * (c0.numel() - 1)
    lo = c0.clamp(min=0) * nn.DST_CHUNK
    hi = (c1 * nn.DST_CHUNK).clamp(max=mp)
    pairs = float((tile_rows * (hi - lo).clamp(min=0)).sum())
    log(f"  {label}: radius {radius}, axis {axis}, mean chunks scanned per "
        f"tile {float((c1 - c0).clamp(min=0).float().mean()):.2f} of "
        f"{mp // nn.DST_CHUNK}, in-radius rows {int(inl.sum())} of {n}")
    return nn_record(
        label, lambda: nn.nn_min_windowed(src, dstp, dmaskp, c0, c1),
        lambda: nn.nn_min_windowed_torch(src, dstp, dmaskp, c0, c1),
        ("nn_window_kernel", "nn_merge_kernel"), pairs,
        n * 12 + mp * 13 + c0.numel() * 8 + n * 12, K4_INSTRUCTIONS,
        nn.split_count(n, mp, nn.sm_count(dev)), dev, cdist=(src, dst))


def phase_k4(dev, batch, intr):
    """K4 at the eval's GT alignment shape (50k x 50k, radius 0.05 m) and at
    the pair-ICP shape."""
    import numpy as np
    import torch

    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.kernels import nn
    gt_np = scenario_gt("cardboard", GT_POINTS)
    rng = np.random.default_rng(1)
    src_np = scenario_gt("cardboard", GT_POINTS, seed=1) + rng.normal(
        0, 0.004, (GT_POINTS, 3)).astype(np.float32)
    window, axis = nn.auto_nn_window(src_np, gt_np, NN_RADIUS)
    nchunks = -(-GT_POINTS // nn.DST_CHUNK)
    check(window < nchunks, f"K4 window {window} covers all {nchunks} "
          "chunks: the workload would not exercise the windowed scan")
    # both sorted on the widest axis, as icp._sorted_for_window does
    gt = torch.as_tensor(gt_np, device=dev)
    src = torch.as_tensor(src_np, device=dev)
    gt = gt[torch.argsort(gt[:, axis], stable=True)]
    src = src[torch.argsort(src[:, axis], stable=True)]
    mask = torch.ones(GT_POINTS, dtype=torch.bool, device=dev)
    shapes = [k4_shape(nn, f"eval {GT_POINTS} x {GT_POINTS}", src, gt, mask,
                       NN_RADIUS, axis, dev)]
    wrapper_ms = cuda_ms(lambda: nn.nn_distance_radius(
        src, gt, NN_RADIUS, window_chunks=window, axis=axis), 10)
    psrc, pdst, pmask, paxis, pwin = pair_icp_clouds(batch, intr, dev)
    shapes.append(k4_shape(
        nn, f"pair ICP {psrc.shape[0]} x {pdst.shape[0]}", psrc, pdst, pmask,
        PAIR_RADIUS, paxis, dev))
    log(f"K4 windowed nn: bit-identical to its plain version at every "
        f"shape, and to K3 on every in-radius row; nn_distance_radius "
        f"(ranges + K4 + recompute) at 50k x 50k {wrapper_ms:.4f} ms; "
        f"pair-ICP window {pwin} chunks")
    pair = pair_icp_loops(batch, intr, dev)
    return {**shapes[0], "shapes": shapes, "pair_icp": pair}


def phase_reconstruct(batch, intr, cfg, dev, gt):
    """The main path (phase 4): reconstruct_frames with `cfg` and an auto
    volume, then write_ply -> read_ply -> evaluate_map against `gt`. Fails
    on an empty or non-finite cloud or an accuracy >= 1 cm."""
    import numpy as np
    import torch

    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.pipeline.reconstruct import reconstruct_frames
    stages: dict = {}
    t0 = time.perf_counter()
    res = reconstruct_frames(batch, intr, cfg, backend="pallas",
                             auto_origin=True, device=dev, seed=0,
                             timings=stages)
    log(f"main path counts {stages.pop('trace')['counts']}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "Object_0.ply")
        t1 = time.perf_counter()
        tio.write_ply(path, res.points, colors=res.colors,
                      normals=res.normals)
        cloud = tio.read_ply(path)["points"]
        stages["ply"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    metrics = evaluate_map(cloud, gt, device=dev)
    torch.cuda.synchronize()
    stages["eval"] = time.perf_counter() - t1
    total = time.perf_counter() - t0
    log("main path stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f", total {total:.4f}")
    log(f"main path: raw surface points {res.raw_surface_count}, cloud "
        f"{len(cloud)} points, accuracy {metrics.accuracy_cm:.4f} cm, "
        f"completeness {metrics.completeness_cm:.4f} cm")
    check(cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0,
          f"cloud shape {cloud.shape}")
    check(bool(np.isfinite(cloud).all()), "cloud has non-finite points")
    check(metrics.accuracy_cm < 1.0,
          f"accuracy {metrics.accuracy_cm} cm >= 1 cm")


def phase_mesh_path(batch, intr, cfg, dev, gt):
    """The main path with mesh output (phase 4b): reconstruct_frames with
    output="mesh" and an auto volume, then write_ply(faces=...) ->
    read_ply -> evaluate_map of the vertices at z >= z_filter_threshold
    against `gt`. Fails on faces out of range, a non-finite value or an
    accuracy >= 1 cm. Returns (triangles, welded vertices, stage
    seconds)."""
    import numpy as np
    import torch

    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.pipeline.reconstruct import reconstruct_frames
    stages: dict = {}
    t0 = time.perf_counter()
    res = reconstruct_frames(batch, intr, cfg, backend="pallas",
                             auto_origin=True, output="mesh", device=dev,
                             timings=stages)
    log(f"mesh path counts {stages.pop('trace')['counts']}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "Object_0.ply")
        t1 = time.perf_counter()
        tio.write_ply(path, res.points, colors=res.colors,
                      normals=res.normals, faces=res.faces)
        mesh = tio.read_ply(path)
        stages["ply"] = time.perf_counter() - t1
    verts, faces = mesh["points"], mesh.get("faces")
    check(faces is not None and faces.ndim == 2 and faces.shape[1] == 3
          and len(faces) > 0, "the mesh PLY holds no faces")
    check(int(faces.min()) >= 0 and int(faces.max()) < len(verts),
          f"faces index [{faces.min()}, {faces.max()}] of {len(verts)} "
          "vertices")
    check(all(bool(np.isfinite(mesh[k]).all())
              for k in ("points", "colors", "normals")),
          "the mesh has non-finite values")
    above = verts[verts[:, 2] >= cfg.z_filter_threshold]
    t1 = time.perf_counter()
    metrics = evaluate_map(above, gt, device=dev)
    torch.cuda.synchronize()
    stages["eval"] = time.perf_counter() - t1
    total = time.perf_counter() - t0
    log("mesh path stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f", total {total:.4f}")
    log(f"mesh path: {len(faces)} faces, {len(verts)} welded vertices "
        f"({len(above)} at z >= {cfg.z_filter_threshold}), accuracy "
        f"{metrics.accuracy_cm:.4f} cm, completeness "
        f"{metrics.completeness_cm:.4f} cm")
    check(metrics.accuracy_cm < 1.0,
          f"mesh accuracy {metrics.accuracy_cm} cm >= 1 cm")
    return len(faces), len(verts), stages


def seconds(fn, reps: int = 3):
    """Mean host seconds of fn() ending in a device sync, after a
    warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def phase_mesh_checks(batch, intr, cfg, vol_cfg, dev, card):
    """Phase 4b's checks on the fused block volume of the capture: the
    block soup on the card against the CPU, the dense 256^3 path against
    the block path as a triangle set, the batched path against the single
    one, the card's weld against numpy's; then the extraction and weld
    times."""
    import numpy as np
    import torch

    from otslam_tpu_torch.kernels import marching as mt
    from otslam_tpu_torch.kernels.tsdf_block import block_to_dense
    from otslam_tpu_torch.pipeline.reconstruct import fuse_frames
    vol = fuse_frames(batch.depths, batch.colors, batch.extrinsics, intr,
                      dataclasses.replace(cfg, tsdf=vol_cfg), "pallas",
                      densify=False, device=dev)
    mb, mc = mt.auto_mesh_block_config(vol)
    soup = mt.extract_mesh_soup_block(vol, mb, mc)
    cpu = dataclasses.replace(vol, **{k: getattr(vol, k).cpu() for k in (
        "tsdf", "weight", "color", "created")})
    cpu_soup = mt.extract_mesh_soup_block(cpu, mb, mc)
    torch.cuda.synchronize()
    mask = soup[2].cpu()
    check(bool(torch.equal(mask, cpu_soup[2])),
          f"the card's soup mask differs from the CPU's on "
          f"{int((mask != cpu_soup[2]).sum())} triangles")
    err = max(float((soup[k].cpu()[mask] - cpu_soup[k][mask]).abs().max())
              for k in (0, 1))
    check(err <= 1e-6, f"the card's soup differs from the CPU's by {err}")
    n_tri = int(mask.sum())
    log(f"mesh soup: {n_tri} triangles of {mc * 12} rows (max_blocks {mb}, "
        f"max_cells {mc}, {int(vol.created.sum())} created blocks); card "
        f"and CPU agree (mask equal, max |diff| {err:.3g})")

    def tris(s):
        m = s[2]
        flat = s[0][m].cpu().numpy()
        col = s[1][m].cpu().numpy()
        order = np.lexsort(flat.T[::-1])
        return flat[order], col[order]
    dense = block_to_dense(vol)
    dmc = mt.auto_max_cells(dense)
    d_soup = mt.extract_mesh_soup(dense, dmc)
    (dv, dc), (bv, bc) = tris(d_soup), tris(soup)
    check(dv.shape == bv.shape and bool((dv == bv).all())
          and bool((dc == bc).all()),
          f"the dense {vol_cfg.dims} path gives {len(dv)} triangles, not the "
          f"block path's {len(bv)} as a set")
    log(f"mesh dense {tuple(dense.dims)}: the block path's {len(dv)} "
        f"triangles as a set (max_cells {dmc})")

    other = dataclasses.replace(
        vol, tsdf=vol.tsdf * 0.7,
        origin=tuple(o + d for o, d in zip(vol.origin, (0.08, -0.04, 0.02))))
    # the shared capacities: the max of the two volumes' auto configs
    bmb, bmc = mt._validate_batch([vol, other])
    b_verts, b_cols, b_masks = mt.extract_meshes_block([vol, other], bmb,
                                                       bmc)
    for b, v in enumerate((vol, other)):
        sv, sc, sm = mt.extract_mesh_soup_block(v, bmb, bmc)
        check(bool(torch.equal(b_masks[b], sm))
              and bool(torch.equal(b_verts[b][sm], sv[sm]))
              and bool(torch.equal(b_cols[b][sm], sc[sm])),
              f"extract_meshes_block differs from the single path on "
              f"volume {b}")
    log("mesh batched: extract_meshes_block equals the single path on two "
        "volumes with different origins")

    block_s = seconds(lambda: mt.extract_mesh_soup_block(
        vol, *mt.auto_mesh_block_config(vol)))
    dense_s = seconds(lambda: mt.extract_mesh_soup(dense,
                                                   mt.auto_max_cells(dense)))
    # the card's weld against numpy's of the same rows
    rows = soup[0][soup[2]].reshape(-1, 3)
    v, c = rows.cpu().numpy(), soup[1][soup[2]].reshape(-1, 3).cpu().numpy()
    check(np.array_equal(mt._weld_keys(rows).cpu().numpy(),
                         np.round(v / 1e-5).astype(np.int64)),
          "the card's weld keys differ from numpy's")
    t0 = time.perf_counter()
    want = mt._weld(v, c)
    numpy_s = time.perf_counter() - t0
    extent = mt._extent(vol)
    welded = mt._weld_mesh(*soup, extent=extent)
    for k, name in enumerate(("vertices", "faces", "colours")):
        check(welded[k].shape == want[k].shape
              and np.array_equal(welded[k], want[k]),
              f"the card's welded {name} differ from numpy's")
    nerr = float(np.abs(welded[3] - want[3]).max(initial=0.0))
    check(nerr <= 1e-5, f"the card's weld normals differ by {nerr}")
    weld_s = seconds(lambda: mt._weld_mesh(*soup, extent=extent))
    log(f"mesh times ({card}): extraction, block path with its auto "
        f"config {block_s:.4f} s; dense {tuple(dense.dims)} path with its "
        f"auto capacity {dense_s:.4f} s; weld on the card {weld_s:.4f} s, "
        f"numpy's {numpy_s:.4f} s (equal vertices, faces and colours, "
        f"normals within {nerr:.3g}); {n_tri} triangles, "
        f"{len(welded[0])} welded vertices, {len(welded[1])} faces")


def drift(exts, seed: int = 0, t_sigma: float = 0.012,
          r_sigma: float = 0.008):
    """Compounding odometry drift (tests/test_refine.py's perturb): per-step
    errors compound along the trajectory, frame 0 exact."""
    import numpy as np

    from otslam_tpu_torch.core.se3 import euler_xyz_to_matrix, se3
    rng = np.random.default_rng(seed)
    out = [exts[0]]
    acc = np.eye(4)
    for e in exts[1:]:
        dR = euler_xyz_to_matrix(*rng.normal(0, r_sigma, 3))
        dt = rng.normal(0, t_sigma, 3)
        acc = se3(dR, dt) @ acc
        out.append((acc @ e).astype(np.float32))
    return np.stack(out)


def phase_registration(batch, intr, cfg, dev, gt):
    """The registration path (phase 6): refine="icp" and "pgo" on the
    drifted capture, each through PLY and the ICP-aligned eval, then scan
    localization. Fails on a non-finite or missing result, a pgo that does
    not lower the drifted translation RMSE, or a localization off by
    >= 4 cm / 0.02 rad."""
    import numpy as np
    import torch

    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.pipeline.reconstruct import reconstruct_frames
    from otslam_tpu_torch.pipeline.refine import trajectory_error

    drifted = dataclasses.replace(batch,
                                  extrinsics=drift(batch.extrinsics))
    t_odo, r_odo = trajectory_error(drifted.extrinsics, batch.extrinsics)
    log(f"registration: drifted odometry RMSE {t_odo:.6f} m, "
        f"{r_odo:.6f} rad")
    errors = {}
    for refine in ("icp", "pgo"):
        stages: dict = {}
        t0 = time.perf_counter()
        res = reconstruct_frames(drifted, intr, cfg, backend="pallas",
                                 auto_origin=True, refine=refine,
                                 device=dev, seed=0, timings=stages)
        log(f"refine={refine} counts {stages.pop('trace')['counts']}")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "Object_0.ply")
            tio.write_ply(path, res.points, colors=res.colors,
                          normals=res.normals)
            cloud = tio.read_ply(path)["points"]
        t1 = time.perf_counter()
        m = evaluate_map(cloud, gt, use_icp=True, device=dev)
        torch.cuda.synchronize()
        stages["eval"] = time.perf_counter() - t1
        total = time.perf_counter() - t0
        t_err, r_err = trajectory_error(res.extrinsics, batch.extrinsics)
        errors[refine] = t_err
        log(f"refine={refine} stages (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in stages.items())
            + f", total {total:.4f}")
        log(f"refine={refine}: trajectory RMSE {t_err:.6f} m, {r_err:.6f} "
            f"rad (drifted {t_odo:.6f} m, {r_odo:.6f} rad); cloud "
            f"{len(cloud)} points, eval ICP fitness {m.icp_fitness:.4f} "
            f"rmse {m.icp_rmse:.6f}, accuracy {m.accuracy_cm:.4f} cm, "
            f"completeness {m.completeness_cm:.4f} cm")
        check(cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0,
              f"refine={refine}: cloud shape {cloud.shape}")
        check(bool(np.isfinite(cloud).all()),
              f"refine={refine}: cloud has non-finite points")
        check(np.isfinite([m.accuracy_cm, m.completeness_cm,
                           m.icp_fitness]).all(),
              f"refine={refine}: non-finite metrics {m}")
    check(errors["pgo"] < t_odo,
          f"pgo translation RMSE {errors['pgo']} m is not below the "
          f"drifted odometry's {t_odo} m")

    loc, scan, angles, prior, true = localizer_case(dev)
    t0 = time.perf_counter()
    pose = loc.localize(scan, angles, prior)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pos_err = float(np.hypot(pose.x - true[0], pose.y - true[1]))
    yaw_err = abs(pose.yaw - true[2])
    log(f"localize: {len(angles)} beams, map {len(loc._map_np)} cells, "
        f"prior off 0.1000 m / 0.0700 rad -> off {pos_err:.6f} m / "
        f"{yaw_err:.6f} rad, fitness {pose.fitness:.4f}, {secs:.4f} s")
    check(pos_err < 0.04 and yaw_err < 0.02,
          f"localization off by {pos_err} m, {yaw_err} rad")


def ray_poses(scene, n: int, seed: int):
    """n (x, y, yaw) poses drawn inside a scene's room, in free space."""
    import numpy as np
    rng = np.random.default_rng(seed)
    xmin, xmax, ymin, ymax = scene.room
    grid = scene.occupancy_grid(0.05)
    out = []
    while len(out) < n:
        x, y = rng.uniform([xmin + 0.3, ymin + 0.3], [xmax - 0.3, ymax - 0.3])
        gx = int((x - grid.origin[0]) / grid.resolution)
        gy = int((y - grid.origin[1]) / grid.resolution)
        if grid.data[gy, gx] != 100:
            out.append((x, y, rng.uniform(-np.pi, np.pi)))
    return np.asarray(out, np.float32)


def k5_shape(name, vs, poses, dev):
    """K5 against its plain version on the map latched in the
    VirtualScanner `vs`, at the (P, 3) (x, y, yaw) `poses` in one call:
    bit-identical keys and ranges, at every lane count a ray. Returns its
    record, with the kernel alone at each lane count."""
    import torch

    from otslam_tpu_torch.kernels import nn, raycast
    lidar, g = vs.lidar, vs._map
    poses = torch.as_tensor(poses, device=dev)
    steps = raycast.num_steps_for(lidar.range_max, g.resolution)
    cos_a, sin_a = raycast.beam_trig(poses[:, 2], vs.angles())
    xy = poses[:, :2].contiguous()
    args = (vs.grid, cos_a.contiguous(), sin_a.contiguous(), xy,
            float(g.resolution), float(g.origin[0]), float(g.origin[1]),
            steps)
    fs, fo = raycast.ray_keys(*args)
    ps, po = raycast.ray_keys_torch(*args)
    ranges = raycast.raycast_grid_fast(
        vs.grid, g.resolution, *g.origin, poses[:, 0], poses[:, 1],
        poses[:, 2], vs.angles(), lidar.range_max)
    plain = raycast.raycast_grid(
        vs.grid, g.resolution, *g.origin, poses[:, 0], poses[:, 1],
        poses[:, 2], vs.angles(), lidar.range_max)
    torch.cuda.synchronize()
    check(bool(torch.equal(fs, ps)) and bool(torch.equal(fo, po)),
          f"K5 keys differ from the plain version on {name} at "
          f"{int(((fs != ps) | (fo != po)).sum())} beams")
    check(bool(torch.equal(ranges, plain)),
          f"K5 ranges differ from the plain version on {name}")
    by_lanes = {}
    for lanes in raycast.LANE_CHOICES:
        ls, lo = raycast.ray_keys(*args, lanes=lanes)
        check(bool(torch.equal(ls, ps)) and bool(torch.equal(lo, po)),
              f"K5 at L={lanes} differs from the plain version on {name}")
        by_lanes[f"L={lanes}"] = kernel_ms(
            lambda: raycast.ray_keys(*args, lanes=lanes), 20,
            "raycast_kernel")
    ms = cuda_ms(lambda: raycast.ray_keys(*args), 20)
    plain_ms = cuda_ms(lambda: raycast.ray_keys_torch(*args), 5)
    dev_ms = kernel_ms(lambda: raycast.ray_keys(*args), 20,
                       "raycast_kernel")
    hits = int(torch.isfinite(ranges).sum())
    # the samples this data needs: each beam walks to its first stop
    samples = float((fs + 1).clamp(max=steps).sum())
    kb = fs.numel()
    # about 12 f32 operations a sample (step distance, two products and
    # sums, two differences and divisions, two casts, bounds tests); the
    # grid, cos/sin and poses read once, two keys written once
    b = bound(vs.grid.numel() + kb * 8 + xy.numel() * 4 + kb * 8,
              12.0 * samples)
    floor = instruction_floor_ms(K5_INSTRUCTIONS, samples, dev)
    n_poses = poses.shape[0]
    log(f"K5 raycast {name}: map {tuple(vs.grid.shape)}, {n_poses} "
        f"poses x {lidar.num_beams} beams x {steps} steps, hit beams "
        f"{hits} of {kb}, keys and ranges identical to the plain "
        f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, kernel "
        f"alone {fmt_ms(dev_ms)}, samples walked {samples:.0f} "
        f"({samples / (ms * 1e-3):.4g} samples/s), bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']}), instruction floor "
        f"at {K5_INSTRUCTIONS} a sample {floor:.6f} ms")
    lanes = raycast.lanes_for(fs.numel(), nn.sm_count(dev))
    log(f"  lanes a ray, kernel alone (L={lanes} taken): "
        + ", ".join(f"{k} {fmt_ms(t)}" for k, t in by_lanes.items()))
    return {"shape": f"{name} {n_poses} poses", "max_abs_err": 0.0,
            "ms": ms, "kernel_ms": dev_ms, "plain_ms": plain_ms, **b,
            "library_ms": None, "samples": samples,
            "kernel_ms_by_lanes": by_lanes}


def phase_k5(dev):
    """k5_shape at the perception workload: RAY_BEAMS beams of a 10 m
    LiDAR (200 steps at 0.05 m), RAY_POSES poses in one call, on the
    cardboard room's and full_room's maps, and the mission's
    MISSION_POSES on the cardboard map."""
    from otslam_tpu_torch.config import LidarConfig
    from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner
    from otslam_tpu_torch.sim.world import cardboard_room, full_room
    out = {}
    for name, scene, n_poses in (
            ("cardboard", cardboard_room(), RAY_POSES),
            ("full_room", full_room(), RAY_POSES),
            ("mission batch", cardboard_room(), MISSION_POSES)):
        vs = VirtualScanner(LidarConfig(), device=dev)
        vs.set_map(scene.occupancy_grid(0.05))
        out[name] = k5_shape(name, vs, ray_poses(scene, n_poses, 7), dev)
    regs = ptxas_registers("raycast_kernel")
    loops = sass_loops("raycast_kernel")
    log(f"K5 raycast: registers {regs}; SASS chunk loop (instructions, "
        f"slow-path calls) {loops}")
    return {**out["cardboard"], "registers": regs, "sass_loop": loops,
            "full_room": out["full_room"], "shapes": list(out.values())}


def phase_mission(dev, workdir: str):
    """The mission path (phase 8): the mission CLI at its defaults with
    --removed --localizer --perception-batch 8, then reconstruct_all over
    its dataset and evaluate_map of Object_0. Returns stage seconds."""
    import io

    import numpy as np
    import torch

    from otslam_tpu_torch import cli
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.pipeline.dataset import CaptureDataset
    from otslam_tpu_torch.pipeline.reconstruct import reconstruct_all

    stages = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["mission", "--workdir", workdir, "--removed",
                  "--localizer", "--perception-batch", "8", "--max-ticks",
                  str(MISSION_TICKS), "--device", str(dev)])
    torch.cuda.synchronize()
    stages["mission"] = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"mission: {json.dumps(out)}")
    check(out["stable_objects"] >= 1, f"no stable object: {out}")
    check(out["missions"] >= 4, f"only {out['missions']} missions")
    check(len(out["removed_checks_visited"]) > 0,
          "the removed-object check was never visited")
    t1 = time.perf_counter()
    res = reconstruct_all(CaptureDataset(out["dataset"]),
                          ReconstructionConfig(), auto_origin=True,
                          device=dev,
                          save_dir=os.path.join(out["dataset"], "3d_reconst"))
    torch.cuda.synchronize()
    stages["reconstruct_all"] = time.perf_counter() - t1
    for name, r in res.items():
        log(f"mission reconstruct: {name} {len(r.points)} points from "
            f"{r.num_frames} frames")
        check(len(r.points) > 0 and bool(np.isfinite(r.points).all()),
              f"{name}: empty or non-finite cloud")
    check("Object_0" in res, f"no Object_0 among {sorted(res)}")
    t1 = time.perf_counter()
    m = evaluate_map(res["Object_0"].points, scenario_gt("cardboard",
                                                         GT_POINTS),
                     device=dev)
    torch.cuda.synchronize()
    stages["eval"] = time.perf_counter() - t1
    log(f"mission stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items())
        + f"; ticks {out['ticks']}, {out['ticks'] / stages['mission']:.2f} "
        f"ticks/s; Object_0 accuracy {m.accuracy_cm:.4f} cm, completeness "
        f"{m.completeness_cm:.4f} cm")
    check(m.accuracy_cm < 2.0, f"Object_0 accuracy {m.accuracy_cm} cm >= 2")
    return stages


def survey_poses():
    """The 36 (x, y, yaw) poses of the grid mapper's survey
    (tests/test_grid_mapper.py): a 3 x 3 lattice, four headings each."""
    import numpy as np
    return np.asarray([(x, y, yaw) for x in (-3.0, 0.0, 3.0)
                       for y in (-3.0, 0.0, 3.0)
                       for yaw in (0.0, 1.57, 3.14, 4.71)], np.float32)


def beam_angles(n: int):
    import numpy as np
    return np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)


def phase_grid_mapper(dev, workdir: str):
    """9a: the grid mapper's survey of the cardboard room at the LiDAR's
    defaults on a 5 cm grid, then the checks of tests/test_grid_mapper.py,
    the card's log-odds against the CPU's, and a virtual scan (K5) of the
    map learned from the empty room, equal to the plain ray cast. Returns
    (stage seconds, the learned map's VirtualScanner)."""
    import numpy as np
    import torch

    from otslam_tpu_torch.config import LidarConfig
    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.core.grid import OccupancyGrid2D
    from otslam_tpu_torch.kernels.raycast import raycast_grid
    from otslam_tpu_torch.mapping.grid_mapper import GridMapper
    from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner
    from otslam_tpu_torch.sim.sensors import render_lidar, render_lidar_path
    from otslam_tpu_torch.sim.world import Scene, cardboard_room

    lidar = LidarConfig()
    angles = beam_angles(lidar.num_beams)
    poses = survey_poses()
    stages = {}

    def survey(scene):
        rb = render_lidar_path(scene, poses[:, 0], poses[:, 1], poses[:, 2],
                               angles, lidar.range_min, lidar.range_max,
                               device=dev)
        gm = GridMapper(GRID_EXTENT, GRID_RESOLUTION, lidar, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gm.add_trajectory(rb, angles, poses)
        torch.cuda.synchronize()
        stages["add_trajectory"] = time.perf_counter() - t0
        return gm, rb

    gm, rb = survey(cardboard_room())
    cpu = GridMapper(GRID_EXTENT, GRID_RESOLUTION, lidar, device="cpu")
    t0 = time.perf_counter()
    cpu.add_trajectory(rb.cpu(), angles, poses)
    stages["add_trajectory_cpu"] = time.perf_counter() - t0
    lo, lo_cpu = gm.logodds.cpu().numpy(), cpu.logodds.numpy()
    differ = int((lo != lo_cpu).sum())
    touched = (lo != 0) | (lo_cpu != 0)
    log(f"grid mapper: {len(poses)} scans x {lidar.num_beams} beams x "
        f"{int(lidar.range_max / GRID_RESOLUTION) + 1} steps onto "
        f"{gm.gh}x{gm.gw} cells; touched {int(touched.sum())}, card vs CPU: "
        f"{differ} cells differ")
    check(differ == 0, f"{differ} log-odds cells differ between the card "
          f"and the CPU")

    grid = gm.to_grid()
    data = grid.data.cpu().numpy()
    occ = grid.occupied_world_points()
    d_wall = np.minimum.reduce([np.abs(np.abs(occ[:, 0]) - 5.0),
                                np.abs(np.abs(occ[:, 1]) - 5.0)])
    d_box = np.hypot(occ[:, 0] - BOX_XY[0], occ[:, 1] - BOX_XY[1])
    on_structure = float(((d_wall < 0.25) | (d_box < 0.6)).mean())
    log(f"grid mapper: {len(occ)} occupied cells, {100 * on_structure:.2f} % "
        f"on structure, {int((d_box < 0.6).sum())} on the box")
    check(len(occ) > 100 and on_structure > 0.97,
          f"occupied cells on structure {on_structure}")
    check((d_box < 0.6).sum() > 3, "the box is not in the learned map")
    check(data[data.shape[0] // 2, data.shape[1] // 2] == 0,
          "the room's centre is not free")
    pgm, yaml = (os.path.join(workdir, f"map.{e}") for e in ("pgm", "yaml"))
    gm.save(pgm, yaml)
    meta = tio.read_map_yaml(yaml)
    back = OccupancyGrid2D.from_pgm(tio.read_pgm(pgm), meta["resolution"],
                                    tuple(meta["origin"][:2]))
    check(np.array_equal(back.data, data), "save then reload changed the map")

    empty = Scene(objects=())
    learned, _ = survey(empty)
    vs = VirtualScanner(lidar, device=dev)
    vs.set_map(learned.to_grid())
    virt = vs.scan(*SCAN_POSE)
    g = vs._map
    plain = raycast_grid(vs.grid, g.resolution, *g.origin, *SCAN_POSE,
                         vs.angles(), lidar.range_max)
    check(bool(torch.equal(virt, plain)), f"the virtual scan (K5) differs "
          f"from the plain ray cast on {int((virt != plain).sum())} beams")
    virt = virt.cpu().numpy()
    real = render_lidar(empty, *SCAN_POSE, vs.angles(), lidar.range_min,
                        lidar.range_max, device=dev).cpu().numpy()
    near = np.isfinite(virt) & np.isfinite(real) & (np.abs(virt - real) < 0.3)
    log(f"grid mapper: virtual scan of the learned empty room equal to the "
        f"plain ray cast, within 0.3 m of the real scan on "
        f"{100 * near.mean():.2f} % of {lidar.num_beams} beams")
    check(near.mean() >= 0.9, f"virtual scan matches on {near.mean()}")
    return stages, vs


def phase_classifier(dev):
    """9b: LidarClusterClassifier on a 1440-beam scan of the cardboard room
    with the initial-mapping profile, on the card and on the CPU. Returns
    its seconds on the card."""
    import numpy as np
    import torch

    from otslam_tpu_torch.config import ClusterConfig, LidarConfig
    from otslam_tpu_torch.mapping.initial_mapping import \
        LidarClusterClassifier
    from otslam_tpu_torch.sim.sensors import render_lidar
    from otslam_tpu_torch.sim.world import cardboard_room

    lidar = LidarConfig()
    cfg = ClusterConfig.initial_mapping_profile()
    angles = beam_angles(lidar.num_beams)
    pose = CLASSIFY_POSE
    r = render_lidar(cardboard_room(), *pose, angles, lidar.range_min,
                     lidar.range_max, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = LidarClusterClassifier(cfg, lidar, device=dev).classify(r, angles,
                                                                  pose)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ref = LidarClusterClassifier(cfg, lidar, device="cpu").classify(
        r.cpu(), angles, pose)
    st, st_cpu = out["stats"], ref["stats"]
    c = out["object"].mean(axis=0) if len(out["object"]) else [np.inf] * 2
    off = float(np.hypot(c[0] - BOX_XY[0], c[1] - BOX_XY[1]))
    log(f"classifier: {int(st.valid.sum())} clusters, wall "
        f"{len(out['wall'])} / object {len(out['object'])} / unknown "
        f"{len(out['unknown'])} points; object centroid {off:.4f} m from "
        f"the box; {secs:.4f} s")
    check(off < 0.5, f"object centroid {off} m from the box")
    # every statistic is held equal: analyze_clusters adds each cluster's
    # sums in index order on every device
    for k in st._fields:
        a, b = getattr(st, k).cpu(), getattr(st_cpu, k)
        same = (a == b) | (a.isnan() & b.isnan())
        check(bool(same.all()), f"classifier {k} differ between the card "
              f"and the CPU at {int((~same).sum())} entries")
    for k in ("wall", "object", "unknown"):
        check(np.array_equal(out[k], ref[k]), f"classifier {k} points differ")
    return secs


def phase_headline(dev, workdir: str, scene_name: str,
                   min_reduction: float | None = 99.0, **kw):
    """9c: headline_report on `scene_name` (cardboard or table_chair) at its
    defaults, or with the keywords `kw`, and the checks of
    tests/test_headline.py; the size reduction is held to `min_reduction`
    (None: printed only). Prints the report and each stage's seconds.
    Returns (report, stage seconds)."""
    import torch

    from otslam_tpu_torch.eval.headline import headline_report
    from otslam_tpu_torch.sim import world

    scene_fn = {"cardboard": world.cardboard_room,
                "table_chair": world.table_chair_room}[scene_name]
    stages: dict = {}
    t0 = time.perf_counter()
    rep = headline_report(workdir, scene_fn=scene_fn, device=dev,
                          timings=stages, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    label = f"headline {scene_name}" + (f" {kw}" if kw else "")
    log(f"{label}: {json.dumps(rep)}")
    log(f"{label} stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f", total {total:.4f}")
    if min_reduction is not None:
        check(rep["size_reduction_percent"] >= min_reduction,
              f"{label}: size reduction {rep['size_reduction_percent']} %")
    if scene_name == "cardboard":
        for k in ("size_reduction_downsampled_percent",
                  "size_reduction_voxel_percent"):
            check(rep[k] >= 90.0, f"{scene_name}: {k} {rep[k]}")
        m = rep["objects"]["Object_0"]
        check(m["proposal_accuracy_cm"] < 1.5
              and m["proposal_completeness_cm"] < 1.5,
              f"cardboard Object_0 {m}")
        check(rep["combined_accuracy_cm"] < 1.5,
              f"cardboard combined accuracy {rep['combined_accuracy_cm']}")
    else:
        check(len(rep["objects"]) == 5, f"{len(rep['objects'])} objects")
        check(rep["combined_accuracy_cm"] < 2.63,
              f"table_chair combined accuracy {rep['combined_accuracy_cm']}")
    return rep, stages


def phase_dense_baseline(dev):
    """9d: dense_room_reconstruction of the cardboard room's headline
    room sweep (48 VGA frames) at 2 cm, trunc 0.08, 500k samples,
    max_active 8192. Returns the sweep's (depths, colors, extrinsics,
    intrinsics) on the card."""
    import numpy as np
    import torch

    from otslam_tpu_torch.config import CameraConfig
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.eval.baseline import dense_room_reconstruction
    from otslam_tpu_torch.eval.headline import _room_sweep
    from otslam_tpu_torch.sim.world import cardboard_room

    intr = PinholeIntrinsics.from_config(CameraConfig())
    scene = cardboard_room()
    sweep = _room_sweep(scene, intr, 48, scene.room, device=dev)
    depths = torch.stack([d for d, _, _ in sweep])
    colors = torch.stack([c for _, c, _ in sweep])
    exts = torch.as_tensor(np.stack([e for _, _, e in sweep]), device=dev)
    del sweep
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts, cols = dense_room_reconstruction(depths, colors, exts, intr,
                                          DENSE_BOUNDS, DENSE_VOXEL,
                                          DENSE_TRUNC, 500_000, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    finite = bool(torch.isfinite(pts).all() and torch.isfinite(cols).all())
    log(f"dense baseline: {len(depths)} VGA frames at 2 cm -> "
        f"{pts.shape[0]} points, finite {finite}, {secs:.4f} s")
    check(pts.shape == (500_000, 3) and finite,
          f"dense baseline points {tuple(pts.shape)}, finite {finite}")
    return depths, colors, exts, intr


def fuse_plain(vol, depths, colors, exts, intr, max_active):
    """integrate_frames_cuda's schedule with each kernel's plain version,
    on the volume's device, in place. Returns the largest per-frame
    active-block count before the max_active cap."""
    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    nb = vol.num_blocks
    band, vis = tc.classify_blocks_torch(vol.meta, depths, exts, intr)
    created, active = tc.created_and_active(band, vis, vol.created[:nb])
    most = int(active.sum(dim=1).max())
    if max_active is not None:
        active &= torch.cumsum(active, dim=1) <= max_active
    tc.fuse_blocks_torch(vol, *tc.active_worklist(active), depths,
                         tc.pack_rgb_torch(colors), exts, intr)
    vol.created[:nb] = created[-1]
    return most


def schedule_shapes(label, base, depths, colors, exts, intr, max_active,
                    k2s, k1, reps=5):
    """The fusion schedule's kernels at one shape: k2_shape on the frames,
    then k1_shape on the work list they give into the volume `base` (not
    modified), capped at max_active as integrate_frames_cuda caps it; each
    record appended to its kernel's `shapes`. Returns the (block, frame)
    pairs before and after the cap."""
    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    band, vis = k2_shape(label, base.meta, depths, colors, exts, intr, reps,
                         {k: k2s[k]["shapes"] for k in k2s})
    _, active = tc.created_and_active(band, vis,
                                      base.created[:base.num_blocks])
    pairs = int(active.sum())
    if max_active is not None:
        active &= torch.cumsum(active, dim=1) <= max_active
    k1["shapes"].append(k1_shape(label, base, *tc.active_worklist(active),
                                 depths, colors, exts, intr, reps))
    return pairs, int(active.sum())


def fusion_shapes(label, cfg, depths, colors, exts, intr, max_active,
                  k2s, k1):
    """The fusion schedule at one of phase 9's shapes: k2_shape and
    k1_shape (K1 on the capped work list into an empty volume of `cfg`),
    each record appended to its kernel's `shapes`; then the whole
    schedule, integrate_frames_sparse on the card against fuse_plain, with
    tsdf, weight, colour and created equal. Returns the largest per-frame
    active-block count before the cap."""
    import torch

    from otslam_tpu_torch.kernels.tsdf_block import (integrate_frames_sparse,
                                                     make_block_volume)
    dev = depths.device
    vol = make_block_volume(cfg, dev)
    nb = vol.num_blocks
    schedule_shapes(label, vol, depths, colors, exts, intr, max_active, k2s,
                    k1)
    card = integrate_frames_sparse(vol, depths, colors, exts, intr,
                                   max_active=max_active)
    plain = make_block_volume(cfg, dev)
    most = fuse_plain(plain, depths, colors, exts, intr, max_active)
    torch.cuda.synchronize()
    diff = {k: int((getattr(card, k) != getattr(plain, k)).sum())
            for k in ("tsdf", "weight", "color", "created")}
    check(not any(diff.values()), f"the fusion schedule differs from its "
          f"plain version at {label} (entries per field {diff})")
    log(f"  {label}: {nb} blocks, at most {most} active a frame before the "
        f"cap; integrate_frames_sparse equal to the plain schedule (tsdf, "
        f"weight, colour, created)")
    return most


def largest_pairs(kept: dict, dev):
    """A keep() for k3_calls: in `kept`, the clones of the operands of
    the call with the most pairs, one for single launches (S = 1) and one
    for split launches (S > 1)."""
    from otslam_tpu_torch.kernels import nn

    def keep(src, dst, dst_mask):
        n, m = src.shape[0], dst.shape[0]
        key = "split" if nn.split_count(n, m, nn.sm_count(dev)) > 1 \
            else "single"
        if key not in kept or n * m > kept[key][0]:
            kept[key] = (n * m, src.clone(), dst.clone(), dst_mask.clone())
    return keep


def every_call(kept: list):
    """A keep() for k3_calls: clones of every call's operands, in order."""
    def keep(src, dst, dst_mask):
        kept.append((src.clone(), dst.clone(), dst_mask.clone()))
    return keep


@contextlib.contextmanager
def plain_nn_min():
    """While the block runs, nn_min is its plain version, so nn_distance
    and what calls it compute without K3."""
    from otslam_tpu_torch.kernels import nn
    real = nn.nn_min
    nn.nn_min = nn.nn_min_torch
    try:
        yield
    finally:
        nn.nn_min = real


def phase_map_building(dev, workdir: str):
    """Phase 9 (9a-9d, the module docstring). Returns what phase9_shapes
    checks after the phase: 9d's frames, 9a's learned-map VirtualScanner
    and the operands of 9c's largest K3 calls."""
    t0 = time.perf_counter()
    grid_stages, learned = phase_grid_mapper(dev, workdir)
    log("grid mapper stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in grid_stages.items()))
    phase_classifier(dev)
    crops: dict = {}
    with k3_calls(largest_pairs(crops, dev)):
        phase_headline(dev, os.path.join(workdir, "cardboard"), "cardboard")
        # table_chair at the defaults stores five 100k-sample clouds (~6 MB)
        # against a dense map of at most 48 x 640 x 480 points (~221 MB), so
        # its reduction stays below 99 % by construction: printed here, and
        # held to 99 % at the settings of tests/test_headline.py's
        # multi-object case (6 000 samples an object, 8 frames, 40 room
        # frames)
        phase_headline(dev, os.path.join(workdir, "table_chair"),
                       "table_chair", min_reduction=None)
        phase_headline(dev, os.path.join(workdir, "table_chair_6k"),
                       "table_chair", frames_per_object=8, room_frames=40,
                       object_samples=6_000)
    frames = phase_dense_baseline(dev)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return frames, learned, crops


def phase9_shapes(dev, frames, learned, crops, k2s, k1, k3, k5):
    """Each kernel against its plain version at phase 9's shapes, after the
    phase (outside its launch count), each record added to the kernel's
    `shapes`: the fusion schedule (fusion_shapes) on one headline capture
    circle (the cardboard room's Object_0, 12 VGA frames, 1 cm) and on
    9d's 48 frames into the dense room volume at max_active 8192; K3 at
    9c's largest dense-crop calls; K5 on 9a's learned map."""
    import numpy as np

    from otslam_tpu_torch.eval.baseline import (DENSE_MAX_ACTIVE,
                                                dense_volume_config)
    from otslam_tpu_torch.eval.headline import (_capture_circle,
                                                object_volume_config)
    from otslam_tpu_torch.sim.world import cardboard_room
    depths, colors, exts, intr = frames
    scene = cardboard_room()
    center = np.asarray(scene.objects[0].center, np.float64)
    d, c, e = _capture_circle(scene, center, intr, 12, device=dev)
    fusion_shapes("headline circle 12 frames", object_volume_config(
        center, 0.01), d, c, e, intr, None, k2s, k1)
    del d, c, e
    most = fusion_shapes(
        f"dense room {len(depths)} frames, max_active {DENSE_MAX_ACTIVE}",
        dense_volume_config(DENSE_BOUNDS, DENSE_VOXEL, DENSE_TRUNC), depths,
        colors, exts, intr, DENSE_MAX_ACTIVE, k2s, k1)
    check(most > DENSE_MAX_ACTIVE, f"the dense room's cap never binds "
          f"({most} active blocks at most)")
    for key, (_, src, dst, mask) in sorted(crops.items()):
        k3["shapes"].append(k3_shape(
            f"headline crop {src.shape[0]} x {dst.shape[0]} ({key})", src,
            dst, mask, dev))
    k5["shapes"].append(k5_shape("learned empty room", learned,
                                 np.asarray([SCAN_POSE], np.float32), dev))


def online_stream(of, depths, colors, exts):
    """Push every frame from a producer thread, waiting while the ring is
    full (nothing is dropped), and drain on this thread until all are
    fused. Returns (push -> fused wall seconds ending in a sync, seconds
    inside drain calls)."""
    import threading

    import torch
    errors = []

    def produce():
        try:
            for d, c, e in zip(depths, colors, exts):
                while len(of.ring) >= ONLINE_RING:
                    time.sleep(1e-4)
                of.push(d, c, e)
        except Exception as ex:        # reported by the draining thread
            errors.append(ex)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    drain_s = 0.0
    while of.frames_fused < len(depths):
        check(not errors, f"producer failed: {errors}")
        check(time.perf_counter() - t0 < 120, "online fusion stalled")
        t1 = time.perf_counter()
        if of.drain():
            drain_s += time.perf_counter() - t1
        else:
            time.sleep(1e-4)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    drain_s += time.perf_counter() - t1
    total = time.perf_counter() - t0
    producer.join(10)
    check(not producer.is_alive() and not errors,
          f"producer did not finish cleanly: {errors}")
    return total, drain_s


def phase_online(batch, intr, vol_cfg, dev, gt):
    """Phase 10a: the phase-4 capture streamed through OnlineFusion (a
    producer thread -> the native ring -> micro-batches of 4 through the
    fusion schedule), then extract -> the z-filtered cloud -> evaluate_map.
    Returns (the volume, the cloud, the push -> fused colours, the
    operands of evaluate_map's K3 calls)."""
    import numpy as np
    import torch

    from otslam_tpu_torch.adapters.native import native_available
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.eval.metrics import evaluate_map
    from otslam_tpu_torch.pipeline import OnlineFusion

    check(native_available(), "the native host library did not build or "
          "load (g++): the ring fell back to NumPy")
    cfg = ReconstructionConfig(tsdf=vol_cfg)
    colors = batch.colors.astype(np.uint8)        # what a camera pushes
    of = OnlineFusion(cfg, intr, ring_capacity=ONLINE_RING,
                      batch=ONLINE_BATCH, max_active=ONLINE_MAX_ACTIVE,
                      device=dev)
    total, drain_s = online_stream(of, batch.depths, colors,
                                   batch.extrinsics)
    check(of.frames_fused == N_FRAMES and of.dropped_frames == 0,
          f"fused {of.frames_fused}, dropped {of.dropped_frames}")
    pts, _, mask = of.extract()
    cloud = pts[mask]
    cloud = cloud[cloud[:, 2] >= cfg.z_filter_threshold]
    k3_ops: list = []
    with k3_calls(every_call(k3_ops)):
        m = evaluate_map(cloud, gt, device=dev)
    torch.cuda.synchronize()
    log(f"online: {N_FRAMES} frames pushed -> fused in {total:.4f} s "
        f"({N_FRAMES / total:.1f} frames/s), drain {drain_s:.4f} s, ring "
        f"{ONLINE_RING}, batch {ONLINE_BATCH}, max_active "
        f"{ONLINE_MAX_ACTIVE}; cloud {len(cloud)} points above the floor, "
        f"accuracy {m.accuracy_cm:.4f} cm, completeness "
        f"{m.completeness_cm:.4f} cm")
    check(len(cloud) > 0 and bool(torch.isfinite(cloud).all()),
          "online cloud empty or non-finite")
    check(m.accuracy_cm < 1.0, f"online accuracy {m.accuracy_cm} cm >= 1")
    return of.volume, cloud, colors, k3_ops


def phase_online_checks(vol, batch, colors, intr, vol_cfg, dev, k3_ops,
                        k2s, k1, k3):
    """After phase 10's count: the drained volume torch.equal to one batch
    fusion of the same frames at the same per-frame cap, on the card
    (fuse_frames) and by the plain schedule (fuse_plain, whose cap must
    bind); then each kernel against its plain version at the path's
    shapes, each record added to its kernel's `shapes`: the mips, K2, the
    pack and K1 on micro-batch ONLINE_SHAPE_BATCH at the volume state
    before it, with its capped work list, and K3 at evaluate_map's calls."""
    import torch

    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    from otslam_tpu_torch.pipeline.reconstruct import fuse_frames
    ref = fuse_frames(batch.depths, colors, batch.extrinsics, intr,
                      ReconstructionConfig(tsdf=vol_cfg),
                      max_active=ONLINE_MAX_ACTIVE, densify=False,
                      device=dev)
    d, c, e = (torch.as_tensor(x, device=dev, dtype=torch.float32)
               for x in (batch.depths, colors, batch.extrinsics))
    plain = make_block_volume(vol_cfg, dev)
    most = fuse_plain(plain, d, c, e, intr, ONLINE_MAX_ACTIVE)
    for f in ("tsdf", "weight", "color", "created"):
        check(bool(torch.equal(getattr(vol, f), getattr(ref, f))),
              f"online volume's {f} != the batch fusion's")
        check(bool(torch.equal(getattr(vol, f), getattr(plain, f))),
              f"online volume's {f} != the plain schedule's")
    check(most > ONLINE_MAX_ACTIVE, f"the online cap never binds ({most} "
          f"active blocks at most)")
    log(f"online volume == fuse_frames(max_active={ONLINE_MAX_ACTIVE}) and "
        f"== the plain schedule of the same frames (tsdf, weight, colour, "
        f"created); at most {most} active blocks a frame before the cap")
    del ref, plain
    j0 = ONLINE_SHAPE_BATCH * ONLINE_BATCH
    f = slice(j0, j0 + ONLINE_BATCH)
    base = make_block_volume(vol_cfg, dev)
    fuse_plain(base, d[:j0], c[:j0], e[:j0], intr, ONLINE_MAX_ACTIVE)
    label = (f"online micro-batch {ONLINE_SHAPE_BATCH} (frames {j0}-"
             f"{j0 + ONLINE_BATCH - 1}), max_active {ONLINE_MAX_ACTIVE}")
    pairs, capped = schedule_shapes(label, base, d[f], c[f], e[f], intr,
                                    ONLINE_MAX_ACTIVE, k2s, k1, reps=10)
    log(f"  {label}: {pairs} active (block, frame) pairs, {capped} after "
        f"the cap, {int(base.created.sum())} blocks created before it")
    del base
    for src, dst, mask in k3_ops:
        k3["shapes"].append(k3_shape(
            f"online evaluate_map {src.shape[0]} x {dst.shape[0]}", src,
            dst, mask, dev))


def system_scenario(dev):
    """Phase 8's scenario for OTSLAMSystem: the mission CLI's runner with
    --removed (the cardboard world, the saved map with the removed box),
    and SYSTEM_TICKS real 1440-beam scans rendered on the card: the first
    SYSTEM_SETTLE at the mission's start pose, then SYSTEM_STEP m a tick
    toward the box, facing it. Returns (cfg, saved map grid, angles,
    poses, scans) as host arrays."""
    import argparse

    import numpy as np

    from otslam_tpu_torch.cli import mission_runner
    from otslam_tpu_torch.sim.sensors import render_lidar

    args = argparse.Namespace(scenario="cardboard", removed=True,
                              perception_batch=MISSION_POSES,
                              odom_noise=0.0, localizer=False,
                              start="-2.0,-2.0,0.5")
    with tempfile.TemporaryDirectory() as tmp:
        runner = mission_runner(args, tmp, dev)
    cfg = runner.cfg
    grid = runner.vscanner._map                  # the saved map
    angles = runner.vscanner.angles().cpu().numpy()
    x0, y0 = runner.x, runner.y
    bx, by = BOX_XY
    heading = np.arctan2(by - y0, bx - x0)
    poses, scans = [], []
    for k in range(SYSTEM_TICKS):
        s = SYSTEM_STEP * max(0, k - SYSTEM_SETTLE + 1)
        pose = (float(x0 + s * np.cos(heading)),
                float(y0 + s * np.sin(heading)), float(heading))
        poses.append(pose)
        scans.append(render_lidar(
            runner.scene_world, *pose, runner.vscanner.angles(),
            cfg.lidar.range_min, cfg.lidar.range_max, device=dev)
            .cpu().numpy())
    return cfg, grid, angles, poses, scans


def run_system(cfg, grid, angles, poses, scans, device):
    """OTSLAMSystem over the scan sequence on `device`, then its goal
    queue driven to exhaustion (teleporting to each goal). Returns the
    system and its record: every tick's added and removed clouds, the
    stable objects of both trackers, the final visiting points and the
    goal order."""
    from otslam_tpu_torch.adapters.bus import Bus, OTSLAMSystem
    system = OTSLAMSystem(cfg, Bus(), device=device)
    b = system.bus
    added, removed = [], []
    b.subscribe("/added_objects", added.append)
    b.subscribe("/removed_objects", removed.append)
    b.publish("/virtual_map", grid)
    for k, (pose, real) in enumerate(zip(poses, scans)):
        b.publish("/odom", pose[:2])
        b.publish("/scan", {"ranges": real, "angles": angles, "pose": pose,
                            "stamp": 0.2 * (k + 1)})
    points = (b.last.get("/object_visiting_points", []),
              b.last.get("/removed_object_visiting_points", []))
    goals = []
    for _ in range(200):
        g = system.control_step()
        if g is None and system.sender.pending_count() == 0:
            break
        if g is not None:
            goals.append((g.unique_id, g.object_id, g.is_removed))
            b.publish("/odom", (g.x, g.y))
    def stable(tracker):
        return [(o.cx, o.cy, o.width, o.height, o.site_id)
                for o in tracker.stable_objects]
    return system, {"added": added, "removed": removed,
                    "stable": stable(system.tracker),
                    "removed_stable": stable(system.removed_tracker),
                    "points": points, "goals": goals}


def phase_system(dev):
    """Phase 10b: OTSLAMSystem on the card over phase 8's scenario (K5 for
    every /virtual_scan). Returns what phase_system_checks compares."""
    import torch
    t0 = time.perf_counter()
    scenario = system_scenario(dev)
    t1 = time.perf_counter()
    _, card = run_system(*scenario, device=dev)
    torch.cuda.synchronize()
    log(f"system: {SYSTEM_TICKS} scans rendered in {t1 - t0:.3f} s, bus "
        f"run {time.perf_counter() - t1:.3f} s; {len(card['stable'])} "
        f"stable, {len(card['removed_stable'])} removed stable, goals "
        f"{card['goals']}")
    check(len(card["stable"]) >= 1 and len(card["goals"]) >= 1,
          f"the system found no object or goal: {card['stable']}")
    return scenario, card


def phase_system_checks(scenario, card):
    """After phase 10's count: the card's record equal to a CPU run of the
    same system; the native tracker and sender fed the same points give
    the Python classes' stable objects and visit order."""
    import numpy as np

    from otslam_tpu_torch.adapters.native_mission import (
        NativeGoalSender, NativeObjectTracker)
    _, cpu = run_system(*scenario, device="cpu")
    for k in ("added", "removed"):
        check(len(card[k]) == len(cpu[k]) and all(
            np.array_equal(a, b) for a, b in zip(card[k], cpu[k])),
            f"/{k}_objects differ between the card and the CPU")
    for k in ("stable", "removed_stable", "goals"):
        check(card[k] == cpu[k], f"{k} card {card[k]} != CPU {cpu[k]}")
    cfg = scenario[0]
    for key, clouds in (("stable", card["added"]),
                        ("removed_stable", card["removed"])):
        native = NativeObjectTracker(cfg.tracker)
        for k, pts in enumerate(clouds):
            native.update(pts, 0.2 * (k + 1))
        got = sorted((o.cx, o.cy, o.width, o.height)
                     for o in native.stable_objects)
        want = sorted(s[:4] for s in card[key])
        # the Python tracker clusters in f32, the C++ in f64
        same = len(got) == len(want) and (not want or bool(np.allclose(
            got, want, rtol=0, atol=1e-5)))
        check(same, f"native tracker {got} != Python {want} ({key})")
    sender = NativeGoalSender(cfg.mission)
    sender.on_added_points(card["points"][0])
    sender.on_removed_points(card["points"][1])
    x, y, _ = scenario[3][-1]
    sender.on_odom(x, y)
    goals = []
    for _ in range(200):
        g = sender.control_step()
        if g is None and sender.pending_count() == 0:
            break
        if g is not None:
            goals.append((g.unique_id, g.object_id, g.is_removed))
            sender.on_odom(g.x, g.y)
    check(goals == card["goals"],
          f"native sender order {goals} != Python {card['goals']}")
    log(f"system: card == CPU on {len(card['added'])} ticks (added and "
        f"removed clouds, stable objects, goal order {card['goals']}); the "
        f"native tracker and sender agree")


def phase_nccl(batch, intr, vol_cfg, dev, cloud, gt):
    """Phase 11a: one rank on the card in a NCCL group (the production
    backend): the frame-sharded sparse fusion of the phase-4 capture and
    the sharded chamfer of phase 10's cloud against the GT, the fusion
    timed twice (NCCL starts its communicator in the first call). Returns
    (the volume, the chamfer)."""
    import torch
    import torch.distributed as dist

    from otslam_tpu_torch.distributed import (
        chamfer_data_parallel, fuse_frames_sparse_data_parallel, make_mesh)
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    depths, colors, exts = (torch.as_tensor(x, device=dev) for x in (
        batch.depths, batch.colors, batch.extrinsics))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh((1,), ("data",), "cuda")
            vol0 = make_block_volume(vol_cfg, dev)
            seconds = []      # the first call starts NCCL's communicator
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vol = fuse_frames_sparse_data_parallel(vol0, depths, colors,
                                                       exts, intr, mesh)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            chamfer = float(chamfer_data_parallel(
                cloud, torch.as_tensor(gt, device=dev), mesh))
        finally:
            dist.destroy_process_group()
    log(f"nccl: 1 rank, sparse frame-sharded fusion of {N_FRAMES} VGA "
        f"frames into {vol_cfg.dims}: {seconds[0]:.4f} s with NCCL's "
        f"start, then {seconds[1]:.4f} s; chamfer {chamfer:.6f} m")
    return vol, chamfer


def check_sharded_volume(label, vol, ref):
    """B5's tolerances: weights and created exact, tsdf <= 1e-4, colour
    <= 1e-3, the dead row zero. Returns the max deltas."""
    import torch
    d = {f: float(torch.max(torch.abs(getattr(vol, f) - getattr(ref, f))))
         for f in ("tsdf", "weight", "color")}
    check(d["weight"] == 0.0 and bool(torch.equal(vol.created,
                                                  ref.created)),
          f"{label}: weights or created differ from the serial fusion {d}")
    check(d["tsdf"] <= 1e-4 and d["color"] <= 1e-3,
          f"{label}: tsdf/colour beyond 1e-4/1e-3 of the serial fusion {d}")
    check(not bool(vol.weight[-1].any() or vol.created[-1]),
          f"{label}: dead row not zero")
    return d


def phase_nccl_checks(batch, intr, vol_cfg, dev, vol, chamfer, cloud, gt):
    """After phase 11's count: 11a's volume against the plain schedule
    (fuse_plain) and integrate_frames_cuda of the same frames, its chamfer
    against the serial one with K3 and with its plain version. With one
    rank, the rank's shard is the whole capture into an empty volume,
    uncapped: phase 3's 64-frame shape, where the mips, K2, the pack and
    K1 meet their plain versions."""
    import torch

    from otslam_tpu_torch.kernels.nn import nn_distance
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    from otslam_tpu_torch.kernels.tsdf_cuda import integrate_frames_cuda
    frames = [torch.as_tensor(x, device=dev) for x in (
        batch.depths, batch.colors, batch.extrinsics)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = integrate_frames_cuda(make_block_volume(vol_cfg, dev), *frames,
                                intr)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    d = check_sharded_volume("nccl", vol, ref)
    plain = make_block_volume(vol_cfg, dev)
    fuse_plain(plain, *frames, intr, None)
    dp = check_sharded_volume("nccl against the plain schedule", vol, plain)
    del ref, plain
    gtt = torch.as_tensor(gt, device=dev)
    want = float(torch.mean(nn_distance(cloud, gtt)))
    with plain_nn_min():
        want_plain = float(torch.mean(nn_distance(cloud, gtt)))
    for w in (want, want_plain):
        check(abs(chamfer - w) <= 1e-5 + 1e-5 * abs(w),
              f"nccl chamfer {chamfer} != serial {w} (K3 {want}, plain "
              f"{want_plain})")
    log(f"nccl: == serial within B5's tolerances, max deltas {d}, against "
        f"the plain schedule {dp}; the serial fusion {serial_s:.4f} s; "
        f"chamfer delta {abs(chamfer - want):.3e} (K3), "
        f"{abs(chamfer - want_plain):.3e} (plain)")


def rank_shard_equal(vol_cfg, depths, colors, exts, intr, rank: int,
                     world: int) -> dict:
    """One rank's local step of the frame-sharded fusion, with its kernels
    and with their plain versions: the rank's contiguous shard of frames
    fused into a zero volume whose created mask holds the bands of every
    earlier rank's frames (found by the plain K2), by integrate_frames_cuda
    and by fuse_plain, every field equal; K2 on the shard equal to its
    plain version. Returns the shard's shape."""
    import copy

    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    dev = depths.device
    per = depths.shape[0] // world
    lo, hi = rank * per, (rank + 1) * per
    start = make_block_volume(vol_cfg, dev)
    nb = start.num_blocks
    if lo:
        band, _ = tc.classify_blocks_torch(start.meta, depths[:lo],
                                           exts[:lo], intr)
        start.created[:nb] |= band.any(dim=0)
        del band
    f = slice(lo, hi)
    band, vis = tc.classify_blocks(start.meta, depths[f], exts[f], intr)
    band_p, vis_p = tc.classify_blocks_torch(start.meta, depths[f], exts[f],
                                             intr)
    check(bool(torch.equal(band, band_p)) and bool(torch.equal(vis, vis_p)),
          f"rank {rank}: K2 differs from its plain version on its shard")
    del band, vis, band_p, vis_p
    card = tc.integrate_frames_cuda(copy.deepcopy(start), depths[f],
                                    colors[f], exts[f], intr)
    plain = copy.deepcopy(start)
    most = fuse_plain(plain, depths[f], colors[f], exts[f], intr, None)
    torch.cuda.synchronize()
    diff = {k: int((getattr(card, k) != getattr(plain, k)).sum())
            for k in ("tsdf", "weight", "color", "created")}
    check(not any(diff.values()), f"rank {rank}: the local fusion of its "
          f"shard differs from the plain schedule (entries {diff})")
    return {"frames": (lo, hi), "prefix_blocks": int(start.created.sum()),
            "most_active": most}


def phase11_rank() -> dict:
    """One rank of phase 11b (both ranks on cuda:0, a gloo group): the dry
    run, outside the count (its serial references launch kernels too);
    then the frame-sharded sparse fusion of the full-width capture and the
    sharded extraction of two object volumes, counted; then each against
    its serial result, and the rank's local step against the plain
    schedule (rank_shard_equal). Returns the rank's record."""
    import torch
    torch.cuda.set_device(0)
    sys.path.insert(0, ROOT)
    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.distributed import (
        extract_meshes_sharded, fuse_frames_sparse_data_parallel, make_mesh)
    from otslam_tpu_torch.distributed.dryrun import dryrun_multichip
    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.marching import (
        _validate_batch, extract_mesh_soup_block)
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    from otslam_tpu_torch.pipeline.reconstruct import auto_volume_config

    dev = torch.device("cuda:0")
    mesh = make_mesh(None, ("data",), "cuda")
    batch, intr, _ = render_capture(dev)
    vol_cfg = auto_volume_config(batch, intr, ReconstructionConfig()).tsdf
    depths, colors, exts = (torch.as_tensor(x, device=dev) for x in (
        batch.depths, batch.colors, batch.extrinsics))
    half = N_FRAMES // 2        # the second object: the first half-circle
    other = tc.integrate_frames_cuda(make_block_volume(vol_cfg, dev),
                                     depths[:half], colors[:half],
                                     exts[:half], intr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dry = dryrun_multichip(mesh)
    torch.cuda.synchronize()
    base = launch_counts()
    t1 = time.perf_counter()
    vol = fuse_frames_sparse_data_parallel(
        make_block_volume(vol_cfg, dev), depths, colors, exts, intr, mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verts, cols, masks = extract_meshes_sharded([vol, other], mesh)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = launch_counts(base)
    ref = tc.integrate_frames_cuda(make_block_volume(vol_cfg, dev), depths,
                                   colors, exts, intr)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    deltas = check_sharded_volume("gloo", vol, ref)
    mb, mc = _validate_batch([vol, other])
    for k, v in enumerate((vol, other)):
        rv, rc, rm = extract_mesh_soup_block(v, mb, mc)
        check(bool(torch.equal(masks[k], rm)) and bool(torch.equal(
            verts[k][rm], rv[rm])) and bool(torch.equal(cols[k][rm],
                                                        rc[rm])),
              f"sharded soup {k} != extract_mesh_soup_block")
    rank = torch.distributed.get_rank()
    shard = rank_shard_equal(vol_cfg, depths, colors, exts, intr, rank,
                             torch.distributed.get_world_size())
    return {"rank": rank, "dryrun": dry, "shard": shard,
            "deltas": deltas, "launches": launches,
            "seconds": {"dryrun": t1 - t0, "fuse": t2 - t1,
                        "extract": t3 - t2, "serial_fuse": t4 - t3},
            "triangles": [int(m.sum()) for m in masks],
            "capacities": (mb, mc)}


def phase_gloo():
    """Phase 11b: two ranks on cuda:0 in a gloo group (phase11_rank).
    Returns the ranks' records; a rank that fails or outlives
    RANK_TIMEOUT fails the phase."""
    import torch

    from otslam_tpu_torch.distributed.launch import run_ranks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(phase11_rank, world=2, backend="gloo",
                          timeout=RANK_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        raise SmokeFailure(f"phase 11b: {e}") from e
    for r in ranks:
        log(f"gloo rank {r['rank']}: dry run (the dense paths at its "
            f"64x48, 64^3 shapes) {r['seconds']['dryrun']:.3f} s, deltas "
            f"{r['dryrun']['deltas']}; sparse fusion of {N_FRAMES} VGA "
            f"frames {r['seconds']['fuse']:.4f} s (serial "
            f"{r['seconds']['serial_fuse']:.4f} s), max deltas "
            f"{r['deltas']}; extraction of 2 volumes "
            f"{r['seconds']['extract']:.4f} s at capacities "
            f"{r['capacities']}, {r['triangles']} triangles; launches "
            f"{r['launches']}; its shard {r['shard']} fused locally equal "
            f"to the plain schedule")
    log(f"phase 11b: {time.perf_counter() - t0:.1f} s with the ranks' "
        f"start")
    return ranks


def rank_shapes(batch, intr, vol_cfg, dev, k2s, k1):
    """After phase 11: the mips, K2, the pack and K1 against their plain
    versions at 11b's second rank's shard (frames N/2 .. N-1 into a zero
    volume created on the bands of frames 0 .. N/2 - 1, uncapped), each
    record added to its kernel's `shapes`."""
    import torch

    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    d, c, e = (torch.as_tensor(x, device=dev) for x in (
        batch.depths, batch.colors, batch.extrinsics))
    half = N_FRAMES // 2
    base = make_block_volume(vol_cfg, dev)
    nb = base.num_blocks
    band, _ = tc.classify_blocks_torch(base.meta, d[:half], e[:half], intr)
    base.created[:nb] = band.any(dim=0)
    f = slice(half, N_FRAMES)
    label = (f"gloo rank 1 shard (frames {half}-{N_FRAMES - 1}, creation "
             f"prefix of frames 0-{half - 1})")
    schedule_shapes(label, base, d[f], c[f], e[f], intr, None, k2s, k1,
                    reps=10)


def phase_bench():
    """Phase 12: bench.main("cuda") in this process at full width, its
    lines kept. Returns its last line, parsed, after the checks of the
    module docstring."""
    import io
    import math

    from otslam_tpu_torch import bench
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = bench.main("cuda")
    lines = out.getvalue().splitlines()
    check(code == 0 and bool(lines), f"bench.main returned {code}: "
          f"{lines[-1] if lines else 'no output'}")
    rec = json.loads(lines[-1])
    log(f"bench record: {lines[-1]}")
    check(rec.get("status") == "complete", f"bench status "
          f"{rec.get('status')!r}")
    missing = [k for keys in bench._METRIC_KEYS.values() for k in keys
               if k not in rec]
    check(not missing, f"the bench record lacks {missing}")
    ok, why = bench.record_plausible(rec)
    check(ok and 0 < rec["vs_baseline"] < math.inf,
          f"the bench record fails its gate: {why}")
    fc = rec["fusion_config"]
    check(fc["n_frames"] == BENCH_FRAMES and fc["frame"] == [640, 480]
          and fc["dims"] == [256, 256, 256] and fc["max_active"] is None,
          f"the bench fused another workload: {fc}")
    check(f"{BENCH_POINTS}x{BENCH_POINTS}" in rec["icp_unit"]
          and f"K={BENCH_TICKS}" in rec["perception_unit"],
          f"the bench ran another width: {rec['icp_unit']}, "
          f"{rec['perception_unit']}")
    log(f"phase 12: bench.main {time.perf_counter() - t0:.1f} s, "
        f"{len(lines)} lines; fused {rec['value']} frames/s, ICP "
        f"{rec['icp_iterations_per_sec']} iterations/s, perception "
        f"{rec['perception_ticks_per_sec']} ticks/s, mesh "
        f"{rec['mesh_extracts_per_sec']} / "
        f"{rec['mesh_block_extracts_per_sec']} / "
        f"{rec['mesh_batch_extracts_per_sec']} extractions/s "
        f"(dense / block / batched)")
    return rec


def bench_shapes(dev, k2s, k1, k3, k4, k5):
    """After phase 12's count: each kernel against its plain version at
    the bench's shapes, each record added to its kernel's `shapes`: the
    mips, K2, the pack and K1 on the fusion metric's call (the 384 cube
    frames into an empty 256^3 volume, its whole work list), K3 and K4 on
    the first ICP iteration's operands at 50k x 50k (the full scan's
    call as ICP makes it; the windowed scan on the clouds as ICP sorts
    them), K5 on the perception workload's 64 poses x 1440 beams."""
    import torch

    from otslam_tpu_torch import bench
    from otslam_tpu_torch.config import LidarConfig, TSDFConfig
    from otslam_tpu_torch.kernels import nn
    from otslam_tpu_torch.kernels.icp import _setup
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    from otslam_tpu_torch.mapping.virtual_scan import VirtualScanner
    t0 = time.perf_counter()
    intr = bench.VGA
    d, c, e = bench._make_frames(intr, BENCH_FRAMES, dev)
    pairs, _ = schedule_shapes(
        f"bench cube {BENCH_FRAMES} frames", make_block_volume(
            TSDFConfig(), dev), d, c, e, intr, None, k2s, k1)
    del d, c, e
    src_np, dst_np = bench._icp_clouds(BENCH_POINTS)
    window, axis = nn.auto_nn_window(src_np, dst_np, bench.ICP_THRESHOLD)
    check(window * nn.DST_CHUNK < BENCH_POINTS, f"the bench's ICP window "
          f"{window} covers the cloud: ICP would take K3")
    src = torch.as_tensor(src_np, device=dev)
    dst = torch.as_tensor(dst_np, device=dev)
    kept: list = []
    with k3_calls(every_call(kept)):
        bench.run_icp(src, dst, 0)
    check(len(kept) == 1, f"ICP's first iteration made {len(kept)} K3 "
          "calls")
    k3["shapes"].append(k3_shape(
        f"bench ICP {BENCH_POINTS} x {BENCH_POINTS} full scan", *kept[0],
        dev))
    # the windowed run's first correspondence search, as ICP makes it
    s, t, _, _, T0, _ = _setup(src, dst, None, None, None, window, axis)
    p = s @ T0[:3, :3].T + T0[:3, 3]
    ones = torch.ones(BENCH_POINTS, dtype=torch.bool, device=dev)
    k4["shapes"].append(k4_shape(
        nn, f"bench ICP {BENCH_POINTS} x {BENCH_POINTS} windowed", p, t,
        ones, bench.ICP_THRESHOLD, axis, dev))
    args = bench.perception_inputs(BENCH_TICKS, dev)
    vs = VirtualScanner(LidarConfig(), device=dev)
    vs.set_map(bench.perception_scene().occupancy_grid(0.05))
    check(bool(torch.equal(vs.grid, args[0]))
          and bool(torch.equal(vs.angles(), args[9])),
          "the scanner's map or beams differ from the bench's")
    k5["shapes"].append(k5_shape("bench perception room", vs,
                                 args[7].cpu().numpy(), dev))
    log(f"phase 12 shapes: {time.perf_counter() - t0:.1f} s; fusion "
        f"{pairs} (block, frame) pairs, every frame; ICP window {window} "
        f"chunks on axis {axis}; the mips, K2, the pack, K1, K3, K4 and K5 "
        "bit-identical to their plain versions at the bench's shapes")


def production_mission(dev, workdir: str, argv=PRODUCTION_MISSION):
    """Phase 13's mission: cli.mission_runner on the parsed arguments of
    `argv`, run once. Returns (args, runner, summary, seconds, believed
    poses of the perception batch of the full size with the most distinct
    poses)."""
    import numpy as np
    import torch

    from otslam_tpu_torch import cli
    args = cli.build_parser().parse_args(
        [*argv, "--workdir", workdir, "--device", str(dev)])
    runner = cli.mission_runner(args, workdir, dev)
    kept = []
    run_batch = runner._run_tick_batch

    def keep(reals, believed, times, true_poses=None):
        if len(times) == args.perception_batch:
            distinct = len(np.unique(np.asarray(believed), axis=0))
            if not kept or distinct > kept[0]:
                kept[:] = [distinct, np.array(believed, np.float32)]
        return run_batch(reals, believed, times, true_poses)

    runner._run_tick_batch = keep
    t0 = time.perf_counter()
    summary = runner.run(max_ticks=args.max_ticks)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del runner._run_tick_batch
    check(bool(kept), f"no perception batch of {args.perception_batch} "
          "ticks")
    log(f"  mission batch kept for K5: {args.perception_batch} poses, "
        f"{kept[0]} distinct")
    return args, runner, summary, seconds, kept[1]


def capture_orbits(dataset: str, labels) -> dict:
    """Each label's (centre, mean radius) of its believed capture
    positions on disk, as tests/test_full_mission.py measures them."""
    import glob

    import numpy as np
    orbits = {}
    for label in labels:
        ps = [np.loadtxt(f) for f in sorted(glob.glob(
            os.path.join(dataset, "poses", f"{label}_*.txt")))]
        c = np.mean([p[:2, 3] for p in ps], axis=0)
        orbits[label] = (c, float(np.mean([np.linalg.norm(p[:2, 3] - c)
                                           for p in ps])))
    return orbits


def phase_production(dev, workdir: str, mission_argv=PRODUCTION_MISSION,
                     room_frames: int = PRODUCTION_ROOM_FRAMES):
    """Phase 13 (the module docstring): MISSION_r04's three commands
    through the port's CLI code, each result logged, then the gates.
    Returns what production_shapes checks after the phase: the runner and
    its args, the largest auto-sized object volume (label, config), the
    operands of the headline's largest K3 calls and the mission's kept
    perception batch."""
    import io

    import numpy as np
    import torch

    from otslam_tpu_torch import cli
    from otslam_tpu_torch.config import OTSLAMConfig
    from otslam_tpu_torch.core import io as tio
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.pipeline.dataset import CaptureDataset
    from otslam_tpu_torch.pipeline.reconstruct import auto_volume_config

    stages = {}
    args, runner, summary, stages["mission"], batch_poses = \
        production_mission(dev, os.path.join(workdir, "mission"),
                           mission_argv)
    ticks = len(runner.trace)
    ex, ey, _ = runner.pose_estimate
    pose_err = float(np.hypot(ex - runner.x, ey - runner.y))
    visited = sorted(runner.sender.visited_removed_ids)
    log(f"production mission: {ticks} ticks in {stages['mission']:.2f} s "
        f"({ticks / stages['mission']:.2f} ticks/s), "
        f"{summary.missions_completed} missions, {summary.frames_captured} "
        f"frames, labels {summary.labels}, stable objects "
        f"{summary.stable_objects}, removed checks visited {visited}, sim "
        f"time {summary.sim_time:.1f} s; final pose estimate error "
        f"{pose_err:.4f} m (the trace holds no estimate, so no largest "
        "error over it)")

    dataset = os.path.join(workdir, "mission", "dataset")
    objdir = os.path.join(dataset, "3d_reconst")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["reconstruct", "--dataset", dataset, "--auto-origin",
                  "--device", str(dev)])
    torch.cuda.synchronize()
    stages["reconstruct"] = time.perf_counter() - t0
    cfg = OTSLAMConfig()
    intr = PinholeIntrinsics.from_config(cfg.camera)
    ds = CaptureDataset(dataset, cfg.camera)
    clouds, volumes = {}, {}
    for line in buf.getvalue().splitlines():
        name = line.split(":")[0]
        pts = tio.read_ply(os.path.join(objdir, f"{name}.ply"))["points"]
        batch = ds.load_object(name)
        tsdf = auto_volume_config(batch, intr, cfg.reconstruction).tsdf
        clouds[name] = pts
        volumes[name] = (int(np.prod(tsdf.dims)), len(batch.depths), tsdf)
        log(f"  reconstruct {line.strip()}; auto-sized volume dims "
            f"{tsdf.dims}")
    # the largest volume; among equal ones, the most frames
    largest = max(volumes, key=lambda n: volumes[n][:2])

    crops: dict = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with k3_calls(largest_pairs(crops, dev)), \
            contextlib.redirect_stdout(buf):
        cli.main(["headline", "--workdir", os.path.join(workdir, "headline"),
                  "--scenario", "full", "--objects-dir", objdir,
                  "--room-frames", str(room_frames), "--device", str(dev)])
    torch.cuda.synchronize()
    stages["headline"] = time.perf_counter() - t0
    rep = json.loads(buf.getvalue())
    log("production headline: " + json.dumps(
        {k: v for k, v in rep.items() if k != "objects"}))
    for name, entry in rep["objects"].items():
        log(f"  headline {name}: {json.dumps(entry)}")
    log("production stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()))
    production_gates(runner, summary, dataset, pose_err, clouds, rep)
    return (args, runner, (largest, volumes[largest][2]), crops,
            batch_poses)


def production_gates(runner, summary, dataset, pose_err, clouds, rep):
    """Phase 13's gates: tests/test_full_mission.py's checks and the
    report's own."""
    import numpy as np
    check(summary.missions_completed >= 4 and len(summary.labels) >= 3
          and summary.frames_captured >= len(summary.labels),
          f"production mission: {summary.missions_completed} missions, "
          f"labels {summary.labels}, {summary.frames_captured} frames")
    group = max(runner.tracker.stable_objects, key=lambda s: len(s.members))
    check(len(group.members) >= 4, f"the largest stable group has "
          f"{len(group.members)} members")
    orbits = capture_orbits(dataset, summary.labels)

    def near(target, r_max):
        return any(np.linalg.norm(c - np.asarray(target)) < 0.7
                   and r < r_max for c, r in orbits.values())
    check(any(near(ch, 1.8) for ch in CHAIR_SITES),
          f"no label orbits a chair: {orbits}")
    check(near(TABLE_SITE, 2.3), f"no label orbits the table: {orbits}")
    check(len(runner.sender.visited_removed_ids) >= 1,
          "no removed check was visited")
    check(any(np.hypot(s.cx - REMOVED_SITE[0], s.cy - REMOVED_SITE[1]) < 1.0
              for s in runner.removed_tracker.stable_objects),
          "no removed stable object near the phantom box")
    check(pose_err < POSE_TOLERANCE, f"final pose estimate {pose_err:.4f} m "
          f"off the true pose")
    for name, pts in clouds.items():
        if name.startswith("Removed_"):
            log(f"  {name}: {len(pts)} points (its site is empty)")
            continue
        check(len(pts) > 0 and bool(np.isfinite(pts).all()),
              f"{name}: empty or non-finite cloud")
    check(any(n.startswith("Object_") for n in clouds),
          f"no Object_* cloud among {sorted(clouds)}")
    objs = rep["objects"]
    check(len(objs) == FULL_ROOM_OBJECTS, f"the headline holds "
          f"{len(objs)} objects: {sorted(objs)}")
    unassociated = [n for n, e in objs.items()
                    if e.get("scanned", True) and "cloud" not in e]
    check(not unassociated, f"scanned objects without a cloud: "
          f"{unassociated}")
    check(rep["size_reduction_percent"] >= 90.0,
          f"size reduction {rep['size_reduction_percent']} % < 90 %")


def production_shapes(dev, args, runner, largest, crops, batch_poses, k2s,
                      k1, k3, k5):
    """After phase 13's count: each kernel against its plain version at the
    phase's shapes, each record added to its kernel's `shapes`: the mips,
    K2, the pack and K1 on the capture batch of the largest auto-sized
    object volume (ties: the most frames) into that volume; K3 on the first K3 call of the
    mission's first localization (its start pose, odometry exact, on the
    saved map) and at the headline's largest calls; K5 on the mission's
    kept 64-pose batch on its saved map."""
    import numpy as np
    import torch

    from otslam_tpu_torch.config import OTSLAMConfig
    from otslam_tpu_torch.core.camera import PinholeIntrinsics
    from otslam_tpu_torch.mapping.localize import ScanLocalizer
    from otslam_tpu_torch.pipeline.dataset import CaptureDataset
    from otslam_tpu_torch.sim.sensors import render_lidar
    t0 = time.perf_counter()
    cfg = OTSLAMConfig()
    intr = PinholeIntrinsics.from_config(cfg.camera)
    label, tsdf = largest
    batch = CaptureDataset(os.path.join(runner.workdir, "dataset"),
                           cfg.camera).load_object(label)
    d, c, e = (torch.as_tensor(np.asarray(x, np.float32), device=dev)
               for x in (batch.depths, batch.colors, batch.extrinsics))
    fusion_shapes(f"production {label} {len(d)} frames into {tsdf.dims}",
                  tsdf, d, c, e, intr, None, k2s, k1)
    del d, c, e, batch
    start = tuple(float(v) for v in args.start.split(","))
    angles = runner.vscanner.angles()
    scan = render_lidar(runner.scene_world, *start, angles,
                        runner.cfg.lidar.range_min,
                        runner.cfg.lidar.range_max, device=dev)
    loc = ScanLocalizer(runner.vscanner._map, device=dev)
    seen: list = []
    with k3_calls(every_call(seen)):
        loc.localize(scan, angles, start)
    check(bool(seen), "the localizer made no K3 call")
    src, dst, mask = seen[0]
    k3["shapes"].append(k3_shape(
        f"production localizer {src.shape[0]} x {dst.shape[0]}", src, dst,
        mask, dev))
    for key, (_, src, dst, mask) in sorted(crops.items()):
        k3["shapes"].append(k3_shape(
            f"production headline {src.shape[0]} x {dst.shape[0]} ({key})",
            src, dst, mask, dev))
    k5["shapes"].append(k5_shape("full_room mission batch", runner.vscanner,
                                 batch_poses, dev))
    log(f"phase 13 shapes: {time.perf_counter() - t0:.1f} s; the mips, K2, "
        "the pack, K1, K3 and K5 bit-identical to their plain versions at "
        "the production path's shapes")


def main() -> int:
    """Exit code 0 when every phase passed, 1 when a check failed
    (SmokeFailure, its message on stderr), 2 when the run cannot start
    here: no CUDA GPU, or no otslam_tpu_torch package beside the script.
    Only a passed run prints results."""
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a CUDA GPU", file=sys.stderr)
        return 2
    try:
        import otslam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the otslam_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    try:
        return smoke()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


def smoke() -> int:
    """Phases 1-13 and 4b (the module docstring); raises SmokeFailure."""
    import torch

    from otslam_tpu_torch.config import ReconstructionConfig
    from otslam_tpu_torch.eval.scenarios import scenario_gt
    from otslam_tpu_torch.kernels import _build, nn, raycast
    from otslam_tpu_torch.kernels import tsdf_cuda as tc
    from otslam_tpu_torch.kernels.tsdf_block import make_block_volume
    from otslam_tpu_torch.pipeline.reconstruct import auto_volume_config

    dev = torch.device("cuda:0")
    # --- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no reading"
    log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
        f" cuda {torch.version.cuda} | {card}")

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s, nvcc "
        f"{' '.join(_build.NVCC_FLAGS)} -> {_build.BUILD_LOG['path']}")
    for line in _build.BUILD_LOG["output"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # --- 3. kernels against their plain versions --------------------------
    t0 = time.perf_counter()
    batch, intr, _ = render_capture(dev)
    log(f"render: {N_FRAMES} frames {intr.width}x{intr.height} in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = ReconstructionConfig()
    vol_cfg = auto_volume_config(batch, intr, cfg).tsdf
    meta = make_block_volume(vol_cfg, dev).meta
    log(f"volume: dims {vol_cfg.dims} voxel {vol_cfg.voxel_size} origin "
        f"{tuple(round(o, 4) for o in vol_cfg.origin)}")
    depths = torch.as_tensor(batch.depths, device=dev)
    colors = torch.as_tensor(batch.colors, device=dev)
    exts = torch.as_tensor(batch.extrinsics, device=dev)
    band, vis, k2s = phase_k2(meta, depths, colors, exts, intr)
    torch.cuda.synchronize()
    k1 = phase_k1(vol_cfg, band, vis, depths, colors, exts, intr)
    torch.cuda.synchronize()
    k3 = phase_k3(dev)
    torch.cuda.synchronize()
    k4 = phase_k4(dev, batch, intr)
    torch.cuda.synchronize()
    del depths, colors, exts, band, vis

    # --- 4. main path -----------------------------------------------------
    gt = scenario_gt("cardboard", GT_POINTS)
    # the fusion schedule's four launches: every path fuses frames
    fusion = ("depth_mips", "classify_blocks", "pack_rgb", "fuse_blocks")
    base = launch_counts()
    phase_reconstruct(batch, intr, cfg, dev, gt)
    launches = launch_counts(base)
    log(f"main path launches {launches}")
    check(all(launches[k] > 0 for k in fusion + ("nn_min",)),
          f"a kernel of the path never launched: {launches}")

    # --- 4b. mesh path ----------------------------------------------------
    base = launch_counts()
    phase_mesh_path(batch, intr, cfg, dev, gt)
    torch.cuda.synchronize()
    mesh_launches = launch_counts(base)
    log(f"mesh path launches {mesh_launches}")
    check(all(mesh_launches[k] > 0 for k in fusion + ("nn_min",)),
          f"a kernel of the mesh path never launched: {mesh_launches}")
    phase_mesh_checks(batch, intr, cfg, vol_cfg, dev, card)
    torch.cuda.synchronize()

    # --- 6. registration path ---------------------------------------------
    base = launch_counts()
    phase_registration(batch, intr, cfg, dev, gt)
    torch.cuda.synchronize()
    reg_launches = launch_counts(base)
    log(f"registration path launches {reg_launches}")
    check(all(reg_launches[k] > 0 for k in fusion + (
        "nn_min", "nn_min_windowed", "icp_prep", "icp_terms")),
          f"a kernel of the registration path never launched: "
          f"{reg_launches}")

    # --- 7. K5 against its plain version ----------------------------------
    k5 = phase_k5(dev)
    torch.cuda.synchronize()

    # --- 8. mission path ---------------------------------------------------
    base = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        phase_mission(dev, os.path.join(tmp, "mission"))
    torch.cuda.synchronize()
    mis_launches = launch_counts(base)
    log(f"mission path launches {mis_launches}")
    check(all(mis_launches[k] > 0 for k in fusion + ("nn_min", "ray_keys")),
          f"a kernel of the mission path never launched: {mis_launches}")

    # --- 9. map-building and headline path ---------------------------------
    base = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        phase9 = phase_map_building(dev, tmp)
    torch.cuda.synchronize()
    hl_launches = launch_counts(base)
    log(f"map-building and headline path launches {hl_launches}")
    check(all(hl_launches[k] > 0 for k in fusion + ("nn_min", "ray_keys")),
          f"a kernel of the map-building and headline path never launched: "
          f"{hl_launches}")
    phase9_shapes(dev, *phase9, k2s, k1, k3, k5)
    del phase9

    # --- 10. online path ---------------------------------------------------
    base = launch_counts()
    online_vol, cloud, pushed, k3_ops = phase_online(batch, intr, vol_cfg,
                                                     dev, gt)
    scenario, card_record = phase_system(dev)
    torch.cuda.synchronize()
    on_launches = launch_counts(base)
    log(f"online path launches {on_launches}")
    check(all(on_launches[k] > 0 for k in fusion + ("nn_min", "ray_keys")),
          f"a kernel of the online path never launched: {on_launches}")
    phase_online_checks(online_vol, batch, pushed, intr, vol_cfg, dev,
                        k3_ops, k2s, k1, k3)
    phase_system_checks(scenario, card_record)
    del online_vol, scenario, card_record, k3_ops

    # --- 11. distributed path ----------------------------------------------
    base = launch_counts()
    nccl_vol, chamfer = phase_nccl(batch, intr, vol_cfg, dev, cloud, gt)
    torch.cuda.synchronize()
    dist_launches = launch_counts(base)
    phase_nccl_checks(batch, intr, vol_cfg, dev, nccl_vol, chamfer, cloud,
                      gt)
    del nccl_vol
    for r in phase_gloo():
        for k, n in r["launches"].items():
            dist_launches[k] += n
    log(f"distributed path launches {dist_launches}")
    check(all(dist_launches[k] > 0 for k in fusion + ("nn_min",)),
          f"a kernel of the distributed path never launched: "
          f"{dist_launches}")
    rank_shapes(batch, intr, vol_cfg, dev, k2s, k1)

    # --- 12. bench path ---------------------------------------------------
    base = launch_counts()
    phase_bench()
    torch.cuda.synchronize()
    bench_launches = launch_counts(base)
    log(f"bench path launches {bench_launches}")
    check(all(bench_launches[k] > 0
              for k in fusion + ("nn_min", "nn_min_windowed", "ray_keys")),
          f"a kernel of the bench path never launched: {bench_launches}")
    bench_shapes(dev, k2s, k1, k3, k4, k5)

    # --- 13. production path ---------------------------------------------
    base = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        production = phase_production(dev, tmp)
        torch.cuda.synchronize()
        prod_launches = launch_counts(base)
        log(f"production path launches {prod_launches}")
        check(all(prod_launches[k] > 0
                  for k in fusion + ("nn_min", "ray_keys")),
              f"a kernel of the production path never launched: "
              f"{prod_launches}")
        production_shapes(dev, *production, k2s, k1, k3, k5)
    del production
    check("jax" not in sys.modules and "bench" not in sys.modules
          and "bench_icp" not in sys.modules,
          "jax or the JAX package's benchmark was imported")

    def counts(name):
        by_path = {"reconstruct": launches[name],
                   "mesh": mesh_launches[name],
                   "registration": reg_launches[name],
                   "mission": mis_launches[name],
                   "headline": hl_launches[name],
                   "online": on_launches[name],
                   "distributed": dist_launches[name],
                   "bench": bench_launches[name],
                   "production": prod_launches[name]}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    kernels = [
        {"name": "K1 block TSDF fusion", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/tsdf_fuse.cu",
         "replaces": "otslam_tpu/kernels/tsdf_pallas.py:92",
         **counts("fuse_blocks"), **k1},
        {"name": "K2 depth-mip pass", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/depth_mips.cu",
         "replaces": "otslam_tpu/kernels/tsdf_block.py:129",
         **counts("depth_mips"), **k2s["mips"]},
        {"name": "K2 block classification", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/tsdf_classify.cu",
         "replaces": "otslam_tpu/kernels/tsdf_pallas.py:378",
         **counts("classify_blocks"), **k2s["k2"]},
        {"name": "colour pack before K1", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/pack_rgb.cu",
         "replaces": "otslam_tpu_torch/kernels/tsdf_block.py:324",
         **counts("pack_rgb"), **k2s["pack"]},
        {"name": "K3 nearest neighbour", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/nn.cu",
         "replaces": "otslam_tpu/kernels/nn.py:49",
         **counts("nn_min"), **k3},
        {"name": "K4 windowed nearest neighbour", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/nn.cu",
         "replaces": "otslam_tpu/kernels/nn.py:200",
         **counts("nn_min_windowed"), **k4},
        {"name": "K5 ray cast", "route": "cuda",
         "source": "otslam_tpu_torch/csrc/raycast.cu",
         "replaces": "otslam_tpu/kernels/raycast.py:113",
         **counts("ray_keys"), **k5},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
