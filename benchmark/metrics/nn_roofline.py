"""nn_roofline: the nearest-neighbour kernels' (csrc/nn.cu: K3's
nn_kernel, K4's nn_window_kernel and their split merge nn_merge_kernel)
least time over their device time in the trace, in %.

The work is the (source, destination) rows the scans covered over the
traced stretch, from the program's counters (kernels/nn.py): `nn.pairs`,
n x m for each full scan (K3), and `nn.window_pairs`, the sum over each
windowed scan's tiles of (c1 - c0) x 1024 x 256 (K4). Both count the rows
the kernels scan, not the pairs that matter: a masked destination is
staged as +inf and scanned like any other, and a tile's source rows past
the cloud's end are scanned as zeros. Off csrc/nn.cu, a pair costs 8 f32
operations (3 differences, 3 squares, 2 sums; the running minimum's
compare and select are not floating-point work) and 13/256 bytes: each
256-row source tile reads a destination row's 12 bytes of coordinates and
its mask byte once. The sources, results and merge keys, O(n) bytes
against O(n m) pairs, are left out. The least time is the larger of the
operations at the f32 peak and the bytes at the HBM peak (the operations,
at 8 against 0.05).

Read only from a stretch whose K3 launches equal the program's
`launches.otslam_nn` and whose K4 launches equal both its
`launches.otslam_nn_window` and `nn.window_scans`, the windowed scans
whose rows were counted (the program counts them only where a caller
tallies them, as the refiner does); never otherwise.
"""

from benchmark import peaks
from benchmark.trace import kernel

FULL, WINDOW = "nn_kernel", "nn_window_kernel"
MERGE = "nn_merge_kernel"
OPS_PER_PAIR = 8
BYTES_PER_PAIR = 13 / 256


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("trace_sound"):
        return None
    nn = tr.get("nn") or {}
    full, window = kernel(tr, FULL)[0], kernel(tr, WINDOW)[0]
    if (full + window == 0 or full != nn.get("launches.otslam_nn")
            or window != nn.get("launches.otslam_nn_window")
            or window != nn.get("nn.window_scans")):
        return None
    pairs = nn.get("nn.pairs", 0) + nn.get("nn.window_pairs", 0)
    sec = sum(kernel(tr, k)[1] for k in (FULL, WINDOW, MERGE))
    if pairs <= 0 or sec <= 0:
        return None
    need = max(OPS_PER_PAIR * pairs / peaks.F32_FLOPS,
               BYTES_PER_PAIR * pairs / peaks.HBM_BYTES_PER_S)
    return 100.0 * need / sec
