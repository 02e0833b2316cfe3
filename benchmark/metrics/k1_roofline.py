"""k1_roofline: K1's (csrc/tsdf_fuse.cu) least time at the HBM
peak over its device time in the trace, in %.

Bytes of one launch, each input byte read once and each output byte
written once: the listed blocks' tsdf, weight and colour rows read and
written (2 x (512 + 512 + 1536) x 4 B a block), the batch's depth and
packed colour planes (8 B a pixel a frame), the extrinsics (48 B a frame)
and the work list (ids, ptr and frames, 4 B each). K1 does no float work
that could bound it before its bytes do. Read only from a trace stretch
whose K1 launches equal the calls the harness counted; never otherwise.
"""

from benchmark import peaks
from benchmark.trace import kernel

K1 = "fuse_kernel"
ROW_BYTES = (512 + 512 + 1536) * 4


def k1_bytes(n_ids: int, nnz: int, n_frames: int, H: int, W: int) -> int:
    return (2 * ROW_BYTES * n_ids + 8 * H * W * n_frames + 48 * n_frames
            + 4 * (n_ids + n_ids + 1 + nnz))


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("trace_sound") or not tr.get("k1_calls"):
        return None
    n, sec = kernel(tr, K1)
    if n != len(tr["k1_calls"]) or sec <= 0:
        return None
    need = sum(k1_bytes(*c) for c in tr["k1_calls"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * need / sec
