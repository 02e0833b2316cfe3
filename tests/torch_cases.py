"""Depth and colour inputs for the mip pass and the colour pack, made from a
seed with numpy. Shared by the CPU parity tests and the card tests
(tests/test_torch_cuda.py), so this module imports neither jax nor
otslam_tpu."""

import numpy as np

# frame sizes that are and are not multiples of the 16-pixel tile, of 4
# pixels (a float4 row) and of the 2x / 4x coarser levels; a frame without
# depth; and a 64 x 80 frame holding inf, -inf, negative and NaN pixels
# around a 48 x 48 patch of inf (3 x 3 tiles of inf: the middle one's
# dilation sees inf on every side and no pad); (H, W) of each
MIP_SIZES = {"120x160": (120, 160), "100x150": (100, 150),
             "37x53": (37, 53), "16x16": (16, 16), "zeros": (120, 160),
             "special": (64, 80)}
MIP_CASES = tuple(MIP_SIZES)


def mip_depth(case: str, n: int = 1, seed: int = 0) -> np.ndarray:
    """(n, H, W) f32 depth in metres for a MIP_CASES entry: uniform in
    [0.3, 5] m with 15 % of the pixels zero (no depth)."""
    rng = np.random.default_rng(seed)
    h, w = MIP_SIZES[case]
    d = rng.uniform(0.3, 5.0, (n, h, w)).astype(np.float32)
    d[rng.random((n, h, w)) < 0.15] = 0.0
    if case == "zeros":
        d[:] = 0.0
    if case == "special":
        d[:, :48, :48] = np.inf
        for value in (np.inf, -np.inf, -0.5, np.nan):
            d[rng.random((n, h, w)) < 0.05] = value
    return d


def colours(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(n, h, w, 3) f32 colour: in-range values with fractions, and values
    below 0 and above 255 (clamped by the pack), among them +-inf."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-40.0, 300.0, (n, h, w, 3)).astype(np.float32)
    c.reshape(-1)[::97] = np.inf
    c.reshape(-1)[::89] = -np.inf
    return c
